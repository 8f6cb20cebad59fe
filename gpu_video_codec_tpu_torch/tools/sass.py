"""Static counts of the kernels nvcc compiled: per entry, ptxas's registers,
spills and shared memory (from its -v output, which ops/cuda_kernel._build
returns) and cuobjdump's SASS instructions and opcodes.

    ptxas_entries(log)        {mangled entry: {"registers", "spill_stores",
                               "spill_loads", "smem"}}
    sass_entries(listing)     {mangled entry: (instructions, Counter of opcodes)}
    static_sass(library, nvcc) sass_entries of `cuobjdump -sass library`

A static count is what the compiler emitted, not what a launch executes:
it bounds no run time (a loop body counts once, a branch not taken counts
in full).  Used by chip_smoke.py phase 0 and swar_exp --ops.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
from collections import Counter

_INSTRUCTION = re.compile(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def ptxas_entries(log: str) -> dict[str, dict]:
    """Registers, spill bytes and static shared memory of each entry function
    in `nvcc -Xptxas -v` output, in the order ptxas compiled them.  A spill
    line belongs to the entry compiled last (ptxas prints the properties of
    the functions it inlined there too)."""
    entries: dict[str, dict] = {}
    entry = None
    for line in log.splitlines():
        if m := re.search(r"entry function '([^']+)'", line):
            entry = entries.setdefault(m.group(1), {"smem": 0})
        elif entry is not None and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            entry["spill_stores"], entry["spill_loads"] = int(m.group(1)), int(m.group(2))
        elif entry is not None and (m := re.search(r"Used (\d+) registers", line)):
            entry["registers"] = int(m.group(1))
            if m := re.search(r"(\d+) bytes smem", line):
                entry["smem"] = int(m.group(1))
    return entries


def sass_entries(listing: str) -> dict[str, tuple[int, Counter]]:
    """Instruction count and opcode counts of each `Function :` of a
    `cuobjdump -sass` listing, in listing order.  An instruction is a line
    that opens with its /*address*/ and holds a `;`; its opcode is the first
    word after the address and an optional predicate (@P0, @!PT, @UP0)."""
    entries: dict[str, tuple[int, Counter]] = {}
    name, count, ops = None, 0, Counter()
    for line in listing.splitlines() + ["Function : <end>"]:
        if "Function : " in line:
            if name is not None:
                entries[name] = (count, ops)
            name, count, ops = line.split("Function : ")[1].strip(), 0, Counter()
        elif name is not None and line.lstrip().startswith("/*") and ";" in line:
            count += 1
            if m := _INSTRUCTION.match(line):
                ops[m.group(1)] += 1
    return entries


def cuobjdump(nvcc: str) -> str:
    """The cuobjdump beside `nvcc`; raises FileNotFoundError without one."""
    path = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"cuobjdump not found beside {nvcc}")
    return path


def static_sass(library, nvcc: str) -> dict[str, tuple[int, Counter]]:
    """sass_entries of a built library, read by the cuobjdump beside `nvcc`."""
    listing = subprocess.run([cuobjdump(nvcc), "-sass", str(library)], capture_output=True,
                             text=True, check=True).stdout
    return sass_entries(listing)


def demangle(name: str) -> str:
    """`name` through c++filt, or as it is where there is none."""
    cxxfilt = shutil.which("c++filt")
    if cxxfilt is None:
        return name
    return subprocess.run([cxxfilt, name], capture_output=True, text=True).stdout.strip()
