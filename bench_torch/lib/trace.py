"""Reading torch.profiler's Chrome trace: device time by op, busy and idle.

device_op_stats and per_iter_us are copies of the program's
utils/tracing.py (its revision that restores launches), kept here so
that the yardstick does not move with the program; device_leaves
departs from its leaf rule (see there).  The rest is the benchmark's own:
the busy intervals of each card, the idle share of a window, and the
longest idle gaps named by the harness span that was open on the host.

Device lanes are the pids whose process_labels (or process_name) say
"GPU <n>"; torch.profiler gives every lane the program's process_name.
Host calls and device events share one clock (microseconds); the
harness's own spans, stamped with time.perf_counter, are moved onto it by
marks (lib/feeds.Tracer).
"""

from __future__ import annotations

import gzip
import json
import re
from collections import defaultdict

_GPU = re.compile(r"GPU\s*(\d+)")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load_events(path: str) -> list[dict]:
    """Every event of one Chrome trace file (.json or .json.gz)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data.get("traceEvents", []) if isinstance(data, dict) else data


def device_pids(events: list[dict]) -> dict:
    """{pid: card index} of the device lanes."""
    out = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") in ("process_name", "process_labels"):
            args = e.get("args", {})
            m = _GPU.search(str(args.get("name", args.get("labels", ""))))
            if m:
                out[e.get("pid")] = int(m.group(1))
    return out


def device_leaves(events: list[dict]) -> dict:
    """{card: [(ts, dur, name, correlation), ...]} of the device lanes'
    kernels, memcpys and memsets.  correlation ties an event to the host
    call that launched it (None where absent).

    The program's utils/tracing.py keeps only the LEAVES of each track and
    drops any event that another overlaps from its start: on an H100 the
    kernels of one CUDA graph replay overlap their successor by up to
    about 0.8 us in the trace, so that rule dropped more than half of them
    (3,431 of 6,000 in a 1,000-batch window).  Here every event of these
    activity kinds counts, and overlaps are resolved by busy_intervals."""
    pids = device_pids(events)
    out: dict[int, list] = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("pid") in pids and e.get("cat") in DEVICE_CATS:
            out[pids[e["pid"]]].append((float(e["ts"]), float(e.get("dur", 0.0)),
                                        str(e.get("name", "?")),
                                        e.get("args", {}).get("correlation")))
    for leaves in out.values():
        leaves.sort(key=lambda e: e[0])
    return dict(out)


def device_op_stats(leaves: list) -> dict[str, tuple[float, int]]:
    """(summed duration in us, event count) by op name."""
    totals: dict[str, float] = defaultdict(float)
    launches: dict[str, int] = defaultdict(int)
    for _, dur, name, _ in leaves:
        totals[name] += dur
        launches[name] += 1
    return {name: (us, launches[name]) for name, us in totals.items()}


def per_iter_us(total_us: float, launches: int, iters: int) -> float:
    """One op's device time per iteration of a window of `iters`
    iterations in which it was recorded `launches` times: its mean launch
    times the launches per iteration that the count rounds to (the
    profiler can miss launches at the start of a window); an op recorded
    in fewer than half the iterations is averaged over all."""
    k = int(launches / iters + 0.5)
    return total_us / launches * k if k else total_us / iters


def runtime_calls(events: list[dict], name: str | None = None) -> list[tuple[float, dict]]:
    """(host ts, event) of the CUDA runtime and driver calls, in order;
    only those called `name` where given."""
    out = [(float(e["ts"]), e) for e in events
           if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver")
           and (name is None or e.get("name") == name)]
    return sorted(out, key=lambda x: x[0])


def launch_spans(events: list[dict], spans: list) -> dict:
    """{correlation: name of the innermost span in `spans` open on the
    host when the call with that correlation was made}."""
    out = {}
    for ts, e in runtime_calls(events):
        corr = e.get("args", {}).get("correlation")
        name = innermost(spans, ts) if corr is not None else None
        if name is not None:
            out[corr] = name
    return out


def innermost(spans: list, t: float) -> str | None:
    """The name of the shortest span in `spans` that holds time t."""
    best = None
    for s0, s1, name in spans:
        if s0 <= t < s1 and (best is None or s1 - s0 < best[1] - best[0]):
            best = (s0, s1, name)
    return best[2] if best else None


def clip(leaves: list, lo: float, hi: float) -> list:
    """The leaves inside [lo, hi], cut to it."""
    out = []
    for ts, dur, name, corr in leaves:
        a, b = max(ts, lo), min(ts + dur, hi)
        if b > a:
            out.append((a, b - a, name, corr))
    return out


def busy_intervals(leaves: list) -> list[tuple[float, float]]:
    """The union of the leaves' [start, end) intervals, in order."""
    merged: list[list[float]] = []
    for ts, dur, *_ in sorted(leaves, key=lambda e: e[0]):
        end = ts + dur
        if merged and ts <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([ts, end])
    return [(a, b) for a, b in merged]


def busy_us(leaves: list) -> float:
    return sum(b - a for a, b in busy_intervals(leaves))


def idle_gaps(leaves: list, lo: float, hi: float, spans: list) -> list[tuple[str, float]]:
    """Every idle stretch of one card inside [lo, hi], as (the innermost
    harness span open on the host at its midpoint, or "other", length in
    us), longest first."""
    gaps, at = [], lo
    for a, b in busy_intervals(leaves):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi))
    out = [(innermost(spans, (a + b) / 2) or "other", b - a) for a, b in gaps]
    return sorted(out, key=lambda g: -g[1])
