"""The port's one tracing module: device time from torch.profiler's trace,
and the program's own spans and counters.

Device time.  Counterpart of gpu_video_codec_tpu/utils/tracing.py over
torch.profiler.  The profiler records every kernel, memcpy and memset the
card ran (CUPTI activity records, kernels inside CUDA graph replays
included) on device lanes of its Chrome trace, apart from the host lanes
that hold the Python, operator and CUDA-runtime spans.  Summing the device
lanes' leaf events by name gives device time per op, immune to host
dispatch and queue depth.

  device_op_totals(d)   -> {op_name: total_us} for device-lane LEAF events of
                           every Chrome trace under d (*.json, *.json.gz:
                           torch.profiler's export_chrome_trace and
                           jax.profiler's *.trace.json.gz alike)
  device_op_stats(d)    -> {op_name: (total_us, launches)} of the same events
  per_iter_us(total_us, launches, iters) -> one op's device time per
                           iteration, robust to launches outside the window
  categorize_ops(totals)-> {deblock_kernels, layout_and_copies, other, total}
  profiled_device_us(thunk, iters) -> (per_iter_us, cats, top_ops) or None
                           when the trace has no device lane (a CPU run)

Program spans and counters.  RECORDER (a Recorder) holds, in memory, the
spans the program stamps at its layer boundaries with time.perf_counter_ns
and its counter:

  mesh.packed   parallel/mesh._packed_sharded, the whole packed batch call
                (the root: every span of one call carries its call id, the
                mesh.calls count of the call)
  mesh.fork     parallel/mesh._run: the slot's device made current (the
                replay goes on the caller's current stream of that device)
  graphs.launch parallel/mesh._run: CapturedStep.timed_replay's launch of
                the graph alone
  mesh.join     parallel/mesh._run: the caller's device restored
  graphs.capture  utils/graphs.CapturedStep's warm-up on clones and capture
  kernels.load  ops/cuda_kernel._load: a library's first load
  kernels.build ops/cuda_kernel._build: the compiler run, where it runs

  counter mesh.calls: every packed batch call; the kernels' launches stay
  in utils/graphs.COUNTERS.
  counters packed.luma_tiles, packed.chroma_tiles: parallel/mesh.
  _packed_sharded, the luma and the chroma (U and V) tiles of the frames
  that each packed batch call hands to its step (ops/cuda_kernel.
  packed_grids times the frames), two integer adds a call.

The profiled stretch's timeline also splits the rest of a call: mesh.place
(the checks and the first slot's operands, up to its fork) and
graphs.lookup (the graph's key, the cache, the launch counters).

Spans closed outside any torch.profiler session add to totals per name
(count, nanoseconds, self nanoseconds); spans closed inside a session go to
a bounded timeline instead (name, start, end, id, parent id, call id), so
the totals describe unprofiled work and the timeline the profiled stretch.
Outside a session one packed call in EVERY is stamped, so that the rest
pay only the count; inside one, every call.
"""

from __future__ import annotations

import glob
import gzip
import itertools
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import NamedTuple

from torch.autograd import profiler as _autograd_profiler

# control/module scopes are not hardware ops; they can live on tracks of
# their own where per-track nesting cannot catch them (the JAX package's
# names)
_SCOPES = ("jit_", "jit__", "while", "condition", "body", "cond_")
# Chrome-trace categories of device-lane spans that enclose work rather
# than being work: record_function ranges mirrored onto the GPU lanes
_SCOPE_CATS = ("gpu_user_annotation",)
_DEBLOCK = ("deblock", "swar", "custom-call", "mosaic")
_LAYOUT = ("copy", "transpose", "bitcast", "reshape", "concatenate", "pad", "slice",
           "fusion", "convert", "convolution", "dot",
           # the port's relayout and pack kernels (T2, T3, T4), the copy
           # engines and PyTorch's fill kernels
           "plane_to_tiles", "tiles_to_plane", "pack_yv12", "memcpy", "memset", "fill")


def _trace_files(trace_dir: str) -> list[str]:
    found = set()
    for pat in ("*.json", "*.json.gz"):
        found.update(glob.glob(os.path.join(trace_dir, "**", pat), recursive=True))
    return sorted(found)


def _load_trace_events(trace_dir: str) -> list[dict]:
    """Every Chrome-trace event of every trace file under trace_dir."""
    events: list[dict] = []
    for path in _trace_files(trace_dir):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            data = json.load(f)
        events.extend(data.get("traceEvents", []) if isinstance(data, dict) else data)
    return events


def _is_device_lane(name: str) -> bool:
    return "TPU" in name or "/device:" in name.lower() or "GPU" in name


def device_op_totals(trace_dir: str) -> dict[str, float]:
    """Sum device-lane LEAF complete-event durations (us) by op name."""
    return {name: us for name, (us, _) in device_op_stats(trace_dir).items()}


def device_op_stats(trace_dir: str) -> dict[str, tuple[float, int]]:
    """(summed duration in us, event count) of device-lane LEAF complete
    events by op name.

    Device lanes are identified by process metadata: the TPU runtime
    names them '/device:TPU:0' (process_name); torch.profiler gives every
    lane the program's process_name and labels them 'GPU 0' or 'CPU'
    (process_labels).  Host processes are excluded.  Containers (the
    scopes above, and any event that wholly encloses another on its track)
    would double-count, so only leaves are summed.  Events that only
    partly overlap both count: the kernels of one CUDA graph replay
    overlap their successor by up to 0.8 us in an H100's trace."""
    events = _load_trace_events(trace_dir)
    device_pids = set()
    for e in events:
        if e.get("ph") == "M" and e.get("name") in ("process_name", "process_labels"):
            args = e.get("args", {})
            if _is_device_lane(str(args.get("name", args.get("labels", "")))):
                device_pids.add(e.get("pid"))
    by_track: dict[tuple, list[dict]] = defaultdict(list)
    for e in events:
        if (e.get("ph") == "X" and e.get("pid") in device_pids
                and e.get("cat") not in _SCOPE_CATS
                and not str(e.get("name", "")).startswith(_SCOPES)):
            by_track[(e.get("pid"), e.get("tid", 0))].append(e)
    totals: dict[str, float] = defaultdict(float)
    launches: dict[str, int] = defaultdict(int)
    for track in by_track.values():
        track.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0.0))))
        stack: list[tuple[float, dict]] = []  # (end_ts, event) of open spans
        has_child: dict[int, bool] = {}

        def _close(parent):
            if not has_child.pop(id(parent), False):
                totals[parent.get("name", "?")] += float(parent.get("dur", 0.0))
                launches[parent.get("name", "?")] += 1

        for e in track:
            ts = float(e["ts"])
            end = ts + float(e.get("dur", 0.0))
            while stack and stack[-1][0] <= ts:
                _close(stack.pop()[1])
            # the innermost open event that ends no earlier encloses e; one
            # that ends inside e only overlaps it (and one that ended before
            # e may still sit under such an event)
            for open_end, parent in reversed(stack):
                if open_end >= end and open_end > ts:
                    has_child[id(parent)] = True
                    break
            stack.append((end, e))
            has_child[id(e)] = False
        while stack:
            _close(stack.pop()[1])
    return {name: (us, launches[name]) for name, us in totals.items()}


def per_iter_us(total_us: float, launches: int, iters: int) -> float:
    """One op's device time per iteration of a profiled window of `iters`
    iterations in which it was recorded `launches` times, `total_us` in all.

    A window can hold fewer launches than its iterations made (work queued
    before it started, or cut at its edge), so total_us / iters would read
    low.  The op's mean launch is taken times the launches per iteration
    that the recorded count rounds to; an op recorded in fewer than half
    the iterations is averaged over all."""
    k = int(launches / iters + 0.5)
    return total_us / launches * k if k else total_us / iters


def categorize_ops(totals: dict[str, float]) -> dict[str, float]:
    """Bucket op names into deblock kernels (K1, K1c, K1-i16, T5, T1) vs
    layout and copies (T2, T3, T4, memcpy/memset, PyTorch's copy, fill, pad
    and cat kernels) vs other.  The JAX package's op names land in the same
    buckets as there."""
    cats: dict[str, float] = defaultdict(float)
    for name, us in totals.items():
        n = name.lower()
        if n.startswith(_SCOPES):
            cats["scopes_should_be_empty"] += us
        elif any(k in n for k in _DEBLOCK):
            cats["deblock_kernels"] += us
        elif any(k in n for k in _LAYOUT):
            cats["layout_and_copies"] += us
        else:
            cats["other"] += us
    cats["total"] = sum(v for k, v in cats.items() if k != "total")
    return dict(cats)


def profiled_device_us(thunk, iters: int = 20, trace_dir: str | None = None):
    """Run `thunk()` `iters` times under torch.profiler (CPU and, where
    there is a card, CUDA activities); return (device_us_per_iter,
    categories, top_ops) from the device lanes' leaf events, or None when
    the trace has no device lane (a CPU run).  Each op counts per_iter_us
    of its recorded launches, so launches the profiler missed do not lower
    the reading.

    The card is synchronized before the trace closes, so every launch of
    the window has finished inside it.  The trace is exported as a Chrome
    trace into trace_dir (default: a temporary directory, removed after)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        for _ in range(iters):
            thunk()
        if cuda:
            torch.cuda.synchronize()

    def read(d: str) -> dict[str, tuple[float, int]]:
        prof.export_chrome_trace(os.path.join(d, "trace.json"))
        return device_op_stats(d)

    if trace_dir is not None:
        os.makedirs(trace_dir, exist_ok=True)
        stats = read(trace_dir)
    else:
        with tempfile.TemporaryDirectory(prefix="gvct_trace_") as d:
            stats = read(d)
    if not stats:
        return None
    per_iter = {k: per_iter_us(us, n, iters) for k, (us, n) in stats.items()}
    cats = categorize_ops(per_iter)
    top = {k: round(v, 2) for k, v in sorted(per_iter.items(), key=lambda kv: -kv[1])[:12]}
    return cats["total"], cats, top


# -- the program's spans and counters --------------------------------------------

stamp = time.perf_counter_ns  # the clock of every span
TIMELINE_BOUND = 1 << 17  # spans kept per process; a packed call keeps 6
EVERY = 31  # one unprofiled packed call in EVERY is recorded; odd, so that it
            # does not keep step with a caller's queue depth or frame cycle


def profiling() -> bool:
    """Whether a torch.profiler session is active."""
    return _autograd_profiler._is_profiler_enabled


class Span(NamedTuple):
    """A span of the timeline: perf_counter_ns stamps, its own id, the id
    of the span it ran in (None for a root), and the packed batch call it
    belongs to (None outside one)."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    call: int | None


class Total(NamedTuple):
    """Spans of one name closed outside any profiler session: how many,
    their nanoseconds, and those less the time of the spans inside them."""
    count: int
    ns: int
    self_ns: int


class Recorder:
    """Spans and counters of one process (module docstring).  One thread
    records at a time: the parents of spans from concurrent threads would
    mix.

    A packed batch call is recorded from its stamps in one commit, after
    its end: start_call() counts it and, where it is to be recorded, hands
    out the list that the call's layers append their stamps to; end_call()
    turns them into spans.  The other calls pay the count alone."""

    __slots__ = ("bound", "every", "calls", "luma_tiles", "chroma_tiles", "dropped", "_hot",
                 "_cold", "_timeline", "_open", "_ids", "_setup")

    def __init__(self, bound: int = TIMELINE_BOUND, every: int = EVERY):
        self.bound = bound
        self.every = every  # the unprofiled packed calls recorded: one in `every`
        self.reset()

    def reset(self) -> None:
        """Drop every total, counter and kept span."""
        self.calls = 0  # the counter mesh.calls
        self.luma_tiles = self.chroma_tiles = 0  # packed.luma_tiles, packed.chroma_tiles
        self.dropped = 0  # spans closed in a session after the timeline was full
        # recorded unprofiled calls, their replays, and the ns of mesh.packed,
        # mesh.fork, graphs.launch and mesh.join
        self._hot = [0, 0, 0, 0, 0, 0]
        self._cold: dict[str, list[int]] = defaultdict(lambda: [0, 0, 0])  # count, ns, self ns
        self._timeline: list[tuple] = []  # Span fields, as plain tuples (cheaper to make)
        self._open: list[list] = []  # open span() blocks, innermost last: [id or None, child ns]
        self._ids = itertools.count(1)
        self._setup = False  # a span() block closed since the last recorded call

    # -- read-out

    def totals(self) -> dict[str, Total]:
        """{span name: Total} of the spans closed outside any profiler
        session.  mesh.packed's self time is the call less its replays'
        mesh.fork, graphs.launch and mesh.join."""
        calls, runs, packed, fork, launch, join = self._hot
        out = {}
        if calls:
            out["mesh.packed"] = Total(calls, packed, packed - fork - launch - join)
        if runs:
            out.update((name, Total(runs, ns, ns)) for name, ns in (
                ("mesh.fork", fork), ("graphs.launch", launch), ("mesh.join", join)))
        out.update((name, Total(*t)) for name, t in self._cold.items())
        return out

    def counters(self) -> dict[str, int]:
        """The counters that have counted: mesh.calls, packed.luma_tiles and
        packed.chroma_tiles."""
        return {name: n for name, n in (("mesh.calls", self.calls),
                                         ("packed.luma_tiles", self.luma_tiles),
                                         ("packed.chroma_tiles", self.chroma_tiles)) if n}

    def timeline(self) -> list[Span]:
        """The spans closed inside profiler sessions, in closing order."""
        return [Span(*t) for t in self._timeline]

    # -- recording

    def _keep(self, span: tuple) -> None:
        if len(self._timeline) < self.bound:
            self._timeline.append(span)
        else:
            self.dropped += 1

    def span(self, name: str) -> "_OpenSpan":
        """A span around a with-block, the parent of the spans closed
        inside it (for work done once, such as a build or a capture)."""
        return _OpenSpan(self, name)

    def start_call(self) -> list[int] | None:
        """Count a packed batch call (mesh.calls).  Where it is recorded
        (every call inside a profiler session, one in `every` outside),
        returns the list for its stamps, its start stamp first; else None."""
        self.calls += 1
        if self.calls % self.every and not _autograd_profiler._is_profiler_enabled:
            return None
        return [stamp()]

    def add_tiles(self, luma: int, chroma: int) -> None:
        """Count the tiles a packed batch call hands to its step."""
        self.luma_tiles += luma
        self.chroma_tiles += chroma

    def end_call(self, stamps: list[int]) -> None:
        """Close a packed batch call from start_call's list: its start, then
        five stamps for each slot's graph replay (mesh.fork's start and end,
        graphs.launch's start and end, mesh.join's end); its end is stamped
        here.  Outside a session a call in which a span() block closed (a
        capture, a load) did set-up work, and is left out of the totals."""
        t1 = stamp()
        if _autograd_profiler._is_profiler_enabled:
            self._keep_call(stamps, t1)
            return
        if self._setup:
            self._setup = False
            return
        hot = self._hot
        hot[0] += 1
        hot[2] += t1 - stamps[0]
        for i in range(1, len(stamps), 5):
            fork, forked, launch, launched, joined = stamps[i:i + 5]
            hot[1] += 1
            hot[3] += forked - fork
            hot[4] += launched - launch
            hot[5] += joined - launched

    def _keep_call(self, stamps: list[int], t1: int) -> None:
        """Keep a profiled call's spans: mesh.packed (the root; its id the
        call's), mesh.place up to the first replay, and each replay's
        mesh.fork, graphs.lookup (the key, the cache and the launch
        counters, with any capture), graphs.launch and mesh.join.  The spans
        closed since the call began ran in it: they get the call's id, and
        those without a parent the root as theirs."""
        t0, call, root, ids, tl = stamps[0], self.calls, next(self._ids), self._ids, self._timeline
        i = len(tl)
        while i and tl[i - 1][1] >= t0:
            i -= 1
            name, a, b, span_id, parent, _ = tl[i]
            tl[i] = (name, a, b, span_id, root if parent is None else parent, call)
        self._keep(("mesh.place", t0, stamps[1] if len(stamps) > 1 else t1, next(ids), root,
                    call))
        for i in range(1, len(stamps), 5):
            fork, forked, launch, launched, joined = stamps[i:i + 5]
            self._keep(("mesh.fork", fork, forked, next(ids), root, call))
            self._keep(("graphs.lookup", forked, launch, next(ids), root, call))
            self._keep(("graphs.launch", launch, launched, next(ids), root, call))
            self._keep(("mesh.join", launched, joined, next(ids), root, call))
        outer = self._open[-1][0] if self._open else None
        self._keep(("mesh.packed", t0, t1, root, outer, call))


class _OpenSpan:
    __slots__ = ("rec", "name", "t0", "frame")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.frame = [next(self.rec._ids) if profiling() else None, 0]
        self.rec._open.append(self.frame)
        self.t0 = stamp()
        return self

    def __exit__(self, *exc) -> None:
        t1, rec = stamp(), self.rec
        span_id, child_ns = self.frame
        if rec._open and rec._open[-1] is self.frame:
            rec._open.pop()
        ns = t1 - self.t0
        if rec._open:
            rec._open[-1][1] += ns
        rec._setup = True
        if not profiling():
            tot = rec._cold[self.name]
            tot[0] += 1
            tot[1] += ns
            tot[2] += ns - child_ns
            return
        parent = rec._open[-1][0] if rec._open else None
        rec._keep((self.name, self.t0, t1, next(rec._ids) if span_id is None else span_id,
                   parent, None))


def self_ns(spans: list[Span]) -> dict[int, int]:
    """{span id: self time in ns}: each span's duration less the part of
    its interval that its children cover."""
    children: dict[int, list[tuple[int, int]]] = defaultdict(list)
    for s in spans:
        if s.parent is not None:
            children[s.parent].append((s.start_ns, s.end_ns))
    out = {}
    for s in spans:
        covered, at = 0, s.start_ns
        for a, b in sorted(children.get(s.id, ())):
            a, b = max(a, at), min(b, s.end_ns)
            if b > a:
                covered += b - a
                at = b
        out[s.id] = s.end_ns - s.start_ns - covered
    return out


RECORDER = Recorder()
