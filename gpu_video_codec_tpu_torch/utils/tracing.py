"""Device-trace timing: what the card executed, not host wall time.

Counterpart of gpu_video_codec_tpu/utils/tracing.py over torch.profiler.
The profiler records every kernel, memcpy and memset the card ran (CUPTI
activity records, kernels inside CUDA graph replays included) on device
lanes of its Chrome trace, apart from the host lanes that hold the Python,
operator and CUDA-runtime spans.  Summing the device lanes' leaf events by
name gives device time per op, immune to host dispatch and queue depth.

API:
  device_op_totals(d)   -> {op_name: total_us} for device-lane LEAF events of
                           every Chrome trace under d (*.json, *.json.gz:
                           torch.profiler's export_chrome_trace and
                           jax.profiler's *.trace.json.gz alike)
  categorize_ops(totals)-> {deblock_kernels, layout_and_copies, other, total}
  profiled_device_us(thunk, iters) -> (per_iter_us, cats, top_ops) or None
                           when the trace has no device lane (a CPU run)
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import tempfile
from collections import defaultdict

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
    """Sum device-lane LEAF complete-event durations (us) by op name.

    Device lanes are identified by process metadata: the TPU runtime
    names them '/device:TPU:0' (process_name); torch.profiler gives every
    lane the program's process_name and labels them 'GPU 0' or 'CPU'
    (process_labels).  Host processes are excluded.  Containers (the
    scopes above, and any event that encloses another on its track) would
    double-count, so only leaves are summed."""
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
    for track in by_track.values():
        track.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0.0))))
        stack: list[tuple[float, dict]] = []  # (end_ts, event) of open spans
        has_child: dict[int, bool] = {}

        def _close(parent):
            if not has_child.pop(id(parent), False):
                totals[parent.get("name", "?")] += float(parent.get("dur", 0.0))

        for e in track:
            ts = float(e["ts"])
            while stack and stack[-1][0] <= ts:
                _close(stack.pop()[1])
            if stack:
                has_child[id(stack[-1][1])] = True
            stack.append((ts + float(e.get("dur", 0.0)), e))
            has_child[id(e)] = False
        while stack:
            _close(stack.pop()[1])
    return dict(totals)


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
    the trace has no device lane (a CPU run).

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

    def read(d: str) -> dict[str, float]:
        prof.export_chrome_trace(os.path.join(d, "trace.json"))
        return device_op_totals(d)

    if trace_dir is not None:
        os.makedirs(trace_dir, exist_ok=True)
        totals = read(trace_dir)
    else:
        with tempfile.TemporaryDirectory(prefix="gvct_trace_") as d:
            totals = read(d)
    if not totals:
        return None
    cats = {k: v / iters for k, v in categorize_ops(totals).items()}
    top = {k: round(v / iters, 2)
           for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:12]}
    return cats["total"], cats, top
