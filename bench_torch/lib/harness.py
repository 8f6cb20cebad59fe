"""One run of one cell: set up, warm up, measure, check, print one line.

    python3 bench_torch/run.py --workload NAME --seed N --seconds S --trace 0|1

The cell, its configuration, its traffic mix and its metrics are found by
name (lib/spec.py).  With --trace 0 the line carries the cell's
end-to-end metrics, with --trace 1 its per-layer metrics, read by
torch.profiler over the first stretch of the window.  --control runs the
control (the plain reference with broken arithmetic in the program's
place) for the check of the comparison; benchmark runs never pass it.

Without a CUDA device, or with fewer than the cell asks for, it exits 2
and prints no result: nothing falls back to the CPU.  Where the process
holds JAX or the JAX package once the window has closed, it names the
modules on standard error and exits 3 with no result.  The last lines on
standard error are the numbers compared with their limits; the last line
on standard output is the result:

  {"correct", "attempted", "failed", "metrics", "device", ["breakdown"], "checks"}
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import check, spec
from . import trace as tr


# top-level module names that a run of the port may not load
FORBIDDEN = ("jax", "jaxlib", "flax", "gpu_video_codec_tpu")


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name is one of FORBIDDEN, whole:
    `gpu_video_codec_tpu_torch` is the port and does not count."""
    return sorted(n for n in list(sys.modules) if n.split(".", 1)[0] in FORBIDDEN)


def parse(argv):
    p = argparse.ArgumentParser(prog="bench_torch/run.py", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _breakdown(t: dict) -> dict:
    """The device ops that took most time per batch (summed over cards)
    and the longest idle gaps by the harness span open on the host."""
    leaves = [e for c in t["cards"].values() for e in c]
    stats = tr.device_op_stats(leaves)
    ops = {k: tr.per_iter_us(us, n, max(1, t["batches"])) / 1e6 for k, (us, n) in stats.items()}
    gaps = [g for c in t["cards"].values() for g in tr.idle_gaps(c, t["lo"], t["hi"], t["spans"])]
    return {
        "device_ops": [[k, v] for k, v in sorted(ops.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[k, us / 1e6] for k, us in sorted(gaps, key=lambda g: -g[1])[:10]],
    }


def run_cell(spec_: dict, cell: dict, cfg: dict, mix: dict, seed: int, seconds: float,
             trace: bool, control: bool, t0: float, device: str = "cuda"):
    """One run; returns (result dict, compared numbers).  device "cpu" is
    for the harness's own tests at small sizes."""
    import torch

    from .feeds import Record, Tracer

    torch.set_num_threads(2)
    feed = spec.feed(mix["feed"])(cfg, mix, seed, device, control)
    feed.setup()
    cuda = device == "cuda"
    cards = range(int(cell["chips"])) if cuda else ()
    for d in cards:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    rec = Record(mix["feed"], feed.w, feed.h, int(mix.get("streams", 1)), feed.kind(),
                 feed.sample_bytes, feed.chroma_format)
    rec.setup_s = time.perf_counter() - t0
    tracer = Tracer(trace and cuda)
    feed.window(seconds, tracer, rec)
    peak = max((torch.cuda.max_memory_allocated(d) for d in cards), default=0)

    wrong, n_compared, wrong_frames = check.wrong_bytes(feed.samples, cfg, feed.bs, feed.device)
    compared = {"wrong_bytes": wrong}
    missing = feed.missing(rec)
    if missing is not None:
        compared["missing_frames"] = missing
    correct = n_compared > 0 and check.decide(compared)

    metrics = {}
    for m in spec.metrics(spec_, cell["name"], trace):
        value = spec.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": rec.kind,
           "count": len(cards) if cuda else 0, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": rec.handed,
              "failed": int((missing or 0) + wrong_frames), "metrics": metrics, "device": dev}
    if rec.trace is not None:
        t = rec.trace
        busy = [tr.busy_us(c) for c in t["cards"].values()]
        dev["busy_s"] = sum(busy) / len(busy) / 1e6
        dev["window_s"] = (t["hi"] - t["lo"]) / 1e6
        result["breakdown"] = _breakdown(t)
    result["checks"] = {k: {"value": v, "limit": check.LIMITS[k]} for k, v in compared.items()}
    return result, {**compared, "frames_compared": n_compared}


def main(argv, t0: float) -> int:
    args = parse(argv)
    spec_ = spec.load_spec()
    cell = spec.cell(spec_, args.workload)
    cfg, mix = spec.config(spec_, cell), spec.traffic(cell)

    import torch

    need = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench_torch: {args.workload} needs {need} CUDA device(s), found {have}; "
              "no result", file=sys.stderr)
        return 2
    result, compared = run_cell(spec_, cell, cfg, mix, args.seed, args.seconds,
                                bool(args.trace), args.control, t0)
    loaded = forbidden_modules()
    if loaded:
        print(f"bench_torch: {args.workload} seed {args.seed}: JAX or the JAX package "
              f"loaded in the run: {', '.join(loaded)}; no result", file=sys.stderr)
        return 3
    print(f"bench_torch: {args.workload} seed {args.seed}: {compared['frames_compared']} "
          f"frames compared with the reference{' (control)' if args.control else ''}",
          file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
