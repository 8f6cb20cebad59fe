"""Device time of the streaming packed step (StreamingDeblocker._step, one
CUDA graph replay) at given geometries, on one CUDA device, for comparing
two trees of the port in one run on one card.

    python gpu_video_codec_tpu_torch/tools/step_time.py [--tree DIR] \\
        [--geometry 360x288 --geometry 1920x1080] [--iters 200] [--repeats 5]

--tree: the checkout whose gpu_video_codec_tpu_torch is imported (default:
the one this file lies in), so that the same measurement runs on a second
tree, e.g. a `git archive` of another commit.  Prints one JSON line: per
geometry the device µs per step of each repeat (utils.timing.device_ms:
CUDA events around `iters` replays queued behind a spin kernel), whether
the host queued ahead each time, and the launches of one step by kernel;
with --dispatch also the host dispatch per step (time_breakdown's
dispatch_s) of each repeat.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), help="checkout to import the port from")
    p.add_argument("--geometry", action="append", help="WxH (default 360x288 and 1920x1080)")
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--dispatch", action="store_true", help="also the host dispatch per step")
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("step_time: needs a CUDA device", file=sys.stderr)
        return 1
    from gpu_video_codec_tpu_torch.models.streaming import StreamingDeblocker
    from gpu_video_codec_tpu_torch.ops import cuda_kernel as ck
    from gpu_video_codec_tpu_torch.ops import relayout_kernel as rk
    from gpu_video_codec_tpu_torch.utils.timing import device_ms

    import gpu_video_codec_tpu_torch as pkg

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True).stdout.strip()
    rng = np.random.default_rng(7)
    steps = {}
    for geom in args.geometry or ["360x288", "1920x1080"]:
        w, h = (int(v) for v in geom.split("x"))
        s = StreamingDeblocker(w, h, 35, device=dev)
        buf = s._put(rng.integers(0, 256, 3 * w * h // 2, dtype=np.uint8))
        s._step(buf)  # builds the kernels and captures the step's graph
        torch.cuda.synchronize()
        before = {**rk.LAUNCHES, **ck.LAUNCHES}
        s._step(buf)
        launches = {k: v - before[k] for k, v in {**rk.LAUNCHES, **ck.LAUNCHES}.items()
                    if v != before[k]}
        runs = [device_ms(lambda: s._step(buf), args.iters) for _ in range(args.repeats)]
        steps[geom] = {"us": [ms * 1e3 for ms, _ in runs],
                       "queued_ahead": [ok for _, ok in runs], "launches": launches}
        if args.dispatch:
            frame = buf.cpu().numpy().reshape(-1)
            steps[geom]["dispatch_us"] = [s.time_breakdown(frame, n=50)["dispatch_s"] * 1e6
                                          for _ in range(args.repeats)]
    print(json.dumps({"tree": os.path.relpath(os.path.dirname(os.path.dirname(pkg.__file__))),
                      "card": smi, "steps": steps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
