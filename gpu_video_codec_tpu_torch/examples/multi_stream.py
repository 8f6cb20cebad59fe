"""Multi-stream deblocking: N concurrent YV12 streams zipped into per-step
batches, filtered over a mesh of device slots (one batched packed step per
slot and batch) and returned per stream.

    python -m gpu_video_codec_tpu_torch.examples.multi_stream [--device cpu]

On the card the mesh holds every CUDA device; with --device cpu, two CPU
slots.  Two streams per slot, so each slot filters a local batch of two.
Counterpart of examples/multi_stream.py.
"""

from __future__ import annotations

import numpy as np
import torch

from . import parser
from ..models.pipeline import DeblockPipeline
from ..parallel import MultiStreamDeblocker, make_mesh
from ..utils.yuv import planes_from_yv12_bytes, yv12_bytes_from_planes


def mesh_of(device: str):
    """A (slots, 1) mesh: every CUDA device for "cuda", else two slots of
    `device`."""
    if device == "cuda":
        return make_mesh(torch.cuda.device_count(), 1)
    return make_mesh(2, 1, [device] * 2)


def main(argv: list[str] | None = None) -> int:
    args = parser(__doc__).parse_args(argv)
    mesh = mesh_of(args.device)
    w, h, qp, n_steps = 64, 48, 35, 3
    n_streams = 2 * mesh.size
    rng = np.random.default_rng(0)
    # N independent frame streams (cameras, transcode jobs, ...)
    streams = [[rng.integers(0, 256, 3 * w * h // 2, dtype=np.uint8) for _ in range(n_steps)]
               for _ in range(n_streams)]

    ms = MultiStreamDeblocker(mesh, n_streams, w, h, qp)
    gold = DeblockPipeline(w, h, qp, backend="golden")
    checked = 0
    for t, outs in enumerate(ms.run(streams)):  # one frame per stream per step
        for i, out in enumerate(outs):
            ref = gold(planes_from_yv12_bytes(streams[i][t].tobytes(), w, h))
            if not np.array_equal(out, np.frombuffer(yv12_bytes_from_planes(ref), np.uint8)):
                print(f"stream {i} step {t} differs from the golden oracle")
                return 1
            checked += 1
    print(f"multi-stream: {n_streams} streams x {n_steps} steps over {mesh.size} slot(s) "
          f"on {args.device}; all {checked} frames bit-exact vs the oracle")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
