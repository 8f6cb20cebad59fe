"""Mesh device-resident streaming: a frame batch over the mesh's "data"
slots, each slot running the batched deblock kernels on its own frames
with no exchange between slots (tiles never communicate).

    python -m gpu_video_codec_tpu_torch.examples.mesh_streams [--device cpu]

On the card the mesh holds every CUDA device; with --device cpu, two CPU
slots.  Counterpart of examples/mesh_streams.py.
"""

from __future__ import annotations

import numpy as np

from . import parser
from .multi_stream import mesh_of
from ..models.pipeline import DeblockPipeline
from ..parallel import MeshResidentDeblocker
from ..utils.yuv import planes_from_yv12_bytes, yv12_bytes_from_planes


def main(argv: list[str] | None = None) -> int:
    args = parser(__doc__).parse_args(argv)
    mesh = mesh_of(args.device)
    w, h, qp = 64, 48, 35
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, 3 * w * h // 2, dtype=np.uint8)
              for _ in range(2 * mesh.size)]

    mrd = MeshResidentDeblocker(mesh, w, h, qp)
    state = mrd.ingest(frames)            # two frames per slot
    state = mrd.step(state, n_steps=2)    # chained kernel-only passes, every slot
    chained = mrd.readback(state)

    gold = DeblockPipeline(w, h, qp, backend="golden")
    for i, raw in enumerate(frames):
        ref = planes_from_yv12_bytes(raw.tobytes(), w, h)
        for _ in range(2):
            ref = gold(ref)
        if not np.array_equal(chained[i], np.frombuffer(yv12_bytes_from_planes(ref), np.uint8)):
            print(f"frame {i}: the 2-step chain differs from 2 golden passes")
            return 1
    print(f"{len(frames)} frames over {mesh.size} slot(s) ({mesh.shape}) on {args.device}; "
          f"a 2-step resident chain bit-exact vs the oracle")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
