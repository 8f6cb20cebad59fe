"""Simplest API: filter one YV12 frame with each backend.

    python -m gpu_video_codec_tpu_torch.examples.one_shot [--device cpu] [--output out.yuv]

Counterpart of examples/one_shot.py.
"""

from __future__ import annotations

import numpy as np

from . import TESTDATA, parser
from ..models.pipeline import DeblockPipeline
from ..utils.yuv import read_yv12, write_yv12


def main(argv: list[str] | None = None) -> int:
    p = parser(__doc__)
    p.add_argument("--input", default=str(TESTDATA / "mother-daughter_352x288_yv12.yuv"),
                   help="a 352x288 YV12 frame (default: the bundled mother-daughter frame)")
    p.add_argument("--output", help="write the filtered frame here")
    args = p.parse_args(argv)
    frame = read_yv12(args.input, 352, 288)
    out = DeblockPipeline(352, 288, qp=35, backend="cuda", device=args.device)(frame)
    if args.output:
        write_yv12(args.output, out)
    gold = DeblockPipeline(352, 288, qp=35, backend="golden")(frame)
    for backend in ("cuda", "torch", "native"):
        got = out if backend == "cuda" else DeblockPipeline(
            352, 288, qp=35, backend=backend, device=args.device)(frame)
        if not all(np.array_equal(getattr(got, k), getattr(gold, k)) for k in "yuv"):
            print(f"{backend} backend differs from the golden oracle")
            return 1
    print(f"filtered {int(np.sum(out.y != frame.y))} luma px on {args.device}; cuda, torch and "
          f"native backends bit-exact vs the golden oracle")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
