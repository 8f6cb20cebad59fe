"""Device-resident pipelines: frames stay on the device in the tile-planes
layout between stages, so each deblock step costs only the deblock kernels
(K1 and K1c).  Also shows frame batching: N frames per kernel launch.

    python -m gpu_video_codec_tpu_torch.examples.resident_chain [--device cpu]

Counterpart of examples/resident_chain.py.
"""

from __future__ import annotations

import numpy as np

from . import parser
from ..models.pipeline import DeblockPipeline
from ..models.resident import ResidentDeblocker
from ..utils.yuv import planes_from_yv12_bytes, yv12_bytes_from_planes


def main(argv: list[str] | None = None) -> int:
    args = parser(__doc__).parse_args(argv)
    w, h, qp = 352, 288, 35
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, 3 * w * h // 2, dtype=np.uint8)

    rd = ResidentDeblocker(w, h, qp, device=args.device)

    # one-shot (ingest -> step -> readback), checked against the oracle
    out = rd(raw)
    gold = DeblockPipeline(w, h, qp, backend="golden")
    want = np.frombuffer(yv12_bytes_from_planes(gold(planes_from_yv12_bytes(raw, w, h))),
                         np.uint8)
    if not np.array_equal(out, want):
        print("one-shot differs from the golden oracle")
        return 1

    # a chain: the state never leaves the device between steps.  Insert your
    # own tile-planes stages between the steps -- the layout contract is
    # TileFrame(y=(8,8,By,Bx), uv=(8,8,2cBy,cBx), u_rem, v_rem), uint8
    state = rd.ingest(raw)
    for _ in range(3):
        state = rd.step(state)  # kernels only, no layout work
    chained = rd.readback(state)
    ref = planes_from_yv12_bytes(raw, w, h)
    for _ in range(3):
        ref = gold(ref)
    if not np.array_equal(chained, np.frombuffer(yv12_bytes_from_planes(ref), np.uint8)):
        print("the 3-step chain differs from 3 golden passes")
        return 1

    # frame batches: one kernel launch for the whole batch
    batch_out = rd([raw, raw, raw])
    if batch_out.shape != (3, raw.size) or not all(np.array_equal(b, out) for b in batch_out):
        print("the 3-frame batch differs from the one-shot frame")
        return 1
    print(f"resident on {args.device}: one-shot and a 3-step chain bit-exact vs the oracle; "
          f"3-frame batch in one launch")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
