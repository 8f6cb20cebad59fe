"""Host-fed streaming: packed YV12 buffers in, filtered buffers out, with
the host-to-device copy overlapped under the kernels (`depth` frames in
flight).

    python -m gpu_video_codec_tpu_torch.examples.streaming [--device cpu]

Counterpart of examples/streaming.py.
"""

from __future__ import annotations

import numpy as np

from . import parser
from ..models.pipeline import DeblockPipeline
from ..models.streaming import StreamingDeblocker
from ..utils.yuv import planes_from_yv12_bytes, yv12_bytes_from_planes


def main(argv: list[str] | None = None) -> int:
    args = parser(__doc__).parse_args(argv)
    w, h, qp, n = 352, 288, 35, 4
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, 3 * w * h // 2, dtype=np.uint8) for _ in range(n)]

    s = StreamingDeblocker(w, h, qp, backend="cuda", depth=2, device=args.device)
    outs = list(s.run(frames))

    gold = DeblockPipeline(w, h, qp, backend="golden")
    for i, (raw, out) in enumerate(zip(frames, outs)):
        ref = gold(planes_from_yv12_bytes(raw.tobytes(), w, h))
        if not np.array_equal(out, np.frombuffer(yv12_bytes_from_planes(ref), np.uint8)):
            print(f"frame {i} differs from the golden oracle")
            return 1
    print(f"streamed {n} frames with copy overlap on {args.device}; all bit-exact vs the oracle")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
