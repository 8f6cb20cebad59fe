"""The plain reference against the golden model of the program's package
(a scalar per-tile oracle), byte for byte, at small sizes: both BS mixes,
heights with h % 16 == 8 (chroma gates past the BS arrays) and chroma
widths that shear the chroma sweep; the control (right shifts rounding
toward zero) differs.

    python -m pytest bench_torch/tests -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_torch.lib import frames as fr
from bench_torch.references import hevc_deblock as ref

CONTENT = {"luma_dc": 24, "chroma_dc": 12}


def golden(raw, w, h, qp, bs):
    from gpu_video_codec_tpu_torch.models.golden import deblock_frame_golden
    from gpu_video_codec_tpu_torch.utils.bs import BoundaryStrength
    from gpu_video_codec_tpu_torch.utils.yuv import planes_from_yv12_bytes, yv12_bytes_from_planes

    out = deblock_frame_golden(planes_from_yv12_bytes(raw, w, h),
                               BoundaryStrength.from_arrays(w, h, **bs), qp)
    return np.frombuffer(yv12_bytes_from_planes(out), np.uint8)


@pytest.mark.parametrize("w, h, qp", [(64, 48, 37), (72, 40, 32), (40, 24, 51), (24, 8, 45),
                                      (136, 88, 37)])
@pytest.mark.parametrize("mix", [{"bs": "ai"}, {"bs": "ra", "bs_shares": [0.70, 0.25, 0.05]},
                                 {"bs": "ra", "bs_shares": [0.2, 0.3, 0.5]}])
def test_reference_equals_golden(w, h, qp, mix):
    seed = 2**31 + w * h + qp
    frames = fr.frame_pool(2, w, h, seed, CONTENT, "cpu")
    bs = fr.bs_arrays(w, h, mix, seed, "cpu")
    out = ref.deblock_packed(frames, w, h, qp, bs)
    control = ref.deblock_packed(frames, w, h, qp, bs, shift="trunc")
    changed = 0
    for f in range(2):
        raw = frames[f].numpy().reshape(-1)
        gold = golden(raw, w, h, qp, bs)
        assert np.array_equal(out[f].numpy().reshape(-1), gold)
        changed += int((gold != raw).sum())
    assert changed > 0
    if mix["bs"] == "ai":
        assert not torch.equal(control, out)


def test_blocky_content_takes_every_filter_path():
    # luma at 1080p-like QP 37: decision (1) fails somewhere, and where it
    # holds both the strong and the normal filter run
    w, h = 256, 128
    frames = fr.frame_pool(1, w, h, 7, CONTENT, "cpu")
    y = torch.nn.functional.pad(frames[:, :h].to(torch.int32), (4, 4, 4, 4))
    tiles = ref._to_tiles(y)
    beta, tc = ref.beta_tc(37)
    pi = ref._flat_index(ref._PHASES[0][0], 4, "cpu")
    qi = ref._flat_index(ref._PHASES[0][1], 4, "cpu")
    p, q = tiles[..., pi], tiles[..., qi]

    def second(x, r):
        return (x[..., r, 2] - 2 * x[..., r, 1] + x[..., r, 0]).abs()

    on = (second(p, 0) + second(p, 3) + second(q, 0) + second(q, 3)) < beta
    strong = on & ((p[..., 0, 0] - q[..., 0, 0]).abs() < (5 * tc) // 2) & \
        ((second(p, 0) + second(q, 0)) < beta // 8) & ((second(p, 3) + second(q, 3)) < beta // 8)
    assert 0 < int(on.sum()) < on.numel()
    assert 0 < int(strong.sum()) < int(on.sum())
