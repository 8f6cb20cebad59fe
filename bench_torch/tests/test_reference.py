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


def _filter_paths(bit_depth, content):
    """(filter on, strong) per upper vertical segment of a 256x128 frame's
    luma at QP 37."""
    w, h = 256, 128
    frames = fr.frame_pool(1, w, h, 7, content, "cpu", bit_depth)
    y = torch.nn.functional.pad(frames[:, :h].to(torch.int32), (4, 4, 4, 4))
    tiles = ref._to_tiles(y)
    beta, tc = ref.beta_tc(37, bit_depth)
    pi = ref._flat_index(ref._PHASES[0][0], 4, "cpu")
    qi = ref._flat_index(ref._PHASES[0][1], 4, "cpu")
    p, q = tiles[..., pi], tiles[..., qi]

    def second(x, r):
        return (x[..., r, 2] - 2 * x[..., r, 1] + x[..., r, 0]).abs()

    on = (second(p, 0) + second(p, 3) + second(q, 0) + second(q, 3)) < beta
    strong = on & ((p[..., 0, 0] - q[..., 0, 0]).abs() < (5 * tc) // 2) & \
        ((second(p, 0) + second(q, 0)) < beta // 8) & ((second(p, 3) + second(q, 3)) < beta // 8)
    return on, strong


def test_blocky_content_takes_every_filter_path():
    # luma at 1080p-like QP 37: decision (1) fails somewhere, and where it
    # holds both the strong and the normal filter run
    on, strong = _filter_paths(8, CONTENT)
    assert 0 < int(on.sum()) < on.numel()
    assert 0 < int(strong.sum()) < int(on.sum())


def test_blocky_content_takes_every_filter_path_at_10_bits():
    on, strong = _filter_paths(10, MAIN10_CONTENT)
    assert 0 < int(on.sum()) < on.numel()
    assert 0 < int(strong.sum()) < int(on.sum())


# -- 10 bits (HEVC Main 10), derived by hand from H.265's luma equations ------------
#
# A 32x8 frame, every row alike: columns 12-15 are p3 p2 p1 p0, 16-19 are q0
# q1 q2 q3 of the vertical edge x = 16, columns 0-11 repeat p3 and 20-31 q3
# (flat across x = 8 and x = 24, which the strong filter leaves as they are),
# chroma 512.  All-intra BS, QP 37: beta' 36, tc' 4, so at 10 bits beta =
# 36 * 4 = 144 and tc = 4 * 4 = 16.  The picture's borders meet samples of
# 500 and more against the zero padding: |delta0| >= (6 * 500 + 8) >> 4 =
# 188 >= 10 tc, so they stay.  Per row (rows 0 and 3 alike):
#   dp = |p2 - 2 p1 + p0|, dq = |q2 - 2 q1 + q0|, d = 2 (dp + dq): on if d < beta;
#   strong if, on rows 0 and 3, 2 (dp + dq) < beta >> 2,
#     |p3 - p0| + |q0 - q3| < beta >> 3 and |p0 - q0| < (5 tc + 1) >> 1;
#   strong: p0' = Clip3(p0 - 2tc, p0 + 2tc, (p2 + 2 p1 + 2 p0 + 2 q0 + q1 + 4) >> 3),
#     p1' = Clip3(.., (p2 + p1 + p0 + q0 + 2) >> 2),
#     p2' = Clip3(.., (2 p3 + 3 p2 + p1 + p0 + q0 + 4) >> 3), q alike;
#   normal: D = (9 (q0 - p0) - 3 (q1 - p1) + 8) >> 4, the row filters if |D| < 10 tc,
#     D = Clip3(-tc, tc, D) (the reference clamps at 2 tc; every |D| here is
#     under tc, where both agree), p0' = Clip1(p0 + D), q0' = Clip1(q0 - D),
#     p1' = Clip1(p1 + Clip3(-(tc >> 1), tc >> 1, (((p2 + p0 + 1) >> 1) - p1 + D) >> 1))
#     where 2 dp < (beta + (beta >> 1)) >> 3 = 27, q1' alike with -D;
#   Clip1 clips to [0, 1023].

MAIN10_CONTENT = {"luma_dc": 96, "chroma_dc": 48}


def _edge_frame(p, q):
    """(p0, p1, p2, p3), (q0, q1, q2, q3) -> the (1, 12, 32) int16 frame."""
    row = [p[3]] * 13 + [p[2], p[1], p[0], q[0], q[1], q[2]] + [q[3]] * 13
    frame = torch.full((1, 12, 32), 512, dtype=torch.int16)
    frame[0, :8] = torch.tensor(row, dtype=torch.int16)
    return frame


def _filtered_edge(p, q, bit_depth=10):
    """The reference's p2' p1' p0' q0' q1' q2' of the edge's rows, after
    checking that every other luma sample kept its value."""
    frame = _edge_frame(p, q)
    bs = fr.bs_arrays(32, 8, {"bs": "ai"}, 0, "cpu")
    out = ref.deblock_packed(frame, 32, 8, 37, bs, bit_depth=bit_depth)
    assert out.dtype == torch.int16
    edge = out[0, :8, 13:19]
    assert (edge == edge[0]).all()
    if bit_depth == 10:
        rest = torch.cat([out[0, :8, :13], out[0, :8, 19:]], dim=1)
        assert torch.equal(rest, torch.cat([frame[0, :8, :13], frame[0, :8, 19:]], dim=1))
    return tuple(edge[0].tolist())


def test_main10_strong_filter_edge():
    p, q = (500, 500, 500, 500), (530, 530, 530, 530)
    # d = 0 < 144; 2 (dp + dq) = 0 < 36; |p3 - p0| + |q0 - q3| = 0 < 18; |p0 - q0| = 30 < 40
    # p0' = (500 + 1000 + 1000 + 1060 + 530 + 4) >> 3 = 4094 >> 3 = 511
    # p1' = (500 + 500 + 500 + 530 + 2) >> 2 = 2032 >> 2 = 508
    # p2' = (1000 + 1500 + 500 + 500 + 530 + 4) >> 3 = 4034 >> 3 = 504
    # q0' = (530 + 1060 + 1060 + 1000 + 500 + 4) >> 3 = 4154 >> 3 = 519
    # q1' = (530 + 530 + 530 + 500 + 2) >> 2 = 2092 >> 2 = 523
    # q2' = (1060 + 1590 + 530 + 530 + 500 + 4) >> 3 = 4214 >> 3 = 526; all within 2 tc = 32
    assert _filtered_edge(p, q) == (504, 508, 511, 519, 523, 526)
    # tc' = 4 unscaled: |p0 - q0| = 30 >= (5 * 4 + 1) >> 1 = 10, no strong filter
    assert _filtered_edge(p, q, bit_depth=8) != (504, 508, 511, 519, 523, 526)


def test_main10_normal_filter_edge_that_unscaled_thresholds_skip():
    p, q = (500, 500, 510, 510), (540, 540, 520, 520)
    # dp = |510 - 1000 + 500| = 10, dq = |520 - 1080 + 540| = 20, d = 60 < 144: on,
    # (but 60 >= beta' = 36: off with unscaled beta); 2 (dp + dq) = 60 >= 36: normal
    # D = (9 * 40 - 3 * 40 + 8) >> 4 = 248 >> 4 = 15, |15| < 160, within tc = 16
    # p0' = 515, q0' = 525; 2 dp = 20 < 27: p1' = 500 + Clip3(-8, 8, (505 - 500 + 15) >> 1 = 10)
    # = 508; 2 dq = 40 >= 27: q1 stays
    assert _filtered_edge(p, q) == (510, 508, 515, 525, 540, 520)
    assert _filtered_edge(p, q, bit_depth=8) == (510, 500, 500, 540, 540, 520)


def test_main10_clips_at_1023():
    p, q = (1010, 1023, 1023, 1023), (1023, 978, 933, 888)
    # dp = |1023 - 2046 + 1010| = 13, dq = |933 - 1956 + 1023| = 0, d = 26 < 144: on;
    # |p3 - p0| + |q0 - q3| = 13 + 135 >= 18: normal
    # D = (9 * 13 - 3 * (978 - 1023) + 8) >> 4 = 260 >> 4 = 16, |16| < 160, within tc
    # p0' = Clip1(1010 + 16 = 1026) = 1023; q0' = 1023 - 16 = 1007
    # 2 dp = 26 < 27: p1' = Clip1(1023 + Clip3(-8, 8, (1017 - 1023 + 16) >> 1 = 5) = 1028) = 1023
    # 2 dq = 0 < 27: q1' = 978 + Clip3(-8, 8, (978 - 978 - 16) >> 1 = -8) = 970
    assert _filtered_edge(p, q) == (1023, 1023, 1023, 1007, 970, 933)
    # a clip at 255, as at 8 bits, would put every filtered sample at 255
    assert _filtered_edge(p, q, bit_depth=8)[1:5] == (1023, 255, 255, 255)
