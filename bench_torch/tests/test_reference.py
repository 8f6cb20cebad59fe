"""The plain reference against the golden model of the program's package
(a scalar per-tile oracle), byte for byte, at small sizes: both BS mixes,
heights with h % 16 == 8 (chroma gates past the BS arrays) and chroma
widths that shear the chroma sweep; the control (right shifts rounding
toward zero) differs.  At 4:2:2 the golden model's 4:2:0 chroma of a frame
twice as tall is the witness, at 4:4:4 that of a frame twice as tall and
twice as wide, each beside hand-derived edges; at 10 bits hand-derived
luma edges.

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


# -- 4:2:2 (HEVC format range extensions): each chroma plane is (h, w/2) --------------
#
# A 4:2:2 chroma plane is a 4:2:0 chroma plane of a frame twice as tall: the same
# plane shape, the same flat chroma BS arrays, the same lookup width, and the gate
# by the luma tile counts changes nothing (the chroma tile rows are the luma ones,
# and a lower vertical segment of the last tile row reads past the array, 0).  So the
# golden model, which knows 4:2:0 alone, is a witness of the 4:2:2 reading.

@pytest.mark.parametrize("w, h, qp", [(64, 48, 37), (72, 40, 32), (40, 24, 51), (136, 88, 37)])
@pytest.mark.parametrize("mix", [{"bs": "ai"}, {"bs": "ra", "bs_shares": [0.2, 0.3, 0.5]}])
def test_4_2_2_chroma_is_the_golden_4_2_0_chroma_of_a_frame_twice_as_tall(w, h, qp, mix):
    seed = 2**31 + 3 * w * h + qp
    frames = fr.frame_pool(2, w, h, seed, CONTENT, "cpu", chroma_format="4:2:2")
    assert frames.shape == (2, 2 * h, w)
    bs = fr.bs_arrays(w, h, mix, seed, "cpu", "4:2:2")
    out = ref.deblock_packed(frames, w, h, qp, bs, chroma_format="4:2:2")
    # luma is 4:2:0's, whatever the chroma planes hold
    assert torch.equal(out[:, :h], ref.deblock_packed(frames[:, : 3 * h // 2], w, h, qp, bs)[:, :h])
    tall_bs = fr.bs_arrays(w, 2 * h, mix, seed, "cpu")
    assert all(tall_bs[k].size == bs[k].size for k in ("chroma_vert", "chroma_hor"))
    tall_bs.update(chroma_vert=bs["chroma_vert"], chroma_hor=bs["chroma_hor"])
    changed = 0
    for f in range(2):
        tall = np.concatenate([np.zeros(2 * h * w, np.uint8), frames[f, h:].numpy().reshape(-1)])
        gold = golden(tall, w, 2 * h, qp, tall_bs)[2 * h * w :]
        assert np.array_equal(out[f, h:].numpy().reshape(-1), gold)
        changed += int((gold != tall[2 * h * w :]).sum())
    assert changed > 0


# Hand-derived from the reference's chroma filter (cpu.h:1431-1488, as the golden
# model has it), one sample a side where BS == 2:
#   dp = Clip3(-tc, tc, ((p0 - q0) * 4 + p1 - q1 + 4) >> 3), p0' = Clip1(p0 + dp)
#   dq = Clip3(-tc, tc, ((q0 - p0) * 4 + q1 - p1 + 4) >> 3), q0' = Clip1(q0 - dq)
# A 64x32 4:2:2 frame, (64, 64) rows: U and V (32, 32), each row of a plane alike,
# luma flat; BS 0 everywhere but chroma_hor, all 2, so only horizontal chroma edges
# filter: every 8 chroma rows, 8 .. 24 inside the plane.  A 4:2:0 frame of h = 32
# has chroma rows 0-15 alone: rows 16 and 24 are edges only at 4:2:2.  Each plane
# steps at rows 16 and 24 and is flat across row 8, which stays.  The four segment
# phases run in order over every tile; a tile covers chroma columns 8 bx - 4 ..
# 8 bx + 3.  The left horizontal phase filters P and Q at columns 8 bx - 4 .. 8 bx - 1;
# the right one P at 8 bx .. 8 bx + 3 against Q at 8 bx - 4 .. 8 bx - 1 (the column
# mismatch), reading and rewriting the Q that the left phase wrote.  So on columns
# 8 bx - 4 .. 8 bx - 1 ("b") q0 is filtered twice, and on 8 bx .. 8 bx + 3 ("a") it
# is never filtered; p0 is filtered once on both.  Columns 8-23 (tiles 1-3) are away
# from the borders, where the zero padding takes part.

def _422_edges(rows_u, rows_v, fill, bit_depth):
    """The reference's U and V (32, 32) planes of the 64x32 frame whose planes'
    rows 0-15, 16-23 and 24-31 hold rows_u (rows_v); luma `fill`."""
    w, h = 64, 32
    frame = torch.full((1, 2 * h, w), fill, dtype=torch.int16 if bit_depth == 10 else torch.uint8)
    planes = frame[0, h:].view(2, h, w // 2)
    for plane, (a, b, c) in zip(planes, (rows_u, rows_v)):
        plane[:16], plane[16:24], plane[24:] = a, b, c
    bs = fr.bs_arrays(w, h, {"bs": "ai"}, 0, "cpu", "4:2:2")
    bs = {k: np.full_like(v, 2 if k == "chroma_hor" else 0) for k, v in bs.items()}
    out = ref.deblock_packed(frame, w, h, 37, bs, bit_depth=bit_depth, chroma_format="4:2:2")
    assert torch.equal(out[0, :h], frame[0, :h])
    return frame[0, h:].view(2, h, w // 2), out[0, h:].view(2, h, w // 2)


def _expect(before, row_values):
    """before's columns 8-23 with row r's "a" and "b" columns set to row_values[r]."""
    expect = before[:, 8:24].clone()
    for r, (a, b) in row_values.items():
        expect[r, [0, 1, 2, 3, 8, 9, 10, 11]] = a  # columns 8-11, 16-19
        expect[r, [4, 5, 6, 7, 12, 13, 14, 15]] = b  # columns 12-15, 20-23
    return expect


def test_4_2_2_chroma_edges_at_rows_16_and_24():
    # tc' = 4 at QP 37.  U: 100 | 110 | 120.  Edge 16, left phase: p0 = 100, q0 = 110,
    #   dp = (-40 - 10 + 4) >> 3 = -6 -> -4: p0' = 96; dq = (40 + 10 + 4) >> 3 = 6 -> 4:
    #   q0' = 106.  Right phase, q0 = 106 (b), q1 = 110, p0 = p1 = 100 (a):
    #   dq = (24 + 10 + 4) >> 3 = 4: q0'' = 102 (b); dp = (-24 - 10 + 4) >> 3 = -4: p0' = 96 (a).
    #   Edge 24 alike, 10 up: row 23 106, row 24 112 (b) and 120 (a).
    # V: 60 | 50 | 40, the mirror: row 15 64, row 16 58 (b) and 50 (a); row 23 54,
    #   row 24 48 (b) and 40 (a).
    before, out = _422_edges((100, 110, 120), (60, 50, 40), 128, 8)
    assert torch.equal(out[0, 1:31, 8:24],
                       _expect(before[0], {15: (96, 96), 16: (110, 102),
                                           23: (106, 106), 24: (120, 112)})[1:31])
    assert torch.equal(out[1, 1:31, 8:24],
                       _expect(before[1], {15: (64, 64), 16: (50, 58),
                                           23: (54, 54), 24: (40, 48)})[1:31])


def test_4_2_2_chroma_edges_at_10_bits_clip_at_1023():
    # tc = 4 * 4 = 16.  U: 1020 | 980 | 1023.  Edge 16, left: dp = (160 + 40 + 4) >> 3 = 25
    #   -> 16: p0' = Clip1(1036) = 1023; dq = (-160 - 40 + 4) >> 3 = -25 -> -16: q0' = 996.
    #   Right: q0 = 996 (b), q1 = 980, p0 = p1 = 1020 (a): dq = (-96 - 40 + 4) >> 3 = -17
    #   -> -16: q0'' = 1012 (b); dp = (96 + 40 + 4) >> 3 = 17 -> 16: p0' = Clip1(1036) = 1023.
    #   Edge 24, left: p0 = 980, q0 = 1023: dp = (-172 - 43 + 4) >> 3 = -27 -> -16: 964;
    #   dq = (172 + 43 + 4) >> 3 = 27 -> 16: 1007.  Right: q0 = 1007 (b), q1 = 1023, p0 =
    #   p1 = 980: dq = (108 + 43 + 4) >> 3 = 19 -> 16: 991 (b); dp = (-108 - 43 + 4) >> 3
    #   = -19 -> -16: 964 (a).
    # V: 40 | 80 | 0, near the other end of the range.  Edge 16, left: dp = (-160 - 40
    #   + 4) >> 3 = -25 -> -16: 24; dq = 25 -> 16: 64.  Right: q0 = 64, q1 = 80, p0 = p1 =
    #   40: dq = (96 + 40 + 4) >> 3 = 17 -> 16: 48 (b); dp = (-96 - 40 + 4) >> 3 = -17 ->
    #   -16: 24 (a).  Edge 24, left: p0 = 80, q0 = 0: dp = (320 + 80 + 4) >> 3 = 50 -> 16:
    #   96; dq = (-320 - 80 + 4) >> 3 = -50 -> -16: 16.  Right: q0 = 16 (b), q1 = 0, p0 =
    #   p1 = 80: dq = (-256 - 80 + 4) >> 3 = -42 -> -16: 32 (b); dp = (256 + 80 + 4) >> 3
    #   = 42 -> 16: 96 (a).
    before, out = _422_edges((1020, 980, 1023), (40, 80, 0), 512, 10)
    assert torch.equal(out[0, 1:31, 8:24],
                       _expect(before[0], {15: (1023, 1023), 16: (980, 1012),
                                           23: (964, 964), 24: (1023, 991)})[1:31])
    assert torch.equal(out[1, 1:31, 8:24],
                       _expect(before[1], {15: (24, 24), 16: (80, 48),
                                           23: (96, 96), 24: (0, 32)})[1:31])


# -- 4:4:4 (HEVC format range extensions): each chroma plane is (h, w) ----------------
#
# A 4:4:4 chroma plane is a 4:2:0 chroma plane of a frame twice as tall and twice as
# wide: the same plane shape, the same flat chroma BS arrays and the same lookup width.
# The gates differ in one place: the 4:4:4 plane is gated by its own tile counts, the
# tall and wide frame's chroma by its luma tile counts, one more tile column, so there
# the right horizontal segment of the last tile column (P in the padding) reads
# chroma_hor[(by + 1) w/8].  With those entries 0 the gates agree, and the golden
# model, which knows 4:2:0 alone, is a witness of the 4:4:4 reading.

@pytest.mark.parametrize("w, h, qp", [(64, 48, 37), (72, 40, 32), (40, 24, 51), (136, 88, 37)])
@pytest.mark.parametrize("mix", [{"bs": "ai"}, {"bs": "ra", "bs_shares": [0.2, 0.3, 0.5]}])
def test_4_4_4_chroma_is_the_golden_4_2_0_chroma_of_a_frame_twice_as_tall_and_wide(w, h, qp,
                                                                                   mix):
    seed = 2**31 + 5 * w * h + qp
    frames = fr.frame_pool(2, w, h, seed, CONTENT, "cpu", chroma_format="4:4:4")
    assert frames.shape == (2, 3 * h, w)
    bs = fr.bs_arrays(w, h, mix, seed, "cpu", "4:4:4")
    bs["chroma_hor"][w // 8 :: w // 8] = 0
    ny, nx = h // 8 + 1, w // 8 + 1
    own = ref.gates(bs["chroma_vert"], bs["chroma_hor"], w, ny, nx, ny, nx, True, "cpu")
    big_frame_s = ref.gates(bs["chroma_vert"], bs["chroma_hor"], w, ny, nx, 2 * h // 8 + 1,
                            2 * w // 8 + 1, True, "cpu")
    assert torch.equal(own, big_frame_s) and int(own.sum()) > 0
    out = ref.deblock_packed(frames, w, h, qp, bs, chroma_format="4:4:4")
    # luma is 4:2:0's, whatever the chroma planes hold
    assert torch.equal(out[:, :h], ref.deblock_packed(frames[:, : 3 * h // 2], w, h, qp, bs)[:, :h])
    big_bs = fr.bs_arrays(2 * w, 2 * h, mix, seed, "cpu")
    assert all(big_bs[k].size == bs[k].size for k in ("chroma_vert", "chroma_hor"))
    big_bs.update(chroma_vert=bs["chroma_vert"], chroma_hor=bs["chroma_hor"])
    changed = 0
    for f in range(2):
        big = np.concatenate([np.zeros(4 * h * w, np.uint8), frames[f, h:].numpy().reshape(-1)])
        gold = golden(big, 2 * w, 2 * h, qp, big_bs)[4 * h * w :]
        assert np.array_equal(out[f, h:].numpy().reshape(-1), gold)
        changed += int((gold != big[4 * h * w :]).sum())
    assert changed > 0


# Hand-derived as the 4:2:2 edges above.  A 32x32 4:4:4 frame, (96, 32) rows: U and V
# (32, 32), luma flat.  A 4:2:0 frame of w = h = 32 has chroma planes (16, 16), whose one
# inner edge each way lies at luma row or column 16: chroma edges at luma rows and columns
# 8 and 24 exist only where chroma is not subsampled.
#   Vertical: BS 0 but chroma_vert, all 2; each plane's columns 0-7, 8-23 and 24-31
#   hold three values, every row alike, so edges 8 and 24 filter and 16, flat, stays.
#   The two vertical phases read and write columns 3|4 of a tile, rows 0-3 and 4-7, so
#   every row gets p0' = Clip1(p0 + dp) at column 7 (23) and q0' = Clip1(q0 - dq) at 8
#   (24).  Columns 0 and 31 meet the zero padding.
#   Horizontal: BS 0 but chroma_hor, all 2; rows 0-7, 8-23 and 24-31 hold three values,
#   every column alike: the 4:2:2 case's rows 16 and 24 moved to rows 8 and 24, with the
#   column mismatch's "a" and "b" columns.  Rows 0 and 31 meet the zero padding.

def _444_edges(vertical, values_u, values_v, fill, bit_depth):
    """The reference's U and V (32, 32) planes of the 32x32 4:4:4 frame whose planes
    hold values_u (values_v) at rows (columns, where vertical) 0-7, 8-23 and 24-31."""
    w = h = 32
    frame = torch.full((1, 3 * h, w), fill, dtype=torch.int16 if bit_depth == 10 else torch.uint8)
    planes = frame[0, h:].view(2, h, w)
    for plane, (a, b, c) in zip(planes, (values_u, values_v)):
        cut = plane.T if vertical else plane
        cut[:8], cut[8:24], cut[24:] = a, b, c
    on = "chroma_vert" if vertical else "chroma_hor"
    bs = fr.bs_arrays(w, h, {"bs": "ai"}, 0, "cpu", "4:4:4")
    bs = {k: np.full_like(v, 2 if k == on else 0) for k, v in bs.items()}
    out = ref.deblock_packed(frame, w, h, 37, bs, bit_depth=bit_depth, chroma_format="4:4:4")
    assert torch.equal(out[0, :h], frame[0, :h])
    return frame[0, h:].view(2, h, w), out[0, h:].view(2, h, w)


def _expect_columns(before, column_values):
    """before's columns 1-30 with column c set to column_values[c] in every row."""
    expect = before[:, 1:31].clone()
    for c, v in column_values.items():
        expect[:, c - 1] = v
    return expect


@pytest.mark.parametrize("bit_depth, values, fill, u_cols, v_cols", [
    # tc' = 4 at QP 37; dp = ((p0 - q0) * 4 + p1 - q1 + 4) >> 3 = (5 (p0 - q0) + 4) >> 3
    # with p1 = p0 and q1 = q0, dq = (5 (q0 - p0) + 4) >> 3, each clipped to [-tc, tc].
    # U 100 | 110 | 120: edge 8, dp = -46 >> 3 = -6 -> -4: 96; dq = 54 >> 3 = 6 -> 4: 106;
    #   edge 24, p0 = 110, q0 = 120: 106 and 116.  V 60 | 50 | 40: edge 8, dp = 54 >> 3 =
    #   6 -> 4: 64; dq = -46 >> 3 = -6 -> -4: 54; edge 24: 54 and 44.
    (8, ((100, 110, 120), (60, 50, 40)), 128,
     {7: 96, 8: 106, 23: 106, 24: 116}, {7: 64, 8: 54, 23: 54, 24: 44}),
    # tc = 4 * 4 = 16.  U 1020 | 980 | 1023: edge 8, dp = 204 >> 3 = 25 -> 16:
    #   Clip1(1036) = 1023; dq = -196 >> 3 = -25 -> -16: 996; edge 24, p0 = 980, q0 =
    #   1023: dp = -211 >> 3 = -27 -> -16: 964; dq = 219 >> 3 = 27 -> 16: 1007.
    # V 40 | 80 | 0: edge 8, dp = -196 >> 3 = -25 -> -16: 24; dq = 204 >> 3 = 25 -> 16:
    #   64; edge 24, p0 = 80, q0 = 0: dp = 404 >> 3 = 50 -> 16: 96; dq = -396 >> 3 = -50
    #   -> -16: 16.
    (10, ((1020, 980, 1023), (40, 80, 0)), 512,
     {7: 1023, 8: 996, 23: 964, 24: 1007}, {7: 24, 8: 64, 23: 96, 24: 16}),
])
def test_4_4_4_chroma_edges_at_columns_8_and_24(bit_depth, values, fill, u_cols, v_cols):
    before, out = _444_edges(True, *values, fill, bit_depth)
    assert torch.equal(out[0, :, 1:31], _expect_columns(before[0], u_cols))
    assert torch.equal(out[1, :, 1:31], _expect_columns(before[1], v_cols))


@pytest.mark.parametrize("bit_depth, values, fill, u_rows, v_rows", [
    # the values of test_4_2_2_chroma_edges_at_rows_16_and_24, its edge 16 now at row 8
    (8, ((100, 110, 120), (60, 50, 40)), 128,
     {7: (96, 96), 8: (110, 102), 23: (106, 106), 24: (120, 112)},
     {7: (64, 64), 8: (50, 58), 23: (54, 54), 24: (40, 48)}),
    # and of test_4_2_2_chroma_edges_at_10_bits_clip_at_1023
    (10, ((1020, 980, 1023), (40, 80, 0)), 512,
     {7: (1023, 1023), 8: (980, 1012), 23: (964, 964), 24: (1023, 991)},
     {7: (24, 24), 8: (80, 48), 23: (96, 96), 24: (0, 32)}),
])
def test_4_4_4_chroma_edges_at_rows_8_and_24(bit_depth, values, fill, u_rows, v_rows):
    before, out = _444_edges(False, *values, fill, bit_depth)
    assert torch.equal(out[0, 1:31, 8:24], _expect(before[0], u_rows)[1:31])
    assert torch.equal(out[1, 1:31, 8:24], _expect(before[1], v_rows)[1:31])
