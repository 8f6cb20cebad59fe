"""Scalar NumPy golden model: the obviously-correct oracle.

A deliberately slow, loop-per-tile re-implementation of the reference's CPU
deblocking semantics (class ReadYuvFrame, hevc_deblocking_filter_cpu.h:33-1489),
used as the bit-exactness oracle for every vectorized/TPU path in this
framework.  All arithmetic is plain Python ints (== C++ int semantics for
these ranges, with floor `>>` on negatives).

Defined-behavior decisions where the reference is undefined (see SURVEY.md
quirks register):
  Q2: out-of-bounds flat BS reads (chroma loops gating with luma block
      counts, cpu.h:515/645/786/916) read 0 here => edge not filtered.
  Q6: padding pixels are 0 here (reference leaves them uninitialized).
Replicated-verbatim quirks: Q3 (right-horizontal P/Q column mismatch),
Q4 (horizontal BS init stride), Q7 (intra-tile segment order), Q8 (int32
arithmetic-shift math).
"""

from __future__ import annotations

import numpy as np

from ..ops.tables import MAX_PIXEL, SAMPLE_BLOCK_SIZE, get_beta, get_tc
from ..utils.bs import BoundaryStrength
from ..utils.yuv import FramePlanes


def clip1(delta: int, c: int) -> int:
    """[-c, c] clamp (cpu.h:1117-1120)."""
    if c < 0:
        raise ValueError("c parameter is negative")
    return min(max(-c, delta), c)


def clip2(value: int) -> int:
    """[0, 255] clamp (cpu.h:1123-1126)."""
    return min(max(0, value), MAX_PIXEL)


def check_local_adaptivity(p, q, beta: int) -> bool:
    """Condition (1) on rows 0 and 3 (cpu.h:1074-1089)."""
    d = (
        abs(p[0][2] - 2 * p[0][1] + p[0][0])
        + abs(p[3][2] - 2 * p[3][1] + p[3][0])
        + abs(q[0][2] - 2 * q[0][1] + q[0][0])
        + abs(q[3][2] - 2 * q[3][1] + q[3][0])
    )
    return d < beta


def is_strong_filter(p, q, beta: int, tc: int) -> bool:
    """Conditions (2) and (3) and (4) on rows 0 and 3 (cpu.h:1091-1114)."""
    cond2 = (abs(p[0][2] - 2 * p[0][1] + p[0][0]) + abs(q[0][2] - 2 * q[0][1] + q[0][0])) < beta // 8 and (
        abs(p[3][2] - 2 * p[3][1] + p[3][0]) + abs(q[3][2] - 2 * q[3][1] + q[3][0])
    ) < beta // 8
    cond3 = (abs(p[0][3] - p[0][0]) + abs(q[0][0] - q[0][3])) < beta // 8 and (
        abs(p[3][3] - p[3][0]) + abs(q[3][0] - q[3][3])
    ) < beta // 8
    cond4 = abs(p[0][0] - q[0][0]) < (5 * tc) // 2 and abs(p[3][0] - q[3][0]) < (5 * tc) // 2
    return cond2 and cond3 and cond4


def _strong_side(x, y, c):
    """Strong-filter deltas for one side of one row (cpu.h:1152-1199).
    x = own side [x0..x3], y = opposite side [y0, y1]."""
    d0 = clip1((x[2] + 2 * x[1] - 6 * x[0] + 2 * y[0] + y[1] + 4) >> 3, c)
    d1 = clip1((x[2] - 3 * x[1] + x[0] + y[0] + 2) >> 2, c)
    d2 = clip1((2 * x[3] - 5 * x[2] + x[1] + x[0] + y[0] + 4) >> 3, c)
    return [clip2(x[0] + d0), clip2(x[1] + d1), clip2(x[2] + d2), x[3]]


def apply_strong_filter(p, q, tc: int):
    """cpu.h:1128-1213: all four rows, three pixels modified on each side."""
    c = 2 * tc
    new_p = [_strong_side(p[r], q[r], c) for r in range(4)]
    new_q = [_strong_side(q[r], p[r], c) for r in range(4)]
    return new_p, new_q


def apply_normal_filter(p, q, beta: int, tc: int):
    """cpu.h:1215-1357: per-row |delta0| gate, cond5/cond6 side-pixel gates."""
    c = 2 * tc
    c2 = tc // 2
    cond5 = (abs(p[0][2] - 2 * p[0][1] + p[0][0]) + abs(p[3][2] - 2 * p[3][1] + p[3][0])) < (3 * beta) // 16
    cond6 = (abs(q[0][2] - 2 * q[0][1] + q[0][0]) + abs(q[3][2] - 2 * q[3][1] + q[3][0])) < (3 * beta) // 16
    new_p = [list(row) for row in p]
    new_q = [list(row) for row in q]
    for r in range(4):
        delta0 = (9 * (q[r][0] - p[r][0]) - 3 * (q[r][1] - p[r][1]) + 8) >> 4
        if abs(delta0) < 10 * tc:
            big_d = clip1(delta0, c)
            dp1 = clip1((((p[r][2] + p[r][0] + 1) >> 1) - p[r][1] + big_d) >> 1, c2)
            dq1 = clip1((((q[r][2] + q[r][0] + 1) >> 1) - q[r][1] - big_d) >> 1, c2)
            new_p[r][0] = clip2(p[r][0] + big_d)
            new_q[r][0] = clip2(q[r][0] - big_d)
            if cond5:
                new_p[r][1] = clip2(p[r][1] + dp1)
            if cond6:
                new_q[r][1] = clip2(q[r][1] + dq1)
    return new_p, new_q


def luma_filter_segment(p, q, beta: int, tc: int):
    """Luma edge dispatch for one 4-row segment (cpu.h:1359-1429).
    p, q: 4x4 nested lists [row][dist]; returns filtered copies."""
    if not check_local_adaptivity(p, q, beta):
        return [list(r) for r in p], [list(r) for r in q]
    if is_strong_filter(p, q, beta, tc):
        return apply_strong_filter(p, q, tc)
    return apply_normal_filter(p, q, beta, tc)


def chroma_filter_segment(p, q, tc: int):
    """Chroma edge filter for one segment (cpu.h:1431-1488).
    p, q: 4x2 nested lists [row][dist]; only distance-0 pixels change."""
    new_p = [list(r) for r in p]
    new_q = [list(r) for r in q]
    for r in range(4):
        dp = clip1((((p[r][0] - q[r][0]) * 4) + p[r][1] - q[r][1] + 4) >> 3, tc)
        dq = clip1((((q[r][0] - p[r][0]) * 4) + q[r][1] - p[r][1] + 4) >> 3, tc)
        new_p[r][0] = clip2(p[r][0] + dp)
        new_q[r][0] = clip2(q[r][0] - dq)
    return new_p, new_q


# ---------------------------------------------------------------------------
# Per-tile sweep
# ---------------------------------------------------------------------------

# (p, q) pixel coordinates inside the tile as (row, col) of filter row r and
# edge distance j -- derived from the reference's pointer grids (see
# ops/deblock.py docstring for the cpu.h line ranges of each).
_GEOM = {
    "upper_vert": (lambda r, j: (r, 3 - j), lambda r, j: (r, 4 + j)),
    "lower_vert": (lambda r, j: (4 + r, 3 - j), lambda r, j: (4 + r, 4 + j)),
    "left_hor": (lambda r, j: (3 - j, r), lambda r, j: (4 + j, r)),
    "right_hor": (lambda r, j: (3 - j, 4 + r), lambda r, j: (4 + j, r)),
}


def _bs_flat(flat: np.ndarray, idx: int) -> int:
    """Flat BS read with the OOB->0 rule (Q2)."""
    if 0 <= idx < flat.size:
        return int(flat[idx])
    return 0


def _filter_tile_segment(plane: np.ndarray, by: int, bx: int, phase: str,
                         beta: int, tc: int, chroma: bool) -> None:
    b = SAMPLE_BLOCK_SIZE
    p_at, q_at = _GEOM[phase]
    nj = 2 if chroma else 4
    p = [[int(plane[b * by + p_at(r, j)[0], b * bx + p_at(r, j)[1]]) for j in range(nj)] for r in range(4)]
    q = [[int(plane[b * by + q_at(r, j)[0], b * bx + q_at(r, j)[1]]) for j in range(nj)] for r in range(4)]
    if chroma:
        new_p, new_q = chroma_filter_segment(p, q, tc)
        touched = 1
    else:
        new_p, new_q = luma_filter_segment(p, q, beta, tc)
        touched = 3
    for r in range(4):
        for j in range(touched):
            pr, pc = p_at(r, j)
            plane[b * by + pr, b * bx + pc] = new_p[r][j]
            qr, qc = q_at(r, j)
            plane[b * by + qr, b * bx + qc] = new_q[r][j]


def _deblock_plane_golden(plane: np.ndarray, flat_vert: np.ndarray, flat_hor: np.ndarray,
                          lookup_w: int, gate_ny: int, gate_nx: int,
                          beta: int, tc: int, chroma: bool) -> None:
    """In-place tile sweep over one extended plane.

    Mirrors the loop structure of cpu.h:146-448 (luma) / 453-992 (chroma):
    for each tile, segments in the order upper-vert, lower-vert, left-hor,
    right-hor (Q7), each gated by its flat-indexed BS value.
    """
    b = SAMPLE_BLOCK_SIZE
    ny, nx = plane.shape[0] // b, plane.shape[1] // b
    sv = lookup_w // b + 1
    sh = lookup_w // b
    for bx in range(nx):
        for by in range(ny):
            bs_ver1 = _bs_flat(flat_vert, (by - 1) * sv + bx) if by > 0 else 0
            bs_ver2 = _bs_flat(flat_vert, by * sv + bx) if by < gate_ny - 1 else 0
            bs_hor1 = _bs_flat(flat_hor, by * sh + (bx - 1)) if bx > 0 else 0
            bs_hor2 = _bs_flat(flat_hor, by * sh + bx) if bx < gate_nx - 1 else 0
            gates = (
                (bs_ver1 == 2 if chroma else bs_ver1 > 0),
                (bs_ver2 == 2 if chroma else bs_ver2 > 0),
                (bs_hor1 == 2 if chroma else bs_hor1 > 0),
                (bs_hor2 == 2 if chroma else bs_hor2 > 0),
            )
            for phase, on in zip(("upper_vert", "lower_vert", "left_hor", "right_hor"), gates):
                if on:
                    _filter_tile_segment(plane, by, bx, phase, beta, tc, chroma)


def deblock_frame_golden(frame: FramePlanes, bs: BoundaryStrength, qp: int,
                         luma_only: bool = False) -> FramePlanes:
    """Golden full-frame deblock: luma, then U, then V (cpu.h:134-993)."""
    if (bs.width, bs.height) != (frame.width, frame.height):
        # a mismatched BS object would silently produce a wrong oracle
        # (every out-of-range read is defined as 0 by the Q2 rule)
        raise ValueError("BoundaryStrength geometry does not match the frame")
    beta, tc = get_beta(qp), get_tc(qp)
    b = SAMPLE_BLOCK_SIZE
    y = frame.y.copy()
    u = frame.u.copy()  # ndarray.copy() is C-contiguous; the flat views below are writable
    v = frame.v.copy()
    luma_n = (frame.height // b + 1, frame.width // b + 1)
    _deblock_plane_golden(y, bs.vert, bs.hor, frame.width, luma_n[0], luma_n[1], beta, tc, chroma=False)
    if not luma_only:
        cw = frame.chroma_width
        # Q2: chroma segment-existence gates use the *luma* tile counts.
        # Q9: the reference's chroma pointer arithmetic uses row stride
        # num_chroma_blocks_x*8 (cpu.h:469-471 et al.), not _new_chroma_width;
        # the sweep therefore acts on the flat buffer reinterpreted as an
        # (8*ncby, 8*ncbx) image -- a sheared view whenever the extended
        # chroma width is not a multiple of 8.  Deliberately re-derived here
        # rather than reusing utils/tiles.split_covered: the golden model is
        # the independent oracle the vectorized paths are tested against.
        for plane in (u, v):
            hext, wext = plane.shape
            ncby, ncbx = hext // b, wext // b
            view = plane.reshape(-1)[: ncby * b * ncbx * b].reshape(ncby * b, ncbx * b)
            _deblock_plane_golden(view, bs.chroma_vert, bs.chroma_hor, cw,
                                  luma_n[0], luma_n[1], beta, tc, chroma=True)
    return FramePlanes(y=y, u=u, v=v, width=frame.width, height=frame.height)
