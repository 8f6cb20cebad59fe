"""Vectorized, branchless HEVC deblocking edge filters in torch int32 or int16.

The per-4-row-segment filter math of the reference (cpu.h:1074-1488) as
masked elementwise integer arithmetic over batches of segments -- the
plain PyTorch counterpart of gpu_video_codec_tpu/ops/filters.py, formula
for formula.  The same functions run on CPU and CUDA tensors; they are the
plain version that the hand-written kernel (csrc/deblock_tile.cuh) is
checked against.

Conventions
-----------
A luma segment is 4 filter rows x 8 pixels across the edge:
    p[r][j] = j-th pixel on the P side of row r (j = distance from the edge),
    q[r][j] = j-th pixel on the Q side.
The core functions (`*_planes`) take nested lists of per-(row, distance)
batch tensors of the compute dtype (shape (*B) each) and return the same
structure.
Array-shaped wrappers (`luma_edge_filter`, `chroma_edge_filter`) exist for
convenience and tests.

All arithmetic is signed 32-bit with arithmetic right shift (torch `>>` on
int32), matching the reference's `int` math (cpu.h:1154, 1253; quirk Q8),
or, with `dtype=torch.int16`, signed 16-bit as the JAX package's int16
path: every intermediate fits (see luma_edge_filter), so both give the
same bytes.  Thresholds are Python ints derived with `//` on non-negative
values; a Python int keeps a tensor's dtype in torch's type promotion, so
every operation runs in the planes' dtype (and every threshold, at most
10 * 24, fits int16).
The reference's `if` cascades become masks; outputs equal inputs wherever a
gate is off, which is exactly the reference's in-place no-write behavior.
"""

from __future__ import annotations

import torch

from .tables import MAX_PIXEL


def _clip1(delta, c: int):
    """Clamp to [-c, c] (cpu.h:1117-1120). c >= 0 always holds here."""
    return torch.clamp(delta, -c, c)


def _clip2(value, top: int = MAX_PIXEL):
    """Clamp to [0, top] (cpu.h:1123-1126 with max_v = (1<<8)-1, cpu.h:1202;
    top = 2^bit_depth - 1 at other bit depths, H.265's Clip1)."""
    return torch.clamp(value, 0, top)


def _second_deriv(a):
    """|x2 - 2*x1 + x0| for one side-row a = [x0, x1, x2, ...]."""
    return torch.abs(a[2] - 2 * a[1] + a[0])


def _select(mask, delta):
    """delta where mask, else 0 (in delta's dtype)."""
    return torch.where(mask, delta, torch.zeros_like(delta))


def luma_edge_filter_planes(p, q, bs_mask, beta: int, tc: int, top: int = MAX_PIXEL):
    """Luma edge dispatch on nested-list planes (cpu.h:1359-1429).

    p, q: 4x4 nested lists [row][dist] of int32 or int16 batch tensors
    (*B each), computed in that dtype.  bs_mask: bool (*B) (True where
    `BS > 0`, cpu.h:164).  beta, tc: ints, already scaled to the samples'
    bit depth; top: the largest sample value (255, or 1023 at 10 bits),
    where every filtered sample is clipped.
    Returns (new_p, new_q) nested lists; distance-3 entries are the input
    tensors unchanged.
    """
    beta, tc = int(beta), int(tc)
    # shared second-derivative magnitudes (rows 0 and 3), used by cond1
    # (cpu.h:1086), cond2 (cpu.h:1099) and cond5/6 (cpu.h:1245)
    dp0, dp3 = _second_deriv(p[0]), _second_deriv(p[3])
    dq0, dq3 = _second_deriv(q[0]), _second_deriv(q[3])

    pq0, pq3 = dp0 + dq0, dp3 + dq3
    cond1 = (pq0 + pq3) < beta

    beta8 = beta // 8
    cond2 = (pq0 < beta8) & (pq3 < beta8)                            # cpu.h:1099-1100
    cond3 = ((torch.abs(p[0][3] - p[0][0]) + torch.abs(q[0][0] - q[0][3])) < beta8) & (
        (torch.abs(p[3][3] - p[3][0]) + torch.abs(q[3][0] - q[3][3])) < beta8
    )                                                                 # cpu.h:1104-1105
    tc52 = (5 * tc) // 2
    cond4 = (torch.abs(p[0][0] - q[0][0]) < tc52) & (torch.abs(p[3][0] - q[3][0]) < tc52)

    gate = bs_mask & cond1
    strong = cond2 & cond3 & cond4
    use_strong = gate & strong     # cpu.h:1394
    use_normal = gate & ~strong    # cpu.h:1413

    c = 2 * tc                     # cpu.h:1191, 1235
    c2 = tc // 2                   # cpu.h:1236
    beta316 = (3 * beta) // 16
    tc10 = 10 * tc
    cond5 = (dp0 + dp3) < beta316  # cpu.h:1245
    cond6 = (dq0 + dq3) < beta316  # cpu.h:1249

    new_p = [[None] * 4 for _ in range(4)]
    new_q = [[None] * 4 for _ in range(4)]
    for r in range(4):
        p0, p1, p2, p3 = p[r]
        q0, q1, q2, q3 = q[r]

        # strong filter deltas (cpu.h:1152-1199) in the value form of the
        # JAX package: (A - 2^k*B) >> k == (A >> k) - B for arithmetic shift,
        # so each form equals the cited reference numerator bit for bit
        tpq = p0 + q0
        t = p1 + tpq                 # p1 + p0 + q0
        u = q1 + tpq                 # q1 + q0 + p0
        s0p = _clip1(((2 * t + p2 + q1 + 4) >> 3) - p0, c)          # cpu.h:1153
        s1p = _clip1(((t + p2 + 2) >> 2) - p1, c)                   # cpu.h:1160
        s2p = _clip1(((2 * (p3 + p2) + p2 + t + 4) >> 3) - p2, c)   # cpu.h:1167
        s0q = _clip1(((2 * u + q2 + p1 + 4) >> 3) - q0, c)
        s1q = _clip1(((u + q2 + 2) >> 2) - q1, c)
        s2q = _clip1(((2 * (q3 + q2) + q2 + u + 4) >> 3) - q2, c)

        # normal filter (cpu.h:1252-1275): per-row |delta0| gate
        delta0 = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
        row_gate = torch.abs(delta0) < tc10
        big_d = _clip1(delta0, c)
        dp1 = _clip1((((p2 + p0 + 1) >> 1) - p1 + big_d) >> 1, c2)
        dq1 = _clip1((((q2 + q0 + 1) >> 1) - q1 - big_d) >> 1, c2)

        nrow = use_normal & row_gate
        # select the DELTA (0 where no filter applies), then one add + one
        # clip2 per output: clip2(x + 0) == x for inputs in 0..top
        new_p[r][0] = _clip2(p0 + torch.where(use_strong, s0p, _select(nrow, big_d)), top)
        new_p[r][1] = _clip2(p1 + torch.where(use_strong, s1p, _select(nrow & cond5, dp1)), top)
        new_p[r][2] = _clip2(p2 + _select(use_strong, s2p), top)
        new_p[r][3] = p3
        new_q[r][0] = _clip2(q0 + torch.where(use_strong, s0q, _select(nrow, -big_d)), top)
        new_q[r][1] = _clip2(q1 + torch.where(use_strong, s1q, _select(nrow & cond6, dq1)), top)
        new_q[r][2] = _clip2(q2 + _select(use_strong, s2q), top)
        new_q[r][3] = q3
    return new_p, new_q


def chroma_edge_filter_planes(p, q, bs_mask, tc: int, top: int = MAX_PIXEL):
    """Chroma edge filter on nested-list planes (cpu.h:1431-1488).

    p, q: 4x2 nested lists [row][dist] of int32 or int16 batch tensors.  bs_mask:
    bool (*B) (True where BS == 2, cpu.h:463 -- chroma gates on equality,
    unlike luma's `> 0`).  Only distance-0 entries change.  The P/Q delta
    asymmetry of the reference (delta_q computed with operands swapped then
    *subtracted*, cpu.h:1453-1461, 1475-1476) is replicated exactly: a floor
    shift of a negative number is not symmetric, so dq != -dp.  tc is scaled
    to the samples' bit depth and top is their largest value, as in
    luma_edge_filter_planes.
    """
    tc = int(tc)
    new_p = [[None, p[r][1]] for r in range(4)]
    new_q = [[None, q[r][1]] for r in range(4)]
    for r in range(4):
        p0, p1 = p[r]
        q0, q1 = q[r]
        dp = _clip1((4 * (p0 - q0) + p1 - q1 + 4) >> 3, tc)  # cpu.h:1453, 1464
        dq = _clip1((4 * (q0 - p0) + q1 - p1 + 4) >> 3, tc)  # cpu.h:1458, 1469
        new_p[r][0] = _clip2(p0 + _select(bs_mask, dp), top)
        new_q[r][0] = _clip2(q0 - _select(bs_mask, dq), top)
    return new_p, new_q


# ---------------------------------------------------------------------------
# Array-shaped wrappers (tests / external callers)
# ---------------------------------------------------------------------------

def _as_planes(x, nj, dtype):
    return [[x[r, j].to(dtype) for j in range(nj)] for r in range(4)]


def _stack(planes):
    return torch.stack([torch.stack(row) for row in planes])


def luma_segment_decisions(p, q, beta: int, tc: int, dtype=torch.int32):
    """Per-segment filter decisions from rows 0 and 3 (cpu.h:1074-1114).

    p, q: (4, 4, *B) integer tensors, computed in `dtype`.  Returns
    (cond1, strong).
    """
    pl, ql = _as_planes(p, 4, dtype), _as_planes(q, 4, dtype)
    dp0, dp3 = _second_deriv(pl[0]), _second_deriv(pl[3])
    dq0, dq3 = _second_deriv(ql[0]), _second_deriv(ql[3])
    cond1 = (dp0 + dp3 + dq0 + dq3) < beta
    beta8 = beta // 8
    cond2 = ((dp0 + dq0) < beta8) & ((dp3 + dq3) < beta8)
    cond3 = ((torch.abs(pl[0][3] - pl[0][0]) + torch.abs(ql[0][0] - ql[0][3])) < beta8) & (
        (torch.abs(pl[3][3] - pl[3][0]) + torch.abs(ql[3][0] - ql[3][3])) < beta8
    )
    tc52 = (5 * tc) // 2
    cond4 = (torch.abs(pl[0][0] - ql[0][0]) < tc52) & (torch.abs(pl[3][0] - ql[3][0]) < tc52)
    return cond1, cond2 & cond3 & cond4


def luma_edge_filter(p, q, bs_mask, beta: int, tc: int, dtype=torch.int32):
    """Array wrapper over luma_edge_filter_planes.

    p, q: integer (4 rows, 4 dists, *B); bs_mask: bool (*B).
    dtype: compute dtype.  int32 is the reference's C++ `int` math; int16
    gives the same bytes, because every intermediate fits: the largest
    magnitudes are the strong-filter numerators, |.| <= 6*255 + 2*255 +
    255 + 4 < 2**12, and 9*(q0-p0) - 3*(q1-p1) + 8, |.| <= 12*255 + 8 <
    2**12 (the JAX package's filters.py states the same bound).
    Returns (new_p, new_q) as `dtype` tensors of the same shapes;
    distance-3 pixels never change.
    """
    np_, nq_ = luma_edge_filter_planes(_as_planes(p, 4, dtype), _as_planes(q, 4, dtype),
                                       bs_mask, beta, tc)
    return _stack(np_), _stack(nq_)


def chroma_edge_filter(p, q, bs_mask, tc: int, dtype=torch.int32):
    """Array wrapper over chroma_edge_filter_planes.

    p, q: integer (4 rows, 2 dists, *B); bs_mask: bool (*B, True where
    BS == 2); computed in `dtype` (int32 or int16).  Only distance-0
    pixels change.
    """
    np_, nq_ = chroma_edge_filter_planes(_as_planes(p, 2, dtype), _as_planes(q, 2, dtype),
                                         bs_mask, tc)
    return _stack(np_), _stack(nq_)
