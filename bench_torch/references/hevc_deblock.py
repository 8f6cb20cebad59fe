"""Plain PyTorch reference of the reference deblocker's semantics.

HEVC in-loop deblocking of 4:2:0 frames as the reference CPU
implementation (RomanKazantsev/gpu_video_codec,
hevc_deblocking_filter_cpu.h) defines it for 8-bit samples, written from
that file's description alone, vectorised over every tile of a batch of
frames.  It imports nothing of the program under test and takes nothing
it made.

What it computes, per frame and per plane:
  * the plane is zero-extended by 4 samples on every side (padding is 0)
    and cut into 8x8 tiles whose centres sit on the corners of the 8x8
    block grid, so each tile holds one vertical and one horizontal edge
    crossing at its middle;
  * four segment phases run in this order within every tile: upper
    vertical (rows 0-3 across cols 3|4), lower vertical (rows 4-7), left
    horizontal (cols 0-3 across rows 3|4), right horizontal (cols 4-7 for
    P but cols 0-3 for Q: the reference's column mismatch);
  * each segment is gated by its boundary strength (BS), read from the
    flat BS arrays by the reference's index arithmetic, a read outside an
    array reading 0; luma filters where BS > 0, chroma where BS == 2, and
    chroma gates segment existence with the LUMA tile counts;
  * luma: decision (1) on rows 0 and 3, then the strong filter (three
    samples a side) or the normal filter (a per-row |delta0| < 10 tc gate,
    side samples under their own gates); chroma: the one-sample filter;
  * chroma is swept over the flat buffer of the extended plane viewed as
    (8 ncby, 8 ncbx) rows, sheared where its width is not a multiple of 8;
  * all arithmetic is 32-bit with right shifts that round toward minus
    infinity.

Bit depth.  The reference project filters 8-bit samples only.  At
`bit_depth` 10 (HEVC Main 10; frames int16, samples in [0, 1023]) this
module departs from it only as H.265's edge filtering (8.7.2.5) does for
BitDepth > 8: beta = beta' * 2^(bd - 8) and tc = tc' * 2^(bd - 8), beta'
and tc' the tables' values at the frame's QP, for luma and for chroma
alike, and every filtered sample is clipped (Clip1) to [0, 2^bd - 1] in
place of [0, 255].  Every threshold derived from beta and tc (beta/8, 3 beta/16,
5 tc/2, 10 tc, the clamps at 2 tc and tc/2) follows from the scaled
values.  The segment order, the column mismatch, the chroma gate by the
luma tile counts, the sheared chroma sweep and the floor shifts are those
above.  Output keeps the input's dtype.  At bit_depth 8 nothing changes.

Chroma format.  The reference project filters 4:2:0 frames only.  At
`chroma_format` "4:2:2" (HEVC's format range extensions, e.g. Main 4:2:2
10) each chroma plane is (h, w/2), H.265's SubWidthC 2 and SubHeightC 1,
and the packed frame (2h, w) rows: luma, then U, then V.  At "4:4:4"
(Main 4:4:4, Main 4:4:4 10) each chroma plane is (h, w), SubWidthC and
SubHeightC 1, and the packed frame (3h, w) rows.  Each chroma plane of
either is filtered exactly as a 4:2:0 plane is above: edges on the
plane's own 8x8 grid (so horizontal chroma edges fall every 8 luma rows,
not 16, and at 4:4:4 vertical ones every 8 luma columns too), the
one-sample filter where BS == 2, the flat chroma BS arrays read at the
plane's width (w/2, or w at 4:4:4), the segment order, the column
mismatch, the sheared sweep, the floor shifts, and the gate by the luma
tile counts (h/8 + 1, w/8 + 1), at 4:4:4 the plane's own tile counts.
Chroma tc stays the table's tc' at the frame's QP, scaled at 10 bits: for
ChromaArrayType other than 1 H.265 (8.7.2.5.5 since the range extensions)
sets QpC = Min(qPi, 51) with no Table 8-10 lookup, and one QP a frame
needs no mapping.  Any other format raises ValueError.  At "4:2:0"
nothing changes.

`shift="trunc"` replaces every right shift by a division that rounds
toward zero: the control, which breaks the stated arithmetic guarantee.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

B = 8
HALF = 4

# QP 0..51 (cpu.h beta_table and tc_table); QP above 51 reads QP 51
BETA = (0,) * 16 + (6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24,
                    26, 28, 30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56,
                    58, 60, 62, 64)
TC = (0,) * 18 + (1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3,
                  3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 13,
                  14, 16, 18, 20)

# chroma_format -> (SubWidthC, SubHeightC), H.265 Table 6-1
CHROMA_SUBSAMPLING = {"4:2:0": (2, 2), "4:2:2": (2, 1), "4:4:4": (1, 1)}

# (P, Q) sample of filter row r at edge distance j, as (tile row, tile col)
_PHASES = (
    (lambda r, j: (r, 3 - j), lambda r, j: (r, 4 + j)),            # upper vertical
    (lambda r, j: (4 + r, 3 - j), lambda r, j: (4 + r, 4 + j)),    # lower vertical
    (lambda r, j: (3 - j, r), lambda r, j: (4 + j, r)),            # left horizontal
    (lambda r, j: (3 - j, 4 + r), lambda r, j: (4 + j, r)),        # right horizontal
)


def beta_tc(qp: int, bit_depth: int = 8) -> tuple[int, int]:
    """(beta, tc) at the QP, scaled by 2^(bit_depth - 8) as H.265 does."""
    q = min(int(qp), 51)
    s = 1 << (int(bit_depth) - 8)
    return BETA[q] * s, TC[q] * s


def max_pixel(bit_depth: int = 8) -> int:
    return (1 << int(bit_depth)) - 1


def _shifter(shift: str):
    if shift == "floor":
        return lambda x, k: x >> k
    if shift == "trunc":
        return lambda x, k: torch.div(x, 1 << k, rounding_mode="trunc")
    raise ValueError(f"shift must be 'floor' or 'trunc', got {shift!r}")


def _flat_index(at, nj: int, device) -> torch.Tensor:
    return torch.tensor([[at(r, j)[0] * B + at(r, j)[1] for j in range(nj)] for r in range(4)],
                        dtype=torch.long, device=device)


def gates(flat_vert, flat_hor, lookup_w: int, ny: int, nx: int, gate_ny: int, gate_nx: int,
          chroma: bool, device) -> torch.Tensor:
    """(4, ny, nx) bool: whether each tile's four segments filter, in phase
    order, from the flat BS arrays by the reference's index arithmetic."""
    sv, sh = lookup_w // B + 1, lookup_w // B
    by = torch.arange(ny, device=device)[:, None]
    bx = torch.arange(nx, device=device)[None, :]
    fv = torch.as_tensor(flat_vert, device=device).to(torch.int32).reshape(-1)
    fh = torch.as_tensor(flat_hor, device=device).to(torch.int32).reshape(-1)

    def read(flat, idx, valid):
        if flat.numel() == 0:
            return torch.zeros(idx.shape, dtype=torch.int32, device=device)
        ok = valid & (idx >= 0) & (idx < flat.numel())
        return torch.where(ok, flat[idx.clamp(0, flat.numel() - 1)], 0)

    bs = torch.stack([
        read(fv, (by - 1) * sv + bx, by > 0),
        read(fv, by * sv + bx, by < gate_ny - 1),
        read(fh, by * sh + (bx - 1), bx > 0),
        read(fh, by * sh + bx, bx < gate_nx - 1),
    ])
    return bs == 2 if chroma else bs > 0


def _luma(p, q, beta: int, tc: int, shr, top: int):
    """p, q: (..., 4 rows, 4 distances) int32 -> new (..., 4, 3) each."""
    def second(x, r):
        return (x[..., r, 2] - 2 * x[..., r, 1] + x[..., r, 0]).abs()

    dp0, dp3, dq0, dq3 = second(p, 0), second(p, 3), second(q, 0), second(q, 3)
    on = (dp0 + dp3 + dq0 + dq3) < beta
    b8, c = beta // 8, 2 * tc
    strong = ((dp0 + dq0) < b8) & ((dp3 + dq3) < b8)
    for r in (0, 3):
        strong &= ((p[..., r, 3] - p[..., r, 0]).abs() + (q[..., r, 0] - q[..., r, 3]).abs()) < b8
        strong &= (p[..., r, 0] - q[..., r, 0]).abs() < (5 * tc) // 2

    def strong_side(x, y):
        x0, x1, x2, x3 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
        y0, y1 = y[..., 0], y[..., 1]
        d0 = shr(x2 + 2 * x1 - 6 * x0 + 2 * y0 + y1 + 4, 3).clamp(-c, c)
        d1 = shr(x2 - 3 * x1 + x0 + y0 + 2, 2).clamp(-c, c)
        d2 = shr(2 * x3 - 5 * x2 + x1 + x0 + y0 + 4, 3).clamp(-c, c)
        return torch.stack([(x0 + d0).clamp(0, top), (x1 + d1).clamp(0, top),
                            (x2 + d2).clamp(0, top)], dim=-1)

    sp, sq = strong_side(p, q), strong_side(q, p)

    c2, t3 = tc // 2, (3 * beta) // 16
    side_p = ((dp0 + dp3) < t3)[..., None]
    side_q = ((dq0 + dq3) < t3)[..., None]
    p0, p1, p2 = p[..., 0], p[..., 1], p[..., 2]
    q0, q1, q2 = q[..., 0], q[..., 1], q[..., 2]
    delta0 = shr(9 * (q0 - p0) - 3 * (q1 - p1) + 8, 4)
    row = delta0.abs() < 10 * tc
    d = delta0.clamp(-c, c)
    dp1 = shr(shr(p2 + p0 + 1, 1) - p1 + d, 1).clamp(-c2, c2)
    dq1 = shr(shr(q2 + q0 + 1, 1) - q1 - d, 1).clamp(-c2, c2)
    np_ = torch.stack([torch.where(row, (p0 + d).clamp(0, top), p0),
                       torch.where(row & side_p, (p1 + dp1).clamp(0, top), p1), p2], dim=-1)
    nq_ = torch.stack([torch.where(row, (q0 - d).clamp(0, top), q0),
                       torch.where(row & side_q, (q1 + dq1).clamp(0, top), q1), q2], dim=-1)

    keep = (~on)[..., None, None]
    strong = strong[..., None, None]
    return (torch.where(keep, p[..., :3], torch.where(strong, sp, np_)),
            torch.where(keep, q[..., :3], torch.where(strong, sq, nq_)))


def _chroma(p, q, tc: int, shr, top: int):
    """p, q: (..., 4 rows, 2 distances) int32 -> new (..., 4, 1) each."""
    p0, p1, q0, q1 = p[..., 0], p[..., 1], q[..., 0], q[..., 1]
    dp = shr((p0 - q0) * 4 + p1 - q1 + 4, 3).clamp(-tc, tc)
    dq = shr((q0 - p0) * 4 + q1 - p1 + 4, 3).clamp(-tc, tc)
    return (p0 + dp).clamp(0, top)[..., None], (q0 - dq).clamp(0, top)[..., None]


def deblock_tiles(tiles, gate, beta: int, tc: int, chroma: bool, shift: str = "floor",
                  top: int = 255):
    """Filter tiles (N, ny, nx, 64) int32 in place; gate (4, ny, nx) bool;
    filtered samples are clipped to [0, top]."""
    shr = _shifter(shift)
    nj, touched = (2, 1) if chroma else (4, 3)
    for k, (p_at, q_at) in enumerate(_PHASES):
        pi, qi = _flat_index(p_at, nj, tiles.device), _flat_index(q_at, nj, tiles.device)
        p, q = tiles[..., pi], tiles[..., qi]
        if chroma:
            np_, nq_ = _chroma(p, q, tc, shr, top)
        else:
            np_, nq_ = _luma(p, q, beta, tc, shr, top)
        g = gate[k][None, :, :, None, None]
        tiles[..., pi[:, :touched]] = torch.where(g, np_, p[..., :touched])
        tiles[..., qi[:, :touched]] = torch.where(g, nq_, q[..., :touched])
    return tiles


def _to_tiles(core):
    n, hh, ww = core.shape
    t = core.reshape(n, hh // B, B, ww // B, B).permute(0, 1, 3, 2, 4)
    return t.reshape(n, hh // B, ww // B, B * B).to(torch.int32)


def _from_tiles(tiles):
    n, ny, nx, _ = tiles.shape
    return tiles.reshape(n, ny, nx, B, B).permute(0, 1, 3, 2, 4).reshape(n, ny * B, nx * B)


def _luma_plane(y, bs, beta, tc, shift, top):
    n, h, w = y.shape
    ext = F.pad(y.to(torch.int32), (HALF, HALF, HALF, HALF))
    ny, nx = h // B + 1, w // B + 1
    g = gates(bs["vert"], bs["hor"], w, ny, nx, ny, nx, False, y.device)
    out = _from_tiles(deblock_tiles(_to_tiles(ext), g, beta, tc, False, shift, top))
    return out[:, HALF : HALF + h, HALF : HALF + w].to(y.dtype)


def _chroma_plane(c, bs, luma_n, beta, tc, shift, top):
    n, ch, cw = c.shape
    ext = F.pad(c.to(torch.int32), (HALF, HALF, HALF, HALF))
    he, we = ext.shape[1:]
    ncby, ncbx = he // B, we // B
    flat = ext.reshape(n, -1)
    core = flat[:, : ncby * B * ncbx * B].reshape(n, ncby * B, ncbx * B)
    g = gates(bs["chroma_vert"], bs["chroma_hor"], cw, ncby, ncbx, *luma_n, True, c.device)
    swept = _from_tiles(deblock_tiles(_to_tiles(core), g, 0, tc, True, shift, top))
    flat = torch.cat([swept.reshape(n, -1), flat[:, ncby * B * ncbx * B :]], dim=1)
    return flat.reshape(n, he, we)[:, HALF : HALF + ch, HALF : HALF + cw].to(c.dtype)


def deblock_packed(frames, width: int, height: int, qp: int, bs: dict, shift: str = "floor",
                   bit_depth: int = 8, chroma_format: str = "4:2:0"):
    """Packed frames (N, h + 2 ch cw / w, w) -> filtered frames, new, of the
    input's dtype: uint8 at bit_depth 8, int16 at 10 (see the module's
    docstring for what the bit depth and the chroma format change).

    Rows [0, h) are luma; the rows after them hold the two chroma planes
    one after the other, each (ch, cw): (h/2, w/2) at chroma_format
    "4:2:0" (packed YV12, 3h/2 rows), (h, w/2) at "4:2:2" (2h rows), (h, w)
    at "4:4:4" (3h rows).  bs:
    the flat arrays "vert", "hor", "chroma_vert", "chroma_hor" that every
    frame of the batch shares."""
    if chroma_format not in CHROMA_SUBSAMPLING:
        raise ValueError(f"chroma_format must be one of {sorted(CHROMA_SUBSAMPLING)}, "
                         f"got {chroma_format!r}")
    w, h = width, height
    sub_w, sub_h = CHROMA_SUBSAMPLING[chroma_format]
    ch, cw = h // sub_h, w // sub_w
    beta, tc = beta_tc(qp, bit_depth)
    top = max_pixel(bit_depth)
    n = frames.shape[0]
    out = torch.empty_like(frames)
    out[:, :h] = _luma_plane(frames[:, :h], bs, beta, tc, shift, top)
    chroma = frames[:, h:].reshape(n, 2, ch, cw)
    luma_n = (h // B + 1, w // B + 1)
    filtered = [_chroma_plane(chroma[:, i], bs, luma_n, beta, tc, shift, top) for i in range(2)]
    out[:, h:] = torch.stack(filtered, dim=1).reshape(n, -1, w)
    return out
