"""Whole-frame deblocking over the tile-planes layout, in plain PyTorch.

The counterpart of gpu_video_codec_tpu/ops/deblock.py, and the plain
version of the deblock kernels (ops/cuda_kernel.py, ops/swar_kernel.py,
csrc/): four phases of elementwise int32 (or, with dtype=torch.int16,
int16) ops on (*B)-shaped tile planes.

  1. upper-vertical  edges: filter rows 0-3 across tile cols 3|4
  2. lower-vertical  edges: filter rows 4-7 across tile cols 3|4
  3. left-horizontal edges: filter cols 0-3 across tile rows 3|4 (transposed)
  4. right-horizontal edges: cols 4-7, with the reference's P/Q column
     mismatch (quirk Q3, cpu.h:383-433): P comes from cols 4-7 but Q from
     cols 0-3.

Phase order is load-bearing (quirk Q7): the horizontal phases read pixels the
vertical phases wrote, and phase 4 reads Q pixels phase 3 wrote.  Every
segment is confined to its own tile, so each phase is a parallel map over
the whole tile grid.

Segment geometry (r = filter row 0-3, j = distance from the edge, T[a, b]
the (*B) plane of tile-local pixel (a, b)):

  upper-vert  p[r][j] = T[r,     3-j]   q[r][j] = T[r,     4+j]   (cpu.h:169-207)
  lower-vert  p[r][j] = T[4+r,   3-j]   q[r][j] = T[4+r,   4+j]   (cpu.h:233-271)
  left-hor    p[r][j] = T[3-j,   r  ]   q[r][j] = T[4+j,   r  ]   (cpu.h:302-364)
  right-hor   p[r][j] = T[3-j, 4+r  ]   q[r][j] = T[4+j,   r  ]   (cpu.h:383-445, Q3)
"""

from __future__ import annotations

import torch

from .filters import chroma_edge_filter_planes, luma_edge_filter_planes
from .tables import HALF_BLOCK, MAX_PIXEL, max_pixel, scale_thresholds
from ..utils.tiles import (
    interior_to_tiles, plane_to_tiles, split_covered, tiles_to_interior, tiles_to_plane,
)

# (p_coords, q_coords) per phase; entries are (tile_row, tile_col) as a
# function of filter row r and edge distance j.
_SEGMENT_GEOMETRY = {
    "upper_vert": (lambda r, j: (r, 3 - j), lambda r, j: (r, 4 + j)),
    "lower_vert": (lambda r, j: (4 + r, 3 - j), lambda r, j: (4 + r, 4 + j)),
    "left_hor": (lambda r, j: (3 - j, r), lambda r, j: (4 + j, r)),
    "right_hor": (lambda r, j: (3 - j, 4 + r), lambda r, j: (4 + j, r)),
}
_PHASE_ORDER = ("upper_vert", "lower_vert", "left_hor", "right_hor")


def _apply_phase(planes, phase, bs_mask, beta, tc, chroma, top=MAX_PIXEL):
    """Run one edge phase on the 8x8 list of (*B) planes, replacing the
    entries it changes (luma: distances 0-2; chroma: distance 0), clipped
    to [0, top]."""
    p_at, q_at = _SEGMENT_GEOMETRY[phase]
    nj = 2 if chroma else 4
    p = [[planes[p_at(r, j)[0]][p_at(r, j)[1]] for j in range(nj)] for r in range(4)]
    q = [[planes[q_at(r, j)[0]][q_at(r, j)[1]] for j in range(nj)] for r in range(4)]
    if chroma:
        new_p, new_q = chroma_edge_filter_planes(p, q, bs_mask, tc, top)
        touched = 1
    else:
        new_p, new_q = luma_edge_filter_planes(p, q, bs_mask, beta, tc, top)
        touched = 3
    for r in range(4):
        for j in range(touched):
            pr, pc = p_at(r, j)
            planes[pr][pc] = new_p[r][j]
            qr, qc = q_at(r, j)
            planes[qr][qc] = new_q[r][j]


def deblock_planes_core(planes, bs_maps, beta: int, tc: int, chroma: bool = False,
                        dtype=torch.int32, top: int = MAX_PIXEL):
    """Four-phase sweep on an 8x8 list-of-lists of (*B) planes of the
    compute dtype `dtype` (int32 or int16; the filters compute in the
    planes' dtype).  Mutates and returns `planes`.  The BS gate is `> 0`
    for luma and `== 2` for chroma (cpu.h:164, 463).  beta and tc are
    scaled to the samples' bit depth; top is their largest value."""
    if any(x.dtype != dtype for row in planes for x in row):
        raise ValueError(f"planes must be {dtype}")
    for phase, bs in zip(_PHASE_ORDER, bs_maps):
        gate = (bs == 2) if chroma else (bs > 0)
        _apply_phase(planes, phase, gate, beta, tc, chroma, top)
    return planes


def deblock_tiles(tiles, bs_ver1, bs_ver2, bs_hor1, bs_hor2, beta: int, tc: int,
                  chroma: bool = False, dtype=torch.int32, bit_depth: int = 8):
    """Deblock a tile-planes tensor.

    tiles: (8, 8, *B) integer tensor, computed in `dtype` (torch.int32, or
    torch.int16 with the same bytes; uint8 arithmetic wraps, so the cast
    comes before any subtraction).  bs_*: BS value per tile segment,
    broadcastable to (*B) (see utils/bs.py).  beta, tc: the tables' ints
    at the QP.  bit_depth: 8, or 10 (samples in [0, 1023], e.g. int16
    tiles): beta and tc scaled by 2^(bit_depth - 8), samples clipped to
    [0, 2^bit_depth - 1] (ops/tables.py).
    chroma: use the 2-wide chroma filter and BS == 2 gate.
    Returns a new (8, 8, *B) tensor with the input's dtype.
    """
    if dtype not in (torch.int32, torch.int16):
        raise ValueError(f"dtype must be torch.int32 or torch.int16, got {dtype}")
    beta, tc = scale_thresholds(beta, tc, bit_depth)
    t = tiles.to(dtype)
    planes = [[t[r, c] for c in range(8)] for r in range(8)]
    deblock_planes_core(planes, (bs_ver1, bs_ver2, bs_hor1, bs_hor2), beta, tc, chroma,
                        dtype=dtype, top=max_pixel(bit_depth))
    return torch.stack([torch.stack(row) for row in planes]).to(tiles.dtype)


def deblock_tiles_plain(tiles, bs_ver1, bs_ver2, bs_hor1, bs_hor2, beta: int, tc: int,
                        chroma: bool = False, dtype=torch.int32):
    """The plain version of the deblock kernels, in the kernel's own forms:
    tiles (8, 8, By, Bx) with (By, Bx) maps, or batched tiles
    (NB, 8, 8, By, Bx) with (NB, By, Bx) per-frame or (1, By, Bx) shared
    maps.  Runs on any device; ops/cuda_kernel.deblock_tiles_cuda takes it
    for CPU tensors.  With dtype=torch.int16 it is K1-i16's plain version;
    it is also T1's (ops/swar_kernel.py), which computes the same function."""
    maps = (bs_ver1, bs_ver2, bs_hor1, bs_hor2)
    if tiles.dim() == 4:
        return deblock_tiles(tiles, *maps, beta, tc, chroma=chroma, dtype=dtype)
    # (NB, 8, 8, By, Bx) -> (8, 8, NB, By, Bx); (NB|1, By, Bx) maps broadcast
    out = deblock_tiles(tiles.permute(1, 2, 0, 3, 4), *maps, beta, tc, chroma=chroma,
                        dtype=dtype)
    return out.permute(2, 0, 1, 3, 4).contiguous()


def deblock_rows_plain(tiles_rows, bs_ver1, bs_ver2, bs_hor1, bs_hor2, beta: int, tc: int,
                       chroma: bool = False):
    """T5's plain version: the deblock of a tile grid held in the "rows"
    layout (By, 8, 8, Bx), element [by, r, c, bx] = pixel (r, c) of tile
    (by, bx) -- the free reshape of an (8*By, 8*Bx) row-major plane's
    (By, r, 8*Bx) view.  (By, Bx) maps.  Returns a new contiguous
    (By, 8, 8, Bx) tensor."""
    out = deblock_tiles(tiles_rows.permute(1, 2, 0, 3), bs_ver1, bs_ver2, bs_hor1, bs_hor2,
                        beta, tc, chroma=chroma)
    return out.permute(2, 0, 1, 3).contiguous()


def deblock_packed_plain(y, uv, luma_maps, chroma_maps, beta: int, tc: int,
                         luma_only: bool = False, bit_depth: int = 8):
    """K2's and K2-10's plain version (ops/cuda_kernel.deblock_packed_cuda):
    the packed step's chain of plain versions on the frames' planes --
    interior -> tile-planes of the zero-extended plane (T2's), the deblock
    (K1's, K1c's), tile-planes -> interior (T3's) -- for luma, and for U and
    V with one shared map.  y: (.., h, w), uv: (.., 2, ch, cw) interior
    planes, uint8 at bit_depth 8 and int16 at 10, (ch, cw) = (h/2, w/2) at
    4:2:0, (h, w/2) at 4:2:2 and (h, w) at 4:4:4 (every size is taken from
    the planes, so every format, and any width, take this one function);
    (By, Bx) and (cBy, cBx) maps,
    shared by the leading axes; beta, tc: the tables' at the QP
    (deblock_tiles scales them).  Returns new (y, uv), uv itself under
    luma_only."""
    p = HALF_BLOCK

    def step(x, maps, chroma):
        t = interior_to_tiles(x, p).movedim((-4, -3), (0, 1))  # (8, 8, .., By, Bx)
        out = deblock_tiles(t, *maps, beta, tc, chroma=chroma,
                            bit_depth=bit_depth).movedim((0, 1), (-4, -3))
        return tiles_to_interior(out, p, *x.shape[-2:]).contiguous()

    y_out = step(y, luma_maps, False)
    return y_out, uv if luma_only else step(uv, chroma_maps, True)


def deblock_plane(ext_plane, bs_maps, beta: int, tc: int, chroma: bool = False,
                  dtype=torch.int32, bit_depth: int = 8):
    """Deblock one extended plane (.., Hext, Wext) given its four (By, Bx) BS maps.

    Leading batch axes (e.g. the stacked {U, V} pair) are folded into the
    tile-grid batch; BS maps broadcast across them.  The plane is swept
    through the reference's flat (8*ncby, 8*ncbx) view (quirk Q9,
    utils/tiles.split_covered): sheared when the extended width is not a
    multiple of 8, with the flat remainder passing through untouched.
    """
    core, paste = split_covered(ext_plane)
    tiles = plane_to_tiles(core)  # (*lead, 8, 8, By, Bx)
    nlead = tiles.dim() - 4
    if nlead:
        # -> (8, 8, *lead, By, Bx): deblock_tiles wants tile coords leading
        tiles = tiles.permute(nlead, nlead + 1, *range(nlead), nlead + 2, nlead + 3)
    out = deblock_tiles(tiles, *bs_maps, beta, tc, chroma=chroma, dtype=dtype,
                        bit_depth=bit_depth)
    if nlead:
        out = out.permute(*range(2, 2 + nlead), 0, 1, nlead + 2, nlead + 3)
    return paste(tiles_to_plane(out))


def deblock_frame(y_ext, u_ext, v_ext, luma_maps, chroma_maps, beta: int, tc: int,
                  luma_only: bool = False, dtype=torch.int32, bit_depth: int = 8):
    """Full-frame luma + chroma deblock on extended planes (uint8 in/out, or
    int16 at bit_depth 10: deblock_tiles), computed in `dtype` (torch.int32
    or torch.int16, the same bytes).

    Mirrors ReadYuvFrame::DeblockingFilter's luma -> U -> V sequence
    (cpu.h:134-993); U and V are independent so they are batched into one
    chroma call along a leading axis.
    """
    y_out = deblock_plane(y_ext, luma_maps, beta, tc, chroma=False, dtype=dtype,
                          bit_depth=bit_depth)
    if luma_only:
        return y_out, u_ext, v_ext
    uv_out = deblock_plane(torch.stack([u_ext, v_ext]), chroma_maps, beta, tc, chroma=True,
                           dtype=dtype, bit_depth=bit_depth)
    return y_out, uv_out[0], uv_out[1]
