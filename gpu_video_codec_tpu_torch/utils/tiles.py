"""Tile-planes layout: extended plane (Hext, Wext) <-> (8, 8, By, Bx).

Every deblocking edge segment of the reference reads and writes only pixels
inside its own shifted 8x8 tile (cpu.h:146-447), so after regrouping the
plane into per-tile-coordinate planes T[r, c] of shape (By, Bx) the whole
filter is elementwise arithmetic between 64 such planes, and the deblock
kernel runs one thread per tile with coalesced loads along Bx.

Plain reshape / permute / pad on torch tensors (the transpose engine of
gpu_video_codec_tpu/utils/tiles.py).  permute returns a strided view: make
the result contiguous before handing it to the kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.tables import SAMPLE_BLOCK_SIZE


def split_covered(plane):
    """Split (.., H, W) into the tile-swept region and a paste-back closure.

    Quirk Q9: the reference's chroma pointer arithmetic uses
    `num_chroma_blocks_x * 8` as the row stride (cpu.h:469-471 et al.)
    instead of the plane's actual `_new_chroma_width`.  When the extended
    chroma width is not a multiple of 8 (w % 16 == 8) the filter therefore
    operates on a *sheared* reinterpretation of the buffer: the first
    (8*ncby)*(8*ncbx) bytes of the flat plane viewed as an (8*ncby, 8*ncbx)
    row-major image.  When the extended width IS a multiple of 8 the view
    degenerates to the first 8*ncby true rows.

    Tile counts come from truncating division (cpu.h:141-142, 450-451).
    Returns (core, paste): `core` is the (.., 8*ncby, 8*ncbx) tile-swept
    view; `paste(filtered_core)` rebuilds the full (.., H, W) plane with the
    untouched flat remainder reattached.
    """
    b = SAMPLE_BLOCK_SIZE
    h, w = plane.shape[-2], plane.shape[-1]
    ncby, ncbx = h // b, w // b
    vh, vw = ncby * b, ncbx * b
    lead = plane.shape[:-2]
    flat = plane.reshape(*lead, h * w)
    core = flat[..., : vh * vw].reshape(*lead, vh, vw)

    def paste(out_core):
        out_flat = out_core.reshape(*lead, vh * vw)
        if vh * vw != h * w:
            out_flat = torch.cat([out_flat, flat[..., vh * vw :]], dim=-1)
        return out_flat.reshape(*lead, h, w)

    return core, paste


def split_covered_data(plane):
    """split_covered returning (core, remainder) tensors instead of a
    closure: `remainder` is the untouched flat tail of the plane."""
    core, _ = split_covered(plane)
    lead = plane.shape[:-2]
    h, w = plane.shape[-2], plane.shape[-1]
    vh, vw = core.shape[-2], core.shape[-1]
    rem = plane.reshape(*lead, h * w)[..., vh * vw :]
    return core, rem


def join_covered(core, rem, h: int, w: int):
    """Inverse of split_covered_data: rebuild the (.., h, w) plane from the
    filtered core and the untouched flat remainder."""
    lead = core.shape[:-2]
    flat = core.reshape(*lead, core.shape[-2] * core.shape[-1])
    if rem.shape[-1]:
        flat = torch.cat([flat, rem], dim=-1)
    return flat.reshape(*lead, h, w)


def plane_to_tiles(plane):
    """(.., Hext, Wext) -> (.., 8, 8, By, Bx) strided view;
    T[.., r, c, by, bx] == plane[.., 8by+r, 8bx+c]."""
    b = SAMPLE_BLOCK_SIZE
    *lead, h, w = plane.shape
    if h % b or w % b:
        raise ValueError(f"extended plane dims must be multiples of {b}, got {h}x{w}")
    n = len(lead)
    t = plane.reshape(*lead, h // b, b, w // b, b)
    # (.., By, r, Bx, c) -> (.., r, c, By, Bx)
    return t.permute(*range(n), n + 1, n + 3, n + 0, n + 2)


def tiles_to_plane(tiles):
    """(.., 8, 8, By, Bx) -> (.., Hext, Wext). Inverse of plane_to_tiles."""
    b = SAMPLE_BLOCK_SIZE
    *lead, r, c, by, bx = tiles.shape
    if r != b or c != b:
        raise ValueError(f"expected leading tile dims ({b},{b}), got ({r},{c})")
    n = len(lead)
    # (.., r, c, By, Bx) -> (.., By, r, Bx, c)
    t = tiles.permute(*range(n), n + 2, n + 0, n + 3, n + 1)
    return t.reshape(*lead, by * b, bx * b)


def interior_to_tiles(plane, pad: int, *, bx_grid: int | None = None,
                      by_grid: int | None = None):
    """(.., h, w) INTERIOR plane -> (.., 8, 8, by_grid, bx_grid) tile-planes
    of the zero-extended plane (Q6 defined-zero padding, cpu.h:55-82), with
    the tile grid optionally padded to (by_grid, bx_grid) by no-op tiles
    (zero pixels).

    Tile rows count by truncating division, (h + 2*pad) // 8 -- for luma
    (h % 8 == 0) that covers the full extended plane; for chroma with
    h % 8 == 4 (1080p) it is the Q9 COVERED row count (the dropped bottom
    rows are padding that the covered sweep never touches, cpu.h:450-451).
    Requires the extended width to be 8-aligned (the non-sheared Q9 case).
    The result is a strided view of a fresh padded copy."""
    *lead, h, w = plane.shape
    b = SAMPLE_BLOCK_SIZE
    bx = (w + 2 * pad) // b
    by = (h + 2 * pad) // b
    bxg = bx if bx_grid is None else bx_grid
    byg = by if by_grid is None else by_grid
    if byg < by:
        raise ValueError(f"by_grid {byg} < tile rows {by}")
    if bxg < bx:
        raise ValueError(f"bx_grid {bxg} < tile columns {bx}")
    if pad + h > b * by:
        raise ValueError(f"interior rows [{pad}, {pad + h}) exceed covered rows {b * by}")
    bot = b * byg - pad - h  # bottom zero rows: Q6 padding (clipped to the
    #                          covered extent) + grid-padding tile rows
    t = plane_to_tiles(F.pad(plane, (pad, pad, pad, bot)))
    if bxg > bx:
        t = F.pad(t, (0, bxg - bx))
    return t


def tiles_to_interior(tiles, pad: int, h: int, w: int):
    """(.., 8, 8, By, bx_grid) tile-planes -> (.., h, w) interior of the
    extended plane (the written-back region, cpu.h:995-1018).  Grid tiles
    past the extended plane's (By, Bx) are ignored."""
    b = SAMPLE_BLOCK_SIZE
    bx = (w + 2 * pad) // b
    by = (h + 2 * pad) // b
    full = tiles_to_plane(tiles[..., :by, :bx])
    return full[..., pad : pad + h, pad : pad + w]
