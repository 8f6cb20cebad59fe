"""The tile chain, T2 -> K1 or K1c -> T3, and the table of its kernels.

KERNELS maps a backend to T2, T3, T4 (ops/relayout_kernel.py) and K1/K1c
(ops/cuda_kernel.deblock_tiles_cuda), each with the CUDA wrapper's
signature: "cuda" to the wrappers, which run their plain versions on CPU
tensors, and "torch" to the plain versions on any device.  It is the one
place of the package that maps a backend name to them.

tile_chain runs planes of one shape through the chain, and alone decides
whether T2 and T3 take the flat (Q9) view of the extended plane and carry
its flat tail.  Its callers: the streaming step where K2's guard fails
(models/streaming.py), deblock_frame_cuda below (and with it
DeblockPipeline's cuda backend), DeblockPipeline.batch and the mesh's
slabs (parallel/mesh.py).  The resident path (models/resident.py) takes
the chain's stages apart, from KERNELS.
"""

from __future__ import annotations

import math

import torch

from .cuda_kernel import deblock_tiles_cuda
from .deblock import deblock_tiles_plain
from .relayout_kernel import (
    flat_tail_plain, flat_view, pack_yv12_cuda, pack_yv12_plain, plane_to_tiles_cuda,
    plane_to_tiles_plain, tail_holds_interior, tiles_to_plane_cuda, tiles_to_plane_plain,
)
from .tables import SAMPLE_BLOCK_SIZE as _B


def _plane_to_tiles_plain(x, pad, *, out=None, flat=False, rem_out=None):
    if rem_out is not None:
        rem_out.copy_(flat_tail_plain(x, pad))
    tiles = plane_to_tiles_plain(x, pad, flat=flat)
    return tiles if out is None else out.copy_(tiles)


def _tiles_to_plane_plain(tiles, pad, h, w, *, out=None, flat=False, rem=None):
    plane = tiles_to_plane_plain(tiles, pad, h, w, flat, rem, out)
    return plane if out is None else out.copy_(plane)


def _deblock_plain(tiles, *operands, chroma, block_bx, dtype=torch.int32):
    return deblock_tiles_plain(tiles, *operands, chroma=chroma, dtype=dtype)


# backend -> (T2, T3, T4, K1/K1c)
KERNELS = {
    "cuda": (plane_to_tiles_cuda, tiles_to_plane_cuda, pack_yv12_cuda, deblock_tiles_cuda),
    "torch": (_plane_to_tiles_plain, _tiles_to_plane_plain, pack_yv12_plain, _deblock_plain),
}


def tile_chain(planes, maps, beta, tc, *, pad, chroma, backend="cuda", out=None,
               block_bx=None, dtype=torch.int32):
    """Deblock uint8 planes of one (h, w) through one tile stack: one T2 per
    plane into the stack (the plane zero-extended by `pad`, Q6), one K1
    launch over the whole stack (K1c with chroma=True) with the four (By,
    Bx) maps shared by every plane, and one T3 per plane back.

    planes: a sequence of (.., h, w) tensors, each with up to two leading
    axes of its own, on one device.  out: None, or a sequence of one
    destination per plane, of its shape (any strides, last axis
    contiguous; the plane itself for in place), or None for a new plane.
    Returns the list of filtered planes.  block_bx and dtype are
    deblock_tiles_cuda's.

    Where the extended plane's tile rows cannot hold it (quirk Q9: an
    extended width not 8-aligned, or interior rows past the covered tile
    rows), T2 and T3 take its flat view; where that view's flat tail holds
    interior pixels and T3 does not write back into the planes it read,
    T2 copies the tail out and T3 writes it back."""
    t2, t3, _, deblock = KERNELS[backend]
    h, w = planes[0].shape[-2:]
    flat = (w + 2 * pad) % _B != 0 or pad + h > _B * ((h + 2 * pad) // _B)
    inplace = out is not None and all(o is x for o, x in zip(out, planes))
    carry_tail = flat and not inplace and tail_holds_interior(h, w, pad)
    counts = [math.prod(x.shape[:-2]) for x in planes]
    dev = planes[0].device
    stack = torch.empty((sum(counts), _B, _B, (h + 2 * pad) // _B, (w + 2 * pad) // _B),
                        dtype=torch.uint8, device=dev)

    def per_plane(t):  # t's rows as one tensor per plane, with its leading axes
        return [r.reshape(*x.shape[:-2], *t.shape[1:]) for r, x in zip(t.split(counts), planes)]

    rems = (per_plane(torch.empty((len(stack), flat_view(h, w, pad)[2]), dtype=torch.uint8,
                                  device=dev)) if carry_tail else [None] * len(planes))
    for x, t, r in zip(planes, per_plane(stack), rems):
        t2(x, pad, out=t, flat=flat, rem_out=r)
    done = deblock(stack, *(m[None] for m in maps), beta, tc, chroma=chroma, block_bx=block_bx,
                   dtype=dtype)
    return [t3(t, pad, h, w, out=o, flat=flat, rem=r)
            for t, o, r in zip(per_plane(done), out or [None] * len(planes), rems, strict=True)]


def deblock_frame_cuda(y_ext, u_ext, v_ext, luma_maps, chroma_maps, beta, tc,
                       luma_only: bool = False, luma_block: int | None = None,
                       chroma_block: int | None = None, dtype=torch.int32):
    """Full-frame deblock of extended planes through the kernels (pad 0):
    one chain for luma (T2, K1, T3) and one for U and V together (T2 and T3
    per plane, one K1c; tile_chain), new planes out.  dtype=torch.int16
    runs K1-i16 for both (the same bytes as the default torch.int32).
    luma_block/chroma_block: deblock_tiles_cuda's block_bx (default: its
    own for the dtype).  On CPU tensors the wrappers' plain versions."""
    (y,) = tile_chain([y_ext], luma_maps, beta, tc, pad=0, chroma=False, block_bx=luma_block,
                      dtype=dtype)
    if luma_only:
        return y, u_ext, v_ext
    u, v = tile_chain([u_ext, v_ext], chroma_maps, beta, tc, pad=0, chroma=True,
                      block_bx=chroma_block, dtype=dtype)
    return y, u, v
