"""The hand-written CUDA relayout and pack kernels: build, ctypes binding and
wrappers.

Counterpart of tools/kernel_relayout_exp.py (T2 fwd_inkernel, T3
inv_inkernel) and tools/pack_exp.py (T4 pack_pallas), the in-kernel
versions of the layout operations around the deblock kernel:

  plane_to_tiles_cuda  T2: (.., h, w) interior planes -> (.., 8, 8, By, Bx)
                       tile-planes of the zero-extended plane (the
                       streaming step; the resident ingest), or with
                       flat=True of its flat (Q9) view, the sheared chroma
                       sweep, and its flat tail
  tiles_to_plane_cuda  T3: the inverse (the streaming step, straight into
                       the frame buffer; the resident readback)
  pack_yv12_cuda       T4: Y, U, V planes -> one packed YV12 buffer (readback)

The kernels (csrc/relayout_kernel.cu over the index math of
csrc/relayout_tile.cuh) are built at first use with nvcc into a library of
their own beside the deblock kernel's (ops/cuda_kernel.py builds both the
same way).  Each wrapper checks its operands, launches on the current
stream and raises on any failure; on a CPU tensor it runs the plain
version instead (utils/tiles.py interior_to_tiles / tiles_to_interior,
split_covered_data / join_covered, torch.cat).  LAUNCHES counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_kernel as ck
from .tables import SAMPLE_BLOCK_SIZE
from ..utils.tiles import (
    interior_to_tiles, join_covered, plane_to_tiles, split_covered_data, tiles_to_interior,
    tiles_to_plane,
)

# Kernel launches per kernel since import (or since a caller reset them).
LAUNCHES = {"fwd": 0, "inv": 0, "pack": 0}

_SOURCES = ("relayout_kernel.cu",)
HOST_THREADS = 128  # relayout_tile.cuh kRelayoutThreads: the T2/T3 block size
_MAX_GRID_YZ = 65535
_ALIGN = 16  # T4 moves 16 bytes per thread
_INT32_MAX = 2**31 - 1  # offsets inside one plane or tile-planes block are 32-bit
_GEOM_ARGS = [ctypes.c_int] * 7 + [ctypes.c_longlong] * 8
_FLAT_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
_PACK_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_int] \
    + [ctypes.c_longlong] * 4


def build_library():
    """Build the relayout library with nvcc (no-op when already built).
    Returns (path, compiler output)."""
    return ck._build([ck._nvcc(_SOURCES), *ck.NVCC_FLAGS], _SOURCES, "libgvct_relayout")


def _setup_cuda(lib) -> None:
    for fn in (lib.gvct_plane_to_tiles, lib.gvct_tiles_to_plane):
        fn.argtypes = [ctypes.c_void_p] * 2 + _GEOM_ARGS + _FLAT_ARGS + [ctypes.c_int,
                                                                          ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.gvct_pack_yv12.argtypes = _PACK_ARGS + [ctypes.c_int, ctypes.c_void_p]
    lib.gvct_pack_yv12.restype = ctypes.c_int
    lib.gvct_error_string.argtypes = [ctypes.c_int]
    lib.gvct_error_string.restype = ctypes.c_char_p


def load_host_library() -> ctypes.CDLL:
    """The g++ build of csrc/host_shim.cpp (ops/cuda_kernel.load_host_library)
    with the relayout kernels' block loops bound: gvct_host_relayout (T2 and
    T3 on the rows view; its first argument is the thread count, 1 or
    HOST_THREADS), gvct_host_relayout_flat (the same with the kernels' flat
    and tail arguments, _flat_args), gvct_host_pack_yv12 (T4) and
    gvct_host_covered_tiles."""
    lib = ck.load_host_library()
    lib.gvct_host_relayout.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + _GEOM_ARGS
    lib.gvct_host_relayout.restype = ctypes.c_int
    lib.gvct_host_relayout_flat.argtypes = lib.gvct_host_relayout.argtypes + _FLAT_ARGS
    lib.gvct_host_relayout_flat.restype = ctypes.c_int
    lib.gvct_host_pack_yv12.argtypes = _PACK_ARGS
    lib.gvct_host_pack_yv12.restype = None
    lib.gvct_host_covered_tiles.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.gvct_host_covered_tiles.restype = ctypes.c_int
    return lib


# -- the flat (Q9) view -------------------------------------------------------

def flat_view(h: int, w: int, pad: int) -> tuple[int, int, int]:
    """(vh, vw, n): the flat view of an (h, w) interior zero-extended by
    `pad` -- its first vh * vw bytes viewed as (vh, vw), vh and vw the
    extended dims rounded down to multiples of 8 (utils/tiles.py
    split_covered) -- and n, the bytes of its flat tail."""
    b = SAMPLE_BLOCK_SIZE
    hh, ww = h + 2 * pad, w + 2 * pad
    vh, vw = b * (hh // b), b * (ww // b)
    return vh, vw, hh * ww - vh * vw


def tail_holds_interior(h: int, w: int, pad: int) -> bool:
    """Whether the flat tail of the extended (h, w) plane holds interior
    pixels (not only padding): a fresh T3 output then needs them from a
    tail buffer (rem)."""
    vh, vw, n = flat_view(h, w, pad)
    ww = w + 2 * pad
    f = vh * vw  # the tail's first padded byte; rows past pad + h are padding
    row, col = divmod(f, ww)
    if row >= pad + h:
        return False
    if row + 1 < pad + h:  # a whole interior row follows
        return n > 0
    return col < pad + w  # the tail starts on the last interior row


# -- plain versions ------------------------------------------------------------

def plane_to_tiles_plain(x, pad: int, by_grid: int | None = None,
                         bx_grid: int | None = None, flat: bool = False):
    """T2's plain version: a contiguous interior_to_tiles, or with flat=True
    the tiles of the zero-extended plane's flat (Q9) view, over the grid."""
    if not flat:
        return interior_to_tiles(x, pad, by_grid=by_grid, bx_grid=bx_grid).contiguous()
    core, _ = split_covered_data(F.pad(x, (pad, pad, pad, pad)))
    t = plane_to_tiles(core)
    by, bx = t.shape[-2:]
    byg = by if by_grid is None else by_grid
    bxg = bx if bx_grid is None else bx_grid
    return F.pad(t, (0, bxg - bx, 0, byg - by)).contiguous()


def flat_tail_plain(x, pad: int):
    """The (.., n) flat tail of the plane zero-extended by `pad` (T2's rem_out)."""
    return split_covered_data(F.pad(x, (pad, pad, pad, pad)))[1].contiguous()


def tiles_to_plane_plain(tiles, pad: int, h: int, w: int, flat: bool = False, rem=None,
                         base=None):
    """T3's plain version: a contiguous tiles_to_interior, or with flat=True
    the interior of the extended plane whose flat (Q9) view the tiles hold;
    its flat tail is rem where given, else that of `base` (the plane written
    into, unchanged there), else 0."""
    if not flat:
        return tiles_to_interior(tiles, pad, h, w).contiguous()
    vh, vw, _ = flat_view(h, w, pad)
    lead = tiles.shape[:-4]
    hh, ww = h + 2 * pad, w + 2 * pad
    if base is None:
        base = torch.zeros((*lead, h, w), dtype=torch.uint8, device=tiles.device)
    if rem is None:
        rem = split_covered_data(F.pad(base, (pad, pad, pad, pad)))[1]
    core = tiles_to_plane(tiles[..., : vh // SAMPLE_BLOCK_SIZE, : vw // SAMPLE_BLOCK_SIZE])
    ext = join_covered(core, rem, hh, ww)
    return ext[..., pad : pad + h, pad : pad + w].contiguous()


def pack_yv12_plain(y, u, v):
    """T4's plain version: the planes concatenated along the last axis."""
    return torch.cat([y, u, v], dim=-1)


# -- checks ----------------------------------------------------------------------

def _check_u8(t, name: str, device=None) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != torch.uint8:
        raise ValueError(f"{name} must be a uint8 tensor, got "
                         f"{getattr(t, 'dtype', type(t).__name__)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} must be a CUDA or CPU tensor, got {t.device}")
    if t.numel() and t.stride(-1) != 1:
        raise ValueError(f"{name} must be contiguous along its last axis, "
                         f"got strides {t.stride()}")


def _lead(t, name: str, tail: int):
    """(n_outer, n_inner, outer stride, inner stride) of up to two leading
    batch axes in front of `tail` trailing ones."""
    lead = t.dim() - tail
    if lead < 0 or lead > 2:
        raise ValueError(f"{name} takes at most two leading batch axes, got shape "
                         f"{tuple(t.shape)}")
    shape = [1] * (2 - lead) + list(t.shape[:lead])
    strides = [0] * (2 - lead) + list(t.stride()[:lead])
    if shape[0] * shape[1] > _MAX_GRID_YZ:
        raise ValueError(f"{name}: batch of {shape[0] * shape[1]} planes is too large "
                         f"for one launch")
    return shape[0], shape[1], strides[0], strides[1]


def _grid(h: int, w: int, pad: int, by_grid, bx_grid, flat: bool = False) -> tuple[int, int]:
    """The tile grid of an (h, w) interior plane with `pad`, validated as
    relayout_tile.cuh::geometry_ok and the plain versions do."""
    b = SAMPLE_BLOCK_SIZE
    if h <= 0 or w <= 0 or pad < 0:
        raise ValueError(f"need h, w > 0 and pad >= 0, got {h}x{w}, pad {pad}")
    if not flat and (w + 2 * pad) % b:
        raise ValueError(f"extended width {w} + 2*{pad} must be a multiple of {b} "
                         f"(sheared planes take flat=True)")
    by, bx = (h + 2 * pad) // b, (w + 2 * pad) // b
    if by == 0 or bx == 0:
        raise ValueError(f"an extended plane of {h + 2 * pad}x{w + 2 * pad} holds no tile")
    byg = by if by_grid is None else int(by_grid)
    bxg = bx if bx_grid is None else int(bx_grid)
    if byg < by or bxg < bx:
        raise ValueError(f"grid ({byg}, {bxg}) is smaller than the covered tiles ({by}, {bx})")
    if not flat and pad + h > b * by:
        raise ValueError(f"interior rows [{pad}, {pad + h}) exceed covered rows {b * by}")
    if b * byg > _MAX_GRID_YZ:  # one block row per extended row
        raise ValueError(f"tile grid too large for one launch: By={byg}")
    return byg, bxg


def _check_rem(rem, name: str, plane, h: int, w: int, pad: int, flat: bool) -> None:
    """A flat tail buffer: (.., n) uint8 with the plane's leading axes, on
    its device, last axis contiguous; flat view only."""
    if not flat:
        raise ValueError(f"{name} goes with flat=True (the flat view's tail)")
    _check_u8(rem, name, plane.device)
    n = flat_view(h, w, pad)[2]
    want = (*plane.shape[:-2], n)
    if tuple(rem.shape) != want:
        raise ValueError(f"{name} has shape {tuple(rem.shape)}, expected {want}")
    _lead(rem, name, 1)


def _flat_args(flat: bool, rem) -> tuple:
    """The kernels' last four geometry arguments: flat, the flat tail buffer
    (0: none) and its two batch strides."""
    if rem is None:
        return int(flat), None, 0, 0
    _, _, r_outer, r_inner = _lead(rem, "rem", 1)
    return int(flat), rem.data_ptr(), r_outer, r_inner


def _cuda_lib(device):
    if device.type != "cuda":
        raise ValueError(f"the relayout kernels take CUDA or CPU tensors, got {device}")
    return ck._load("relayout", build_library, _setup_cuda)


def _geom_args(plane, tiles, h, w, pad, byg, bxg):
    """The launch's geometry arguments; plane and tiles share their leading
    batch axes.  Raises where relayout_tile.cuh::make_geom would refuse the
    strides: offsets inside one plane or tile-planes block must fit 32 bits."""
    n_outer, n_inner, p_outer, p_inner = _lead(plane, "plane", 2)
    _, _, t_outer, t_inner = _lead(tiles, "tiles", 4)
    b = SAMPLE_BLOCK_SIZE
    t_r, t_c, t_by = tiles.stride(-4), tiles.stride(-3), tiles.stride(-2)
    slack = b * bxg + 32
    if ((h + pad) * plane.stride(-2) + slack > _INT32_MAX
            or (b - 1) * (t_r + t_c) + (byg - 1) * t_by + slack > _INT32_MAX):
        raise ValueError("a plane or tile-planes block spans more than 2**31 bytes")
    return (h, w, pad, byg, bxg, n_outer, n_inner, p_outer, p_inner, plane.stride(-2),
            t_outer, t_inner, t_r, t_c, t_by)


# -- wrappers ----------------------------------------------------------------------

def plane_to_tiles_cuda(x, pad: int, *, by_grid: int | None = None,
                        bx_grid: int | None = None, out=None, flat: bool = False,
                        rem_out=None):
    """T2: (.., h, w) uint8 interior planes -> (.., 8, 8, By, Bx) tile-planes
    of the plane zero-extended by `pad` (Q6), over a grid of (by_grid,
    bx_grid) tiles (default: the covered tiles, (h + 2pad) // 8 rows by
    truncating division, Q9).  Up to two leading batch axes; any row and
    batch strides, columns contiguous.

    flat=True: the tiles of the extended plane's flat view instead (the
    reference's sheared chroma sweep, Q9: its first vh * vw bytes viewed
    as (vh, vw), flat_view), for any interior width, read straight from
    the interior planes.  rem_out: an optional (.., n) destination
    (flat=True only) for each plane's flat tail, the n bytes after the
    view (0 for padding), written by the same launch.

    out: optional destination of shape (.., 8, 8, By, Bx) with any strides
    but a contiguous last axis -- e.g. a view that places U and V of one
    launch as (8, 8, 2, cBy, cBx).  Returns `out`, or a new contiguous
    tensor.  The launch goes on the current stream and does not
    synchronize.  CPU tensors take the plain version instead."""
    _check_u8(x, "plane")
    _lead(x, "plane", 2)
    h, w = x.shape[-2], x.shape[-1]
    byg, bxg = _grid(h, w, pad, by_grid, bx_grid, flat)
    want = (*x.shape[:-2], SAMPLE_BLOCK_SIZE, SAMPLE_BLOCK_SIZE, byg, bxg)
    if out is None:
        out = torch.empty(want, dtype=torch.uint8, device=x.device)
    else:
        _check_u8(out, "out", x.device)
        if tuple(out.shape) != want:
            raise ValueError(f"out has shape {tuple(out.shape)}, expected {want}")
    if rem_out is not None:
        _check_rem(rem_out, "rem_out", x, h, w, pad, flat)
    if x.device.type == "cpu":
        if rem_out is not None:
            rem_out.copy_(flat_tail_plain(x, pad))
        return out.copy_(plane_to_tiles_plain(x, pad, byg, bxg, flat))
    lib = _cuda_lib(x.device)
    if x.numel() == 0:
        return out
    err = lib.gvct_plane_to_tiles(x.data_ptr(), out.data_ptr(),
                                  *_geom_args(x, out, h, w, pad, byg, bxg),
                                  *_flat_args(flat, rem_out), x.device.index,
                                  torch.cuda.current_stream(x.device).cuda_stream)
    ck.raise_on_launch(err, lib, "plane_to_tiles")
    LAUNCHES["fwd"] += 1
    return out


def tiles_to_plane_cuda(tiles, pad: int, h: int, w: int, *, out=None, flat: bool = False,
                        rem=None):
    """T3: (.., 8, 8, By, Bx) uint8 tile-planes (any strides, Bx contiguous)
    -> the (.., h, w) interior [pad, pad + h) x [pad, pad + w) of the
    extended plane they hold.  Grid tiles past the extended plane are
    ignored.  Up to two leading batch axes.

    flat=True: the tiles hold the extended plane's flat (Q9) view
    (plane_to_tiles_cuda's flat=True); only the interior pixels of the view
    are written.  Those of its flat tail come from rem, a (.., n) flat tail
    (flat=True only; plane_to_tiles_cuda's rem_out), written by the same
    launch, or else keep the bytes `out` has; a new output whose tail holds
    interior pixels (tail_holds_interior) needs rem.

    out: optional destination of shape (.., h, w) with any strides but a
    contiguous last axis -- e.g. the luma rows or the U/V pair of a packed
    frame buffer, written in place.  Returns `out`, or a new contiguous
    tensor.  The launch goes on the current stream and does not
    synchronize.  CPU tensors take the plain version instead."""
    _check_u8(tiles, "tiles")
    if tiles.dim() < 4 or tuple(tiles.shape[-4:-2]) != (SAMPLE_BLOCK_SIZE, SAMPLE_BLOCK_SIZE):
        raise ValueError(f"tiles must be (.., 8, 8, By, Bx), got {tuple(tiles.shape)}")
    byg, bxg = tiles.shape[-2], tiles.shape[-1]
    _grid(h, w, pad, byg, bxg, flat)
    _lead(tiles, "tiles", 4)
    want = (*tiles.shape[:-4], h, w)
    fresh = out is None
    if fresh:
        out = torch.empty(want, dtype=torch.uint8, device=tiles.device)
    else:
        _check_u8(out, "out", tiles.device)
        if tuple(out.shape) != want:
            raise ValueError(f"out has shape {tuple(out.shape)}, expected {want}")
    if rem is not None:
        _check_rem(rem, "rem", out, h, w, pad, flat)
    elif flat and fresh and tail_holds_interior(h, w, pad):
        raise ValueError(f"the flat tail of an extended {h}x{w} plane (pad {pad}) holds "
                         f"interior pixels: a new output needs rem")
    if tiles.device.type == "cpu":
        return out.copy_(tiles_to_plane_plain(tiles, pad, h, w, flat, rem,
                                              None if fresh else out))
    lib = _cuda_lib(tiles.device)
    if out.numel() == 0:
        return out
    err = lib.gvct_tiles_to_plane(tiles.data_ptr(), out.data_ptr(),
                                  *_geom_args(out, tiles, h, w, pad, byg, bxg),
                                  *_flat_args(flat, rem), tiles.device.index,
                                  torch.cuda.current_stream(tiles.device).cuda_stream)
    ck.raise_on_launch(err, lib, "tiles_to_plane")
    LAUNCHES["inv"] += 1
    return out


def pack_yv12_cuda(y, u, v):
    """T4: Y (.., yn), U and V (.., cn) uint8 planes, flat -> one new (..,
    yn + 2cn) packed buffer, in one launch.  At most one leading batch axis,
    any batch strides; yn, cn, every batch stride and every start address
    are multiples of 16 bytes (always so for planes of frames whose w and h
    are multiples of 8).  The launch goes on the current stream and does
    not synchronize.  CPU tensors take the plain version."""
    _check_u8(y, "y")
    for name, t in (("y", y), ("u", u), ("v", v)):
        _check_u8(t, name, y.device)
        if t.dim() not in (1, 2) or t.dim() != y.dim() or t.shape[:-1] != y.shape[:-1]:
            raise ValueError(f"y, u, v must be (n) or (nb, n) with one nb, got "
                             f"{tuple(y.shape)}, {tuple(u.shape)}, {tuple(v.shape)}")
    yn, cn = y.shape[-1], u.shape[-1]
    if v.shape[-1] != cn:
        raise ValueError(f"u and v differ in size: {cn} vs {v.shape[-1]}")
    nb = y.shape[0] if y.dim() == 2 else 1
    strides = [t.stride(0) if t.dim() == 2 else 0 for t in (y, u, v)]
    if yn % _ALIGN or cn % _ALIGN or any(s % _ALIGN for s in strides) or any(
            t.data_ptr() % _ALIGN for t in (y, u, v)):
        raise ValueError(f"plane sizes ({yn}, {cn}), batch strides {strides} and start "
                         f"addresses must be multiples of {_ALIGN} bytes")
    if nb > _MAX_GRID_YZ:
        raise ValueError(f"batch of {nb} frames is too large for one launch")
    if y.device.type == "cpu":
        return pack_yv12_plain(y, u, v)
    lib = _cuda_lib(y.device)
    out = torch.empty((*y.shape[:-1], yn + 2 * cn), dtype=torch.uint8, device=y.device)
    if out.numel() == 0:
        return out
    err = lib.gvct_pack_yv12(y.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(),
                             yn, cn, nb, *strides, out.stride(0) if out.dim() == 2 else 0,
                             y.device.index, torch.cuda.current_stream(y.device).cuda_stream)
    ck.raise_on_launch(err, lib, "pack_yv12")
    LAUNCHES["pack"] += 1
    return out
