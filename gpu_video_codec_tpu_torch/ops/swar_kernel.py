"""The hand-written CUDA SWAR deblock kernel (T1): build, ctypes binding and
wrapper.

Counterpart of tools/swar_exp.py (swar_deblock_tiles and the Pallas
race.swar_call): K1's four-phase sweep on tile pairs, tile columns
[0, Bx/2) and [Bx/2, Bx) as the two signed 16-bit lanes of 32-bit words,
four threads per pair over a shared-memory stage as K1's quad has four per
tile (csrc/swar_kernel.cu over csrc/swar_tile.cuh).  It computes K1's
function, so its plain version is ops/deblock.deblock_tiles_plain.

The library is built at first use with nvcc into build/torch_kernels/, in
a library of its own beside the deblock and relayout ones, so that each
source is one nvcc run and the three can build at once (ops/cuda_kernel.py
builds all three the same way; each exports gvct_error_string).
deblock_tiles_swar_cuda checks its operands, launches on the current
stream and raises on any failure; on a CPU tensor it runs the plain
version instead.  LAUNCHES counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_kernel as ck
from .deblock import deblock_tiles_plain

# Kernel launches since import (or since a caller reset them), luma and
# chroma together.
LAUNCHES = {"swar": 0}
# Tile pairs per block of the kernel (4 threads each; its launcher takes
# 1..64, the size of its shared-memory stage).  On an H100 blocks of 16 and
# 64 pairs ran slower at the race grid (136, 256).
BLOCK = 32

_SOURCES = ("swar_kernel.cu",)
# swar_tile.cuh primitives bound by gvct_host_swar_op, by op code
HOST_OPS = ("add", "sub", "neg", "abs", "max", "min", "lt", "asr", "shl", "addmin_relu")


def build_library():
    """Build the SWAR library with nvcc (no-op when already built).
    Returns (path, compiler output)."""
    return ck._build([ck._nvcc(_SOURCES), *ck.NVCC_FLAGS], _SOURCES, "libgvct_swar")


def _setup_cuda(lib) -> None:
    lib.gvct_swar_tiles.argtypes = ck.GRID_ARGS + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.gvct_swar_tiles.restype = ctypes.c_int
    lib.gvct_swar_tiles_occupancy.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    lib.gvct_swar_tiles_occupancy.restype = ctypes.c_int
    lib.gvct_error_string.argtypes = [ctypes.c_int]
    lib.gvct_error_string.restype = ctypes.c_char_p


def load_host_library() -> ctypes.CDLL:
    """The g++ build of csrc/host_shim.cpp (ops/cuda_kernel.load_host_library)
    with T1's pieces bound: gvct_host_swar_tiles(tb, ...) (the kernel's
    blocks of tb tile pairs, their 4 * tb threads one after another between
    the kernel's exchange points), gvct_host_swar_word_bytes (its staging
    word) and gvct_host_swar_op (one halfword primitive, as its host
    fallback, over arrays of words; op codes in HOST_OPS)."""
    lib = ck.load_host_library()
    lib.gvct_host_swar_tiles.argtypes = [ctypes.c_int] + ck.GRID_ARGS
    lib.gvct_host_swar_tiles.restype = ctypes.c_int
    lib.gvct_host_swar_word_bytes.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    lib.gvct_host_swar_word_bytes.restype = ctypes.c_int
    lib.gvct_host_swar_op.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                                      + [ctypes.c_longlong, ctypes.c_int])
    lib.gvct_host_swar_op.restype = ctypes.c_int
    return lib


def deblock_tiles_swar_cuda(tiles, bs_ver1, bs_ver2, bs_hor1, bs_hor2, beta, tc,
                            chroma: bool = False):
    """T1: deblock an (8, 8, By, Bx) uint8 tile-planes tensor, Bx even,
    with (By, Bx) BS maps, all contiguous on one device; beta, tc: ints;
    chroma: the chroma filter and BS == 2 gate (as
    tools/swar_exp.py::swar_deblock_tiles); the kernel runs BLOCK tile
    pairs (bx, bx + Bx/2) per block.  Returns a new tensor, byte-equal to
    deblock_tiles_cuda's.  The launch goes on the current stream and does
    not synchronize.  CPU tensors take the plain version; an odd Bx raises
    ValueError."""
    maps = (bs_ver1, bs_ver2, bs_hor1, bs_hor2)
    beta, tc = int(beta), int(tc)
    ck.check_operands(tiles, beta, tc)
    if tiles.dim() != 4 or tuple(tiles.shape[:2]) != (8, 8):
        raise ValueError(f"tiles must be (8, 8, By, Bx), got {tuple(tiles.shape)}")
    by, bx = tiles.shape[2], tiles.shape[3]
    if bx % 2:
        raise ValueError(f"the SWAR kernel pairs tile columns bx and bx + Bx/2: Bx must be "
                         f"even, got {bx}")
    ck.check_grid_maps(tiles, maps, by, bx)
    if tiles.device.type == "cpu":
        return deblock_tiles_plain(tiles, *maps, beta, tc, chroma=chroma)
    if tiles.device.type != "cuda":
        raise ValueError(f"deblock_tiles_swar_cuda takes CUDA or CPU tensors, got {tiles.device}")
    out = torch.empty_like(tiles)
    if tiles.numel() == 0:
        return out
    lib = ck._load("swar", build_library, _setup_cuda)
    err = lib.gvct_swar_tiles(tiles.data_ptr(), out.data_ptr(), *(m.data_ptr() for m in maps),
                              beta, tc, by, bx, int(chroma), BLOCK, tiles.device.index,
                              torch.cuda.current_stream(tiles.device).cuda_stream)
    ck.raise_on_launch(err, lib, "SWAR deblock")
    LAUNCHES["swar"] += 1
    return out


def swar_occupancy(shape, chroma: bool = False, device=None) -> dict:
    """T1's kernel for tiles of `shape` (8, 8, By, Bx) on aligned tensors of
    `device`: ops/cuda_kernel.occupancy()'s dict."""
    lib = ck._load("swar", build_library, _setup_cuda)
    return ck.occupancy(lib.gvct_swar_tiles_occupancy, lib, int(chroma), BLOCK, shape[-2],
                        shape[-1], device=device)
