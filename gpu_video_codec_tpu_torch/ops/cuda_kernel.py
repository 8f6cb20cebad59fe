"""The hand-written CUDA deblock kernels: build, ctypes binding and wrappers.

Counterpart of gpu_video_codec_tpu/ops/pallas_kernel.py.  The kernels
(csrc/deblock_kernel.cu over the per-row math of csrc/deblock_tile.cuh)
deblock the tile-planes layout of utils/tiles.py, luma or chroma by
template, as one quad kernel of four threads per shifted 8x8 tile with a
block's tiles staged in shared memory (csrc/deblock_quad.cuh), its compute
type a template parameter too: K1 and K1c compute in int, K1-i16 and
K1-i16c (dtype=torch.int16, the JAX package's dtype=jnp.int16) in int16.
The same library holds T5 (deblock_rows_cuda), the kernel of
tools/rowslayout_exp.py: the same quad on the (By, 8, 8, Bx) "rows" layout,
a block's tiles of one tile row staged by the tensor memory accelerator
(TMA) where the rows are 16-byte aligned, in words otherwise
(deblock_rows_occupancy reports which).  And K2 (deblock_packed_cuda), the
packed step's one kernel: the same quad on the frames' planes themselves,
each block's shifted tiles staged by TMA straight from the picture, in
place of T2 -> K1 -> T3 and T2 -> K1c -> T3 wherever its guard
(packed_fits) takes the geometry and the buffers; and K2-10, its instance
on HEVC Main 10's 16-bit samples (deblock_packed_cuda(..., bit_depth=10)),
which has no chain to fall back to.  Both take 4:2:2 and 4:4:4 frames as
well (chroma_format="4:2:2": chroma planes (h, w/2); "4:4:4": (h, w)), the
chroma planes' width and height runtime arguments of one instance each.

The library is built at first use with nvcc, from csrc/ only, into
build/torch_kernels/ beside the package, under a name keyed on a hash of
the sources and flags, so an edit rebuilds.  It has a plain C interface
and is loaded with ctypes (no PyTorch headers, so the build takes seconds).

deblock_tiles_cuda, deblock_rows_cuda and deblock_packed_cuda launch their
kernel for a CUDA tensor and raise on any failure; for a CPU tensor they
run the plain version (ops/deblock.deblock_tiles_plain, deblock_rows_plain,
deblock_packed_plain).  The chain around K1 and K1c, T2 -> K1 -> T3, is
ops/chain.py.  LAUNCHES counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from ..utils.tracing import RECORDER
from .deblock import deblock_packed_plain, deblock_rows_plain, deblock_tiles_plain
from .tables import (
    CHROMA_FORMATS, check_bit_depth, check_chroma_format, chroma_height, chroma_width,
)

# Tiles per block of the quad kernel (K1, K1c, K1-i16, K1-i16c): consecutive
# tiles of the flattened (By, Bx) grid, QUAD threads each, at most
# MAX_QUAD_BLOCK_BX (the size of the kernel's shared-memory stage).  Callers
# may pass their own (StreamingDeblocker's luma_block/chroma_block).
QUAD = 4
MAX_QUAD_BLOCK_BX = 64
BLOCK_BX = 64
CHROMA_BLOCK_BX = 64
# Tiles per block of T5 (consecutive tiles of one tile row, QUAD threads
# each): one TMA box, so that aligned grids take the TMA route; chosen over
# 64 and 16 by timings at the race grid (PERF.md §6).
ROWS_BLOCK_BX = 32

# Tiles per block of K2: consecutive tiles of one tile row, QUAD threads
# each, staged as one TMA box (csrc/deblock_quad.cuh kPackedTiles): a
# constant of its design, not a parameter; chosen over 8, 24 and 48 by
# timings at the benchmark cells' shapes (PERF.md §6).
PACKED_TILES = 16
# K2's guard: row, plane and frame strides and base addresses in multiples
# of this many bytes (what a tensor map demands), and luma and chroma rows
# of 16-byte multiples too (packed_width).
_TMA_ALIGN = 16
# a packed step's samples by bit depth
SAMPLE_DTYPES = {8: torch.uint8, 10: torch.int16}

# Kernel launches per variant since import (or since a caller reset them):
# K1, K1c, K1-i16 luma and chroma, T5 (luma and chroma), K2, K2-10, and K2
# and K2-10 on 4:2:2 and on 4:4:4 frames.
LAUNCHES = {"luma": 0, "chroma": 0, "luma_i16": 0, "chroma_i16": 0, "rows": 0, "packed": 0,
            "packed10": 0, "packed_422": 0, "packed10_422": 0, "packed_444": 0,
            "packed10_444": 0}
# deblock_packed_cuda's LAUNCHES key by (bit depth, chroma format)
PACKED_LAUNCHES = {(8, "4:2:0"): "packed", (10, "4:2:0"): "packed10",
                   (8, "4:2:2"): "packed_422", (10, "4:2:2"): "packed10_422",
                   (8, "4:4:4"): "packed_444", (10, "4:4:4"): "packed10_444"}

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
_KERNEL_SOURCES = ("deblock_kernel.cu",)
_HOST_SOURCES = ("host_shim.cpp",)
_HEADERS = ("deblock_tile.cuh", "deblock_quad.cuh", "relayout_tile.cuh", "swar_tile.cuh")
_DTYPES = (torch.int32, torch.int16)

DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's standard place
_MAX_GRID_YZ = 65535
_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc(sources=_KERNEL_SOURCES) -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.is_file():
        return str(DEFAULT_NVCC)
    cmd = " ".join(("nvcc", *NVCC_FLAGS, "-o", "<lib>.so",
                    *(str(CSRC / s) for s in sources)))
    raise RuntimeError(f"nvcc not found (set CUDA_HOME or PATH); cannot run: {cmd}")


def _build(compiler: list[str], sources, stem: str) -> tuple[Path, str]:
    """Compile `sources` (names under csrc/) into a shared library keyed on
    the hash of every csrc input and the command.  Returns (path, compiler
    output); the output is '' when the library was already built.  A
    compiler run is the span kernels.build (utils/tracing.py)."""
    h = hashlib.sha256(" ".join(compiler[1:]).encode())
    for name in (*sources, *_HEADERS):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    out = BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"
    if out.is_file():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: a concurrent loader never
    # sees a half-written library
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [*compiler, "-o", str(tmp), *(str(CSRC / s) for s in sources)]
    with RECORDER.span("kernels.build"):
        res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"kernel build failed ({res.returncode}): {' '.join(cmd)}\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out, res.stdout + res.stderr


def build_library() -> tuple[Path, str]:
    """Build the CUDA library with nvcc (no-op when already built).
    Returns (path, compiler output)."""
    return _build([_nvcc(), *NVCC_FLAGS], _KERNEL_SOURCES, "libgvct_deblock")


def _load(key: str, build, setup) -> ctypes.CDLL:
    """Build (once) and load a library, calling setup(lib) on first load
    (the span kernels.load, utils/tracing.py)."""
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            with RECORDER.span("kernels.load"):
                path, _ = build()
                lib = ctypes.CDLL(str(path))
                setup(lib)
            _libs[key] = lib
        return lib


_TILE_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_longlong, ctypes.c_int]
# in, out, four maps, beta, tc, By, Bx, chroma: T5's and T1's arguments
GRID_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
_LAUNCH_ARGS = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]  # threads, device, stream
# y_in, y_out, uv_in, uv_out, 10 strides, 8 maps, beta, tc, w, h, cw, ch,
# k, luma_only, bit_depth
_PACKED_ARGS = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong),
                                        ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_int] * 9


def _setup_cuda(lib) -> None:
    lib.gvct_deblock_tiles.argtypes = _TILE_ARGS + [ctypes.c_int] + _LAUNCH_ARGS
    lib.gvct_deblock_tiles.restype = ctypes.c_int
    lib.gvct_deblock_tiles_occupancy.argtypes = [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.gvct_deblock_tiles_occupancy.restype = ctypes.c_int
    lib.gvct_deblock_rows.argtypes = GRID_ARGS + _LAUNCH_ARGS
    lib.gvct_deblock_rows.restype = ctypes.c_int
    lib.gvct_deblock_rows_occupancy.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2 + [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.gvct_deblock_rows_occupancy.restype = ctypes.c_int
    lib.gvct_deblock_packed.argtypes = _PACKED_ARGS + [ctypes.c_int, ctypes.c_void_p]
    lib.gvct_deblock_packed.restype = ctypes.c_int
    lib.gvct_deblock_packed_info.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    lib.gvct_deblock_packed_info.restype = ctypes.c_int
    lib.gvct_error_string.argtypes = [ctypes.c_int]
    lib.gvct_error_string.restype = ctypes.c_char_p


def _setup_host(lib) -> None:
    for entry in (lib.gvct_host_deblock_tiles_quad, lib.gvct_host_deblock_tiles_i16):
        entry.argtypes = [ctypes.c_int] + _TILE_ARGS
        entry.restype = ctypes.c_int
    lib.gvct_host_quad_word_bytes.argtypes = [ctypes.c_longlong, ctypes.c_int] + [
        ctypes.c_void_p] * 2
    lib.gvct_host_quad_word_bytes.restype = ctypes.c_int
    lib.gvct_host_deblock_rows.argtypes = [ctypes.c_int] * 2 + GRID_ARGS
    lib.gvct_host_deblock_rows.restype = ctypes.c_int
    lib.gvct_host_rows_staging.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    lib.gvct_host_rows_staging.restype = ctypes.c_int
    lib.gvct_host_deblock_packed.argtypes = _PACKED_ARGS
    lib.gvct_host_deblock_packed.restype = ctypes.c_int
    lib.gvct_host_packed_reads.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.gvct_host_packed_reads.restype = ctypes.c_int
    lib.gvct_host_packed_grid.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    lib.gvct_host_packed_grid.restype = ctypes.c_int


def load_host_library() -> ctypes.CDLL:
    """g++ build of csrc/host_shim.cpp: the kernels' per-tile math and
    indexing compiled for the CPU, so tests can hold the CUDA source's
    arithmetic against the plain version where nvcc is absent
    (gvct_host_deblock_tiles_quad(tb, ...) for K1/K1c and
    gvct_host_deblock_tiles_i16(tb, ...) for K1-i16/K1-i16c, the quad
    kernel at int and int16_t, a block's 4 * tb threads run one after
    another between the kernel's exchange points; gvct_host_deblock_rows(tb,
    tma, ...) for T5, the same quad on the rows layout, staged in route B's
    words or as route A's TMA boxes would stage it, and
    gvct_host_rows_staging, the route rule; gvct_host_deblock_packed for K2
    and K2-10, its blocks staged as its TMA box would stage them, with
    packed_launch_args' arguments, gvct_host_packed_reads, the byte each
    of a block's threads reads from the box at each of its four steps, and
    gvct_host_packed_grid, its grid's extents and blocks (packed_blocks);
    ops/relayout_kernel.py and
    ops/swar_kernel.py bind the rest)."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH")
    return _load("host", lambda: _build([gxx, "-std=c++17", "-O2", "-shared", "-fPIC"],
                                        _HOST_SOURCES, "libgvct_host"), _setup_host)


def check_operands(tiles, beta, tc) -> None:
    """The checks every deblock kernel's wrapper makes on its tile tensor
    and thresholds (its shape is each wrapper's own)."""
    if tiles.dtype != torch.uint8:
        raise ValueError(f"tiles must be uint8, got {tiles.dtype}")
    if not tiles.is_contiguous():
        raise ValueError("tiles must be contiguous (plane_to_tiles returns a strided "
                         "view: call .contiguous() first)")
    if beta < 0 or tc < 0:
        raise ValueError(f"beta and tc must be non-negative, got {beta}, {tc}")


def check_grid_maps(tiles, maps, by: int, bx: int) -> None:
    """The four (By, Bx) BS maps of a one-frame launch (T5, T1)."""
    for name, m in zip(("bs_ver1", "bs_ver2", "bs_hor1", "bs_hor2"), maps):
        if m.dtype != torch.uint8 or m.device != tiles.device or not m.is_contiguous():
            raise ValueError(f"{name} must be a contiguous uint8 tensor on {tiles.device}, "
                             f"got {m.dtype} on {m.device}")
        if tuple(m.shape) != (by, bx):
            raise ValueError(f"{name} has shape {tuple(m.shape)}, expected {(by, bx)}")
    if by > _MAX_GRID_YZ:
        raise ValueError(f"tile grid too large for one launch: By={by}")


def _check(tiles, maps, beta, tc) -> tuple[int, int]:
    """Validate the kernel's operands; returns (nb, map batch stride)."""
    check_operands(tiles, beta, tc)
    if tiles.dim() not in (4, 5) or tuple(tiles.shape[-4:-2]) != (8, 8):
        raise ValueError(f"tiles must be (8, 8, By, Bx) or (NB, 8, 8, By, Bx), "
                         f"got {tuple(tiles.shape)}")
    by, bx = tiles.shape[-2], tiles.shape[-1]
    batched = tiles.dim() == 5
    nb = tiles.shape[0] if batched else 1
    for name, m in zip(("bs_ver1", "bs_ver2", "bs_hor1", "bs_hor2"), maps):
        if m.dtype != torch.uint8 or m.device != tiles.device or not m.is_contiguous():
            raise ValueError(f"{name} must be a contiguous uint8 tensor on {tiles.device}, "
                             f"got {m.dtype} on {m.device}")
        want = [(1, by, bx), (nb, by, bx)] if batched else [(by, bx)]
        if tuple(m.shape) not in want:
            raise ValueError(f"{name} has shape {tuple(m.shape)}; tiles "
                             f"{tuple(tiles.shape)} need one of {want}")
    # the kernel takes one batch stride for all four maps
    if len({m.shape for m in maps}) != 1:
        raise ValueError("the four BS maps must have one shape (all shared or all per-frame)")
    shared = batched and maps[0].shape[0] == 1
    if by > _MAX_GRID_YZ or nb > _MAX_GRID_YZ:
        raise ValueError(f"tile grid too large for one launch: By={by}, NB={nb}")
    return nb, 0 if shared else by * bx


def raise_on_launch(err: int, lib, what: str) -> None:
    """Raise if a kernel's C entry returned a CUDA error (every CUDA library
    of the port exports gvct_error_string)."""
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.gvct_error_string(err).decode()} (cudaError {err})")


def deblock_tiles_cuda(tiles, bs_ver1, bs_ver2, bs_hor1, bs_hor2, beta, tc,
                       chroma: bool = False, block_bx: int | None = None,
                       dtype=torch.int32):
    """Deblock a tile-planes tensor with the CUDA kernel.

    tiles: (8, 8, By, Bx) uint8 with (By, Bx) BS maps, or batched
    (NB, 8, 8, By, Bx) with (NB, By, Bx) per-frame or (1, By, Bx) shared
    maps; all contiguous uint8 on one device.  beta, tc: ints.
    dtype: the compute type, torch.int32 (K1, K1c) or torch.int16
    (K1-i16; the same bytes).
    block_bx: tiles per block, as in the JAX package (consecutive along Bx;
    a block runs on into the next tile row), QUAD threads per tile
    (1..MAX_QUAD_BLOCK_BX; default BLOCK_BX / CHROMA_BLOCK_BX), for either
    dtype.
    Returns a new tensor of the input's shape.  The launch goes on the
    current stream and does not synchronize.  CPU tensors take the plain
    version instead.
    """
    maps = (bs_ver1, bs_ver2, bs_hor1, bs_hor2)
    beta, tc = int(beta), int(tc)
    if dtype not in _DTYPES:
        raise ValueError(f"dtype must be torch.int32 or torch.int16, got {dtype}")
    nb, map_stride = _check(tiles, maps, beta, tc)
    int16 = dtype == torch.int16
    block_bx = _block_bx(chroma, block_bx)
    if tiles.device.type == "cpu":
        return deblock_tiles_plain(tiles, *maps, beta, tc, chroma=chroma, dtype=dtype)
    if tiles.device.type != "cuda":
        raise ValueError(f"deblock_tiles_cuda takes CUDA or CPU tensors, got {tiles.device}")
    out = torch.empty_like(tiles)
    if tiles.numel() == 0:
        return out
    lib = _load("cuda", build_library, _setup_cuda)
    by, bx = tiles.shape[-2], tiles.shape[-1]
    stream = torch.cuda.current_stream(tiles.device).cuda_stream
    err = lib.gvct_deblock_tiles(
        tiles.data_ptr(), out.data_ptr(), *(m.data_ptr() for m in maps),
        beta, tc, nb, by, bx, map_stride, int(chroma), int(int16), block_bx,
        tiles.device.index, stream)
    raise_on_launch(err, lib, "deblock")
    LAUNCHES[("chroma" if chroma else "luma") + ("_i16" if int16 else "")] += 1
    return out


def _block_bx(chroma: bool, block_bx: int | None) -> int:
    """deblock_tiles_cuda's tiles per block (its default when None); raises
    for a block the kernel cannot take."""
    if block_bx is None:
        block_bx = CHROMA_BLOCK_BX if chroma else BLOCK_BX
    if not 1 <= block_bx <= MAX_QUAD_BLOCK_BX:
        raise ValueError(f"block_bx must satisfy 1 <= block_bx <= {MAX_QUAD_BLOCK_BX}, "
                         f"got {block_bx}")
    return block_bx


def occupancy(entry, lib, *args, device=None) -> dict:
    """A kernel's occupancy entry (gvct_*_occupancy(*args, device, out)) on
    `device` (default: the current CUDA device): the blocks one SM holds at
    once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), threads per block
    and the bytes per global access of its staging.  Returns {"threads",
    "word_bytes", "blocks_per_sm", "warps_per_sm"}."""
    device = torch.device("cuda", torch.cuda.current_device()) if device is None \
        else torch.device(device)
    out = (ctypes.c_int * 3)()
    raise_on_launch(entry(*args, device.index, out), lib, "occupancy")
    blocks, threads, word = out
    return {"threads": threads, "word_bytes": word, "blocks_per_sm": blocks,
            "warps_per_sm": blocks * ((threads + 31) // 32)}


def deblock_tiles_occupancy(shape, chroma: bool = False, block_bx: int | None = None,
                            device=None, dtype=torch.int32) -> dict:
    """The quad kernel (K1/K1c, or K1-i16/K1-i16c for dtype=torch.int16)
    for tiles of `shape` (.., By, Bx) on aligned tensors of `device`:
    occupancy()'s dict with "block_bx"."""
    block_bx = _block_bx(chroma, block_bx)
    lib = _load("cuda", build_library, _setup_cuda)
    return {"block_bx": block_bx, **occupancy(
        lib.gvct_deblock_tiles_occupancy, lib, int(chroma), int(dtype == torch.int16), block_bx,
        shape[-2], shape[-1], device=device)}


def deblock_rows_cuda(tiles_rows, bs_ver1, bs_ver2, bs_hor1, bs_hor2, beta, tc,
                      chroma: bool = False):
    """T5: deblock a tile grid held in the rows layout (By, 8, 8, Bx),
    element [by, r, c, bx] = pixel (r, c) of tile (by, bx), with (By, Bx)
    BS maps; all contiguous uint8 on one device.  beta, tc: ints.
    Returns a new (By, 8, 8, Bx) tensor.  The launch (blocks of
    ROWS_BLOCK_BX tiles) goes on the current stream and does not
    synchronize; it stages by TMA where Bx and the tensors' addresses are
    multiples of 16 bytes, in words otherwise, and raises if either fails.
    CPU tensors take the plain version (ops/deblock.deblock_rows_plain)."""
    maps = (bs_ver1, bs_ver2, bs_hor1, bs_hor2)
    beta, tc = int(beta), int(tc)
    check_operands(tiles_rows, beta, tc)
    if tiles_rows.dim() != 4 or tuple(tiles_rows.shape[1:3]) != (8, 8):
        raise ValueError(f"tiles_rows must be (By, 8, 8, Bx), got {tuple(tiles_rows.shape)}")
    by, bx = tiles_rows.shape[0], tiles_rows.shape[3]
    check_grid_maps(tiles_rows, maps, by, bx)
    if tiles_rows.device.type == "cpu":
        return deblock_rows_plain(tiles_rows, *maps, beta, tc, chroma=chroma)
    if tiles_rows.device.type != "cuda":
        raise ValueError(f"deblock_rows_cuda takes CUDA or CPU tensors, got {tiles_rows.device}")
    out = torch.empty_like(tiles_rows)
    if tiles_rows.numel() == 0:
        return out
    lib = _load("cuda", build_library, _setup_cuda)
    err = lib.gvct_deblock_rows(
        tiles_rows.data_ptr(), out.data_ptr(), *(m.data_ptr() for m in maps),
        beta, tc, by, bx, int(chroma), ROWS_BLOCK_BX, tiles_rows.device.index,
        torch.cuda.current_stream(tiles_rows.device).cuda_stream)
    raise_on_launch(err, lib, "deblock_rows")
    LAUNCHES["rows"] += 1
    return out


def deblock_rows_occupancy(tiles_rows, chroma: bool = False) -> dict:
    """T5's launch for this CUDA tensor (deblock_rows_cuda's output is
    allocated 16-byte aligned, so the input's shape and address decide):
    {"route": "tma" or "words", "word_bytes" (route B's bytes per access,
    None for TMA), "threads", "blocks_per_sm", "warps_per_sm",
    "smem_bytes" (static shared memory per block), "registers"}."""
    lib = _load("cuda", build_library, _setup_cuda)
    by, bx = tiles_rows.shape[0], tiles_rows.shape[3]
    info = (ctypes.c_int * 5)()
    raise_on_launch(lib.gvct_deblock_rows_occupancy(
        int(chroma), ROWS_BLOCK_BX, by, bx, tiles_rows.data_ptr(), tiles_rows.data_ptr(),
        tiles_rows.device.index, info), lib, "occupancy")
    blocks, threads, staging, smem, regs = info
    return {"route": "words" if staging else "tma", "word_bytes": staging or None,
            "threads": threads, "blocks_per_sm": blocks,
            "warps_per_sm": blocks * ((threads + 31) // 32), "smem_bytes": smem,
            "registers": regs}


# -- K2: the packed step on the frames' planes ---------------------------------------

def packed_width(bit_depth: int = 8, chroma_format: str = "4:2:0") -> int:
    """The multiple of the frame width that K2's guard asks: the one that
    makes both the luma rows, w samples, and the chroma rows, w/2 (4:2:0,
    4:2:2) or w (4:4:4), 16-byte multiples -- 32 at 8 bits and 16 at 10
    (K2-10) where chroma is half as wide, 16 and 8 at 4:4:4."""
    size = SAMPLE_DTYPES[check_bit_depth(bit_depth)].itemsize
    return _TMA_ALIGN * CHROMA_FORMATS[check_chroma_format(chroma_format)][0] // size


def packed_fits(w: int, *tensors, bit_depth: int = 8, chroma_format: str = "4:2:0") -> bool:
    """K2's guard, from the frame width, the bit depth, the chroma format
    and the tensors alone (None skipped): the luma and the chroma rows are
    16-byte multiples, w % packed_width(bit_depth, chroma_format) == 0 --
    w % 32 == 0 at 8 bits and w % 16 == 0 at 10 (2 bytes a sample; K2-10)
    where chroma rows are w/2 samples (4:2:0, 4:2:2), which also leaves out
    every sheared width (Q9, w % 16 == 8); at 4:4:4, chroma rows as wide as
    luma's, w % 16 == 0 at 8 bits and w % 8 == 0 at 10 -- and every tensor
    has a contiguous last axis, a 16-byte aligned base address and its
    other strides in 16-byte multiples (in bytes), as a tensor map demands.
    Where it fails, the 8-bit 4:2:0 packed step keeps the chain T2 -> K1 ->
    T3; a 10-bit, 4:2:2 or 4:4:4 one has no chain (models/streaming raises
    on a CUDA device)."""
    return w % packed_width(bit_depth, chroma_format) == 0 and all(
        t.stride(-1) == 1 and t.data_ptr() % _TMA_ALIGN == 0
        and all(s * t.element_size() % _TMA_ALIGN == 0 for s in t.stride()[:-1])
        for t in tensors if t is not None)


def packed_grids(w: int, h: int,
                 chroma_format: str = "4:2:0") -> tuple[tuple[int, int], tuple[int, int]]:
    """The luma and the chroma tile grids of a w x h frame's packed step,
    (By, Bx) and (cBy, cBx): the chain's (utils/tiles.interior_to_tiles
    with pad 4) on the luma plane and on a chroma plane, (h/2, w/2) at
    4:2:0, (h, w/2) at 4:2:2 and (h, w) at 4:4:4, and its BS maps' shapes."""
    ch, cw = chroma_height(h, chroma_format), chroma_width(w, chroma_format)
    return ((h + 8) // 8, (w + 8) // 8), ((ch + 8) // 8, (cw + 8) // 8)


def packed_blocks(w: int, h: int, chroma_format: str = "4:2:0",
                  luma_only: bool = False) -> dict:
    """K2's launch grid for one frame, from the g++ build of its grid
    (csrc/deblock_quad.cuh packed_grid and packed_block): {"gx", "rows"}
    (the grid is (gx, rows, k)), "blocks" (gx x rows), "empty" (blocks past
    their rows' ends, which return at once), "short" (blocks of fewer than
    PACKED_TILES tiles) and "tiles" (the luma, U and V tiles the blocks
    own)."""
    info = (ctypes.c_int * 7)()
    load_host_library().gvct_host_packed_grid(
        w, h, chroma_width(w, chroma_format), chroma_height(h, chroma_format), int(luma_only),
        info)
    gx, rows, empty, short, *tiles = info
    return {"gx": gx, "rows": rows, "blocks": gx * rows, "empty": empty, "short": short,
            "tiles": tuple(tiles)}


def _check_packed(y, uv, luma_maps, chroma_maps, beta, tc, out, bit_depth,
                  chroma_format) -> None:
    """deblock_packed_cuda's operand checks; raises ValueError."""
    dtype = SAMPLE_DTYPES[check_bit_depth(bit_depth)]
    for name, t in (("y", y), ("uv", uv)):
        if not isinstance(t, torch.Tensor) or t.dtype != dtype:
            raise ValueError(f"{name} must be a {dtype} tensor at bit_depth {bit_depth}, got "
                             f"{getattr(t, 'dtype', type(t).__name__)}")
    if y.dim() not in (2, 3) or uv.dim() != y.dim() + 1:
        raise ValueError(f"y must be (h, w) or (k, h, w) and uv (.., 2, ch, cw) with the same "
                         f"leading axis, got {tuple(y.shape)} and {tuple(uv.shape)}")
    h, w = y.shape[-2:]
    if h <= 0 or w <= 0 or h % 8 or w % 8:
        raise ValueError(f"frame dims must be positive multiples of 8, got {w}x{h}")
    want = (*y.shape[:-2], 2, chroma_height(h, chroma_format), chroma_width(w, chroma_format))
    if tuple(uv.shape) != want or uv.device != y.device:
        raise ValueError(f"uv must be {want} on {y.device} at chroma_format {chroma_format}, "
                         f"got {tuple(uv.shape)} on {uv.device}")
    if beta < 0 or tc < 0:
        raise ValueError(f"beta and tc must be non-negative, got {beta}, {tc}")
    grid, cgrid = packed_grids(w, h, chroma_format)
    check_grid_maps(y, luma_maps, *grid)
    check_grid_maps(y, chroma_maps, *cgrid)
    if out is not None:
        if len(out) != 2:
            raise ValueError("out must be a (y, uv) pair")
        for name, t, like in (("out y", out[0], y), ("out uv", out[1], uv)):
            if (not isinstance(t, torch.Tensor) or t.dtype != dtype
                    or t.shape != like.shape or t.device != y.device):
                raise ValueError(f"{name} must be a {dtype} {tuple(like.shape)} tensor on "
                                 f"{y.device}")
    if not packed_fits(w, y, uv, *(out or ()), bit_depth=bit_depth,
                       chroma_format=chroma_format):
        raise ValueError(packed_limit(w, bit_depth, chroma_format))
    if y.dim() == 3 and y.shape[0] > _MAX_GRID_YZ:
        raise ValueError(f"batch of {y.shape[0]} frames is too large for one launch")


def packed_limit(w: int, bit_depth: int, chroma_format: str = "4:2:0") -> str:
    """What K2 (or K2-10) takes at a chroma format, for an error message."""
    name = "K2" if bit_depth == 8 else "K2-10"
    return (f"{name} takes w % {packed_width(bit_depth, chroma_format)} == 0 at chroma_format "
            f"{chroma_format} (got {w}) and planes with a contiguous last axis, addresses and "
            f"strides in {_TMA_ALIGN}-byte multiples (packed_fits)")


def packed_launch_args(y, uv, y_out, uv_out, luma_maps, chroma_maps, beta, tc,
                       luma_only, bit_depth: int = 8) -> tuple:
    """gvct_deblock_packed's arguments up to its device and stream (and
    gvct_host_deblock_packed's, all of them): the planes' addresses, their
    frame, plane and row strides in bytes, the eight maps, the thresholds
    (the tables', which the entries scale to the bit depth), the geometry
    -- w and h from y, the chroma planes' columns and rows from uv: (w/2,
    h/2) at 4:2:0, (w/2, h) at 4:2:2, (w, h) at 4:4:4 -- and the bit depth
    (csrc/deblock_kernel.cu)."""
    h, w = y.shape[-2:]
    size = y.element_size()

    def frame(t, n):  # the frame stride of a group of n axes, batched or not
        return t.stride(0) if t.dim() == n + 1 else t.shape[0] * t.stride(0)

    strides = [frame(y, 2), y.stride(-2), frame(y_out, 2), y_out.stride(-2)]
    strides += [0] * 6 if luma_only else [
        frame(uv, 3), uv.stride(-3), uv.stride(-2),
        frame(uv_out, 3), uv_out.stride(-3), uv_out.stride(-2)]
    if size != 1:
        strides = [size * s for s in strides]
    maps = (ctypes.c_void_p * 8)(*(m.data_ptr() for m in (*luma_maps, *chroma_maps)))
    chroma = (None, None) if luma_only else (uv.data_ptr(), uv_out.data_ptr())
    return (y.data_ptr(), y_out.data_ptr(), chroma[0], chroma[1],
            (ctypes.c_longlong * 10)(*strides), maps, int(beta), int(tc), w, h, uv.shape[-1],
            uv.shape[-2],
            y.shape[0] if y.dim() == 3 else 1, int(luma_only), int(bit_depth))


def deblock_packed_cuda(y, uv, luma_maps, chroma_maps, beta, tc, *, luma_only: bool = False,
                        out=None, bit_depth: int = 8, chroma_format: str = "4:2:0"):
    """K2: the packed YV12 step of k frames in one launch, on their planes
    (csrc/deblock_kernel.cu, deblock_packed_kernel): each block's shifted
    8x8 tiles loaded by TMA straight from a plane, K1's or K1c's quad run on
    them in the lanes' registers, each lane storing its own rows in words
    of 4 samples -- what T2 -> K1 -> T3 and T2 -> K1c -> T3 compute.

    y: (h, w) or (k, h, w) luma and uv: (.., 2, h/2, w/2) U and V planes,
    uint8 (e.g. the views of a packed (k, 3h/2, w) buffer); luma_maps: four
    (By, Bx) and chroma_maps four (cBy, cBx) contiguous uint8 BS maps
    (packed_grids), shared by the frames, and by U and V.  beta, tc: ints,
    the tables' at the QP.  bit_depth=10 (HEVC Main 10): int16 planes of
    samples in [0, 1023], filtered by K2-10 with beta and tc scaled by 4
    and every filtered sample clipped to [0, 1023]
    (LAUNCHES["packed10"]).
    chroma_format="4:2:2": uv (.., 2, h, w/2), the chroma planes of 4:2:2
    frames (e.g. the views of a packed (k, 2h, w) buffer), and chroma_maps
    their (cBy, cBx) = ((h + 8) / 8, (w/2 + 8) / 8) maps, by the same K2 or
    K2-10 (LAUNCHES["packed_422"], LAUNCHES["packed10_422"]).
    chroma_format="4:4:4": uv (.., 2, h, w), the chroma planes of 4:4:4
    frames (e.g. the views of a packed (k, 3h, w) buffer), and chroma_maps
    their ((h + 8) / 8, (w + 8) / 8) maps, the luma grid's, by the same K2
    or K2-10 (LAUNCHES["packed_444"], LAUNCHES["packed10_444"]).
    out: optional (y, uv) destinations of the planes' shapes -- the planes
    themselves for in place.  Returns out, or new contiguous (y, uv); under
    luma_only the chroma is not filtered and uv itself comes back.
    packed_fits must hold for the planes and the destinations (raises
    otherwise; the caller keeps the chain for those).  K2's tiles per
    block are PACKED_TILES, not a parameter.  The launch goes on the current
    stream and does not synchronize.  CPU tensors take the plain version
    (ops/deblock.deblock_packed_plain)."""
    beta, tc = int(beta), int(tc)
    _check_packed(y, uv, luma_maps, chroma_maps, beta, tc, out, bit_depth, chroma_format)
    if y.device.type == "cpu":
        y_new, uv_new = deblock_packed_plain(y, uv, luma_maps, chroma_maps, beta, tc,
                                             luma_only, bit_depth)
        if out is None:
            return y_new, uv_new
        out[0].copy_(y_new)
        if not luma_only:
            out[1].copy_(uv_new)
        return out[0], uv if luma_only else out[1]
    if y.device.type != "cuda":
        raise ValueError(f"deblock_packed_cuda takes CUDA or CPU tensors, got {y.device}")
    if out is None:
        out = (torch.empty(y.shape, dtype=y.dtype, device=y.device),
               uv if luma_only else torch.empty(uv.shape, dtype=y.dtype, device=y.device))
    if y.numel() == 0:
        return out[0], uv if luma_only else out[1]
    lib = _load("cuda", build_library, _setup_cuda)
    err = lib.gvct_deblock_packed(
        *packed_launch_args(y, uv, *out, luma_maps, chroma_maps, beta, tc, luma_only, bit_depth),
        y.device.index, torch.cuda.current_stream(y.device).cuda_stream)
    raise_on_launch(err, lib, "deblock_packed")
    LAUNCHES[PACKED_LAUNCHES[bit_depth, chroma_format]] += 1
    return out[0], uv if luma_only else out[1]


def deblock_packed_info(device=None, bit_depth: int = 8) -> dict:
    """K2's launch (K2-10's at bit_depth 10) on `device` (default: the
    current CUDA device): {"tiles_per_block", "threads", "blocks_per_sm",
    "warps_per_sm", "smem_bytes" (static shared memory per block),
    "registers"}."""
    device = torch.device("cuda", torch.cuda.current_device()) if device is None \
        else torch.device(device)
    lib = _load("cuda", build_library, _setup_cuda)
    info = (ctypes.c_int * 4)()
    raise_on_launch(lib.gvct_deblock_packed_info(device.index, check_bit_depth(bit_depth), info),
                    lib, "occupancy")
    blocks, threads, smem, regs = info
    return {"tiles_per_block": PACKED_TILES, "threads": threads, "blocks_per_sm": blocks,
            "warps_per_sm": blocks * ((threads + 31) // 32), "smem_bytes": smem,
            "registers": regs}

