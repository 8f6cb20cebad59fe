"""ctypes binding of the native C++ CPU runtime (the `native` backend).

Counterpart of gpu_video_codec_tpu/runtime/native.py, over the port's own
copy of its sources (runtime/src/: deblock_core.h, deblock_cpu.cpp,
deblock_cpu_avx512.cpp, byte for byte the JAX package's; plain C ABI, no
framework in them).  It is the reference's OpenMP CPU path (ExecuteCpu,
main.cu:36-83) and the plane <-> tile-planes packers.

The library is built at first use with g++ straight into the gitignored
build/torch_kernels/ beside the package (never inside it), with the JAX
package's Makefile flags: -O3 -fPIC -fopenmp -std=c++17 -Wall, -msse4.1 on
x86_64, and the AVX-512 flags for deblock_cpu_avx512.cpp alone (it is only
entered after a cpuid check, so the library loads on any x86_64).  The
name is keyed on a hash of the sources and flags, so an edit or a flag
change rebuilds.  A failed build or load raises NativeRuntimeError: nothing
falls back to another backend.  GVCT_NATIVE_ISA=sse forces the SSE4.1 tier
(read by the library at every filter call).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import weakref
from pathlib import Path

import numpy as np

from ..ops.cuda_kernel import BUILD_DIR
from ..ops.tables import SAMPLE_BLOCK_SIZE
from ..utils.bs import BoundaryStrength
from ..utils.yuv import FramePlanes

SRC = Path(__file__).resolve().parent / "src"
SOURCES = ("deblock_core.h", "deblock_cpu.cpp", "deblock_cpu_avx512.cpp")
CXXFLAGS = ("-O3", "-fPIC", "-fopenmp", "-std=c++17", "-Wall")
_X86 = platform.machine() in ("x86_64", "AMD64")
SSE_FLAGS = ("-msse4.1",) if _X86 else ()
AVX512_FLAGS = ("-mavx512f", "-mavx512bw", "-mavx512vl", "-mavx512vbmi") if _X86 else ()


class NativeRuntimeError(RuntimeError):
    pass


_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _run(cmd: list[str]) -> None:
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise NativeRuntimeError(f"failed to build the native runtime: {e}") from e
    except subprocess.CalledProcessError as e:
        raise NativeRuntimeError(f"failed to build the native runtime: {' '.join(cmd)}\n"
                                 f"{e.stdout}{e.stderr}") from e


def build_library() -> Path:
    """Build the runtime with g++ into build/torch_kernels/ (no-op when a
    library of these sources and flags exists).  Returns its path."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeRuntimeError("failed to build the native runtime: g++ not found on PATH")
    base = [*CXXFLAGS, *SSE_FLAGS]
    h = hashlib.sha256(" ".join([*base, "|", *AVX512_FLAGS]).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC / name).read_bytes())
    out = BUILD_DIR / f"libgvct_native_{h.hexdigest()[:16]}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # objects and library under private names, then a rename: a concurrent
    # loader never sees a half-written library
    tag = f"{os.getpid()}.{threading.get_ident()}"
    objs = [BUILD_DIR / f"{out.stem}.{tag}.{i}.o" for i in range(2)]
    tmp = out.with_name(f"{out.name}.{tag}.tmp")
    try:
        _run([cxx, *base, "-c", "-o", str(objs[0]), str(SRC / "deblock_cpu.cpp")])
        _run([cxx, *base, *AVX512_FLAGS, "-c", "-o", str(objs[1]),
              str(SRC / "deblock_cpu_avx512.cpp")])
        _run([cxx, *base, "-shared", "-o", str(tmp), *map(str, objs)])
        os.replace(tmp, out)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return out


def load() -> ctypes.CDLL:
    """Load (building if needed) the native runtime library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = build_library()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise NativeRuntimeError(f"failed to load the native runtime {path}: {e}") from e
        # plain void* for the pixel/BS buffers: _u8ptr passes raw addresses
        u8p = ctypes.c_void_p
        lib.gvct_version.restype = ctypes.c_int
        lib.gvct_num_threads.restype = ctypes.c_int
        lib.gvct_active_isa.restype = ctypes.c_int
        lib.gvct_avx512_compiled.restype = ctypes.c_int
        lib.gvct_deblock_frame.restype = ctypes.c_int
        lib.gvct_deblock_frame.argtypes = [
            u8p, u8p, u8p, ctypes.c_int, ctypes.c_int,
            u8p, ctypes.c_longlong, u8p, ctypes.c_longlong,
            u8p, ctypes.c_longlong, u8p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.gvct_pack_tiles.restype = None
        lib.gvct_pack_tiles.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p]
        lib.gvct_unpack_tiles.restype = None
        lib.gvct_unpack_tiles.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p]
        _lib = lib
        return lib


def available() -> bool:
    try:
        load()
        return True
    except NativeRuntimeError:
        return False


def active_isa() -> str:
    """Active native SIMD tier: 'scalar', 'sse4.1', or 'avx512' (the
    4-tiles-per-vector sweep, cpuid-gated).  GVCT_NATIVE_ISA=sse forces
    SSE4.1; the library reads it at every call, so one process can flip it.
    All tiers are bit-identical."""
    return {0: "scalar", 1: "sse4.1", 2: "avx512"}[load().gvct_active_isa()]


def avx512_compiled() -> bool:
    """Whether the AVX-512 translation unit compiled its kernels (not its
    stub).  Dispatch ANDs this into the cpuid check, so active_isa() never
    reports 'avx512' while the stub is linked."""
    return bool(load().gvct_avx512_compiled())


_ptr_cache: dict[int, int] = {}


def _u8ptr(a: np.ndarray) -> int:
    """Raw data address of `a`, cached by object identity (numpy's .ctypes
    costs 1-2 µs an access).  The entry is evicted by a weakref finalizer
    at the array's deallocation, before its id can be reused.

    LIFETIME: a bare int keeps nothing alive through the FFI call.  A caller
    holds a strong reference to `a` across the native call and never passes
    a temporary (`_u8ptr(np.ascontiguousarray(x))` is a use-after-free), and
    does not resize() a cached array in place.  Arrays the wrapper itself
    just allocated go through _u8ptr_fresh."""
    k = id(a)
    p = _ptr_cache.get(k)
    if p is None:
        _ptr_cache[k] = p = a.ctypes.data
        weakref.finalize(a, _ptr_cache.pop, k, None)
    return p


def _u8ptr_fresh(a: np.ndarray) -> int:
    """Raw address of a freshly allocated array, uncached (same lifetime
    rules as _u8ptr)."""
    return a.ctypes.data


def deblock_frame_native(frame: FramePlanes, bs: BoundaryStrength, qp: int,
                         luma_only: bool = False, num_threads: int = 0,
                         inplace: bool = False) -> FramePlanes:
    """Deblock extended planes with the C++ OpenMP runtime.

    num_threads = 0 keeps the OpenMP default (the reference sweeps 1/2/4/6/8,
    cpu.h:135 / main.cu:40-82).  inplace=True filters the frame's own plane
    buffers (writable C-contiguous uint8); inplace=False returns a new
    FramePlanes and leaves the input untouched.  Raises NativeRuntimeError
    when the library cannot be built or loaded or the call fails."""
    lib = load()
    if inplace:
        y, u, v = frame.y, frame.u, frame.v
        for name, a in (("y", y), ("u", u), ("v", v)):
            if not (isinstance(a, np.ndarray) and a.dtype == np.uint8
                    and a.flags["C_CONTIGUOUS"] and a.flags["WRITEABLE"]):
                raise ValueError(f"inplace deblock needs writable C-contiguous "
                                 f"uint8 planes; plane {name} is not")
    else:
        y = np.ascontiguousarray(frame.y, dtype=np.uint8).copy()
        u = np.ascontiguousarray(frame.u, dtype=np.uint8).copy()
        v = np.ascontiguousarray(frame.v, dtype=np.uint8).copy()
    # planes cached only when the caller reuses them (inplace); BS arrays
    # are stable attributes, always cached
    plane_ptr = _u8ptr if inplace else _u8ptr_fresh
    rc = lib.gvct_deblock_frame(
        plane_ptr(y), plane_ptr(u), plane_ptr(v), frame.width, frame.height,
        _u8ptr(bs.vert), bs.vert.size, _u8ptr(bs.hor), bs.hor.size,
        _u8ptr(bs.chroma_vert), bs.chroma_vert.size,
        _u8ptr(bs.chroma_hor), bs.chroma_hor.size,
        int(qp), int(luma_only), int(num_threads),
    )
    if rc != 0:
        raise NativeRuntimeError(f"gvct_deblock_frame returned {rc}")
    return FramePlanes(y=y, u=u, v=v, width=frame.width, height=frame.height)


def pack_tiles_native(plane: np.ndarray) -> np.ndarray:
    """(Hext, Wext) uint8 -> (8, 8, By, Bx) with the native packer."""
    lib = load()
    plane = np.ascontiguousarray(plane, dtype=np.uint8)
    h, w = plane.shape
    ny, nx = h // SAMPLE_BLOCK_SIZE, w // SAMPLE_BLOCK_SIZE
    out = np.empty((SAMPLE_BLOCK_SIZE, SAMPLE_BLOCK_SIZE, ny, nx), np.uint8)
    lib.gvct_pack_tiles(_u8ptr_fresh(plane), h, w, _u8ptr_fresh(out))
    return out


def unpack_tiles_native(tiles: np.ndarray, hext: int, wext: int) -> np.ndarray:
    """(8, 8, By, Bx) -> (Hext, Wext); an uncovered remainder (if any) is 0."""
    lib = load()
    tiles = np.ascontiguousarray(tiles, dtype=np.uint8)
    out = np.zeros((hext, wext), np.uint8)
    lib.gvct_unpack_tiles(_u8ptr_fresh(tiles), hext, wext, _u8ptr_fresh(out))
    return out
