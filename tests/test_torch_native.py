"""The port's native C++ runtime binding (gpu_video_codec_tpu_torch/runtime)
against the JAX package's (gpu_video_codec_tpu/runtime/native.py) and the
JAX golden oracle, byte for byte.

The port builds its own copy of the JAX package's runtime sources with g++
into build/torch_kernels/ (never with make inside a package), and a failed
build raises NativeRuntimeError: no path falls back to another backend."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

import gpu_video_codec_tpu.models.golden as jgolden
import gpu_video_codec_tpu.utils.bs as jbs
import gpu_video_codec_tpu.utils.yuv as jyuv
from gpu_video_codec_tpu.runtime import native as jnative
from gpu_video_codec_tpu.utils.tiles import plane_to_tiles
from gpu_video_codec_tpu_torch.runtime import native
from gpu_video_codec_tpu_torch.utils.bs import BoundaryStrength
from gpu_video_codec_tpu_torch.utils.yuv import FramePlanes, extend_plane

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SRC = os.path.join(REPO, "gpu_video_codec_tpu", "runtime", "src")


@pytest.fixture(scope="module", autouse=True)
def built():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found")
    native.load()


def _frame(rng, w, h):
    return FramePlanes(
        extend_plane(rng.integers(0, 256, (h, w), dtype=np.uint8)),
        extend_plane(rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)),
        extend_plane(rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)),
        w, h,
    )


def _random_bs(rng, w, h):
    bs = BoundaryStrength.intra_default(w, h)
    bs.set_luma(rng.integers(0, 3, bs.vert.size, dtype=np.uint8),
                rng.integers(0, 3, bs.hor.size, dtype=np.uint8))
    return bs


def _jax(frame, bs):
    jf = jyuv.FramePlanes(frame.y, frame.u, frame.v, frame.width, frame.height)
    jb = jbs.BoundaryStrength(frame.width, frame.height, bs.vert, bs.hor, bs.chroma_vert,
                              bs.chroma_hor)
    return jf, jb


def _same(a, b, what=""):
    for name in ("y", "u", "v"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), (what, name)


@pytest.mark.parametrize("qp", [0, 17, 35, 51])
@pytest.mark.parametrize("w,h", [(64, 48), (40, 24), (88, 72)])
def test_native_matches_jax_native_and_golden(rng, w, h, qp):
    frame = _frame(rng, w, h)
    bs = _random_bs(rng, w, h)
    jf, jb = _jax(frame, bs)
    out = native.deblock_frame_native(frame, bs, qp)
    _same(out, jgolden.deblock_frame_golden(jf, jb, qp), "golden")
    if jnative.available():
        _same(out, jnative.deblock_frame_native(jf, jb, qp), "jax native")


def test_native_multithreaded_deterministic(rng):
    """OpenMP over tile rows must be race-free (tile independence)."""
    w, h = 96, 64
    frame = _frame(rng, w, h)
    bs = BoundaryStrength.intra_default(w, h)
    ref = native.deblock_frame_native(frame, bs, 35, num_threads=1)
    for threads in (2, 4, 8):
        _same(ref, native.deblock_frame_native(frame, bs, 35, num_threads=threads), threads)


def test_native_luma_only_and_inplace(rng):
    w, h = 64, 48
    frame = _frame(rng, w, h)
    bs = BoundaryStrength.intra_default(w, h)
    jf, jb = _jax(frame, bs)
    out = native.deblock_frame_native(frame, bs, 35, luma_only=True)
    assert np.array_equal(out.u, frame.u) and np.array_equal(out.v, frame.v)
    assert np.array_equal(out.y, jgolden.deblock_frame_golden(jf, jb, 35, luma_only=True).y)
    keep = FramePlanes(frame.y.copy(), frame.u.copy(), frame.v.copy(), w, h)
    same = native.deblock_frame_native(frame, bs, 35, inplace=True)
    assert same.y is frame.y
    _same(frame, native.deblock_frame_native(keep, bs, 35))
    with pytest.raises(ValueError, match="inplace"):
        native.deblock_frame_native(FramePlanes(frame.y[:, ::2], frame.u, frame.v, w, h), bs,
                                    35, inplace=True)


def test_native_pack_unpack_roundtrip(rng):
    plane = rng.integers(0, 256, (40, 64), dtype=np.uint8)
    packed = native.pack_tiles_native(plane)
    assert np.array_equal(packed, np.asarray(plane_to_tiles(plane)))
    if jnative.available():
        assert np.array_equal(packed, jnative.pack_tiles_native(plane))
    assert np.array_equal(native.unpack_tiles_native(packed, 40, 64), plane)


def test_native_error_code(rng):
    """The C ABI returns nonzero for invalid geometry; the binding raises."""
    frame = _frame(rng, 64, 48)
    bs = BoundaryStrength.intra_default(64, 48)
    bad = FramePlanes(frame.y, frame.u, frame.v, 50, 50)  # not %8
    with pytest.raises(native.NativeRuntimeError, match="returned 1"):
        native.deblock_frame_native(bad, bs, 35)


def test_native_active_isa_reports_and_overrides(monkeypatch):
    """active_isa() names a valid tier; GVCT_NATIVE_ISA=sse forces SSE4.1
    (read at every call, so one process sees both)."""
    isa = native.active_isa()
    assert isa in ("scalar", "sse4.1", "avx512")
    if isa == "avx512":
        assert native.avx512_compiled()
    monkeypatch.setenv("GVCT_NATIVE_ISA", "sse")
    assert native.active_isa() in ("scalar", "sse4.1")
    if jnative.available():
        assert jnative.active_isa() == native.active_isa()


@pytest.mark.parametrize("w,h", [(8, 8), (16, 16), (24, 16), (64, 48),
                                 (88, 72), (104, 56), (112, 64), (352, 288)])
def test_native_cross_isa_bitexact(rng, monkeypatch, w, h):
    """Where the CPU has AVX-512, the 4-tiles-per-vector sweep equals the
    SSE4.1 tier and the JAX golden oracle (every quad-tail residue, the
    nx < 4 fallback, sheared chroma at 88x72); elsewhere both runs take
    one tier and still meet golden."""
    frame = _frame(rng, w, h)
    bs = _random_bs(rng, w, h)
    jf, jb = _jax(frame, bs)
    for qp in (0, 35, 51):
        gold = jgolden.deblock_frame_golden(jf, jb, qp)
        monkeypatch.delenv("GVCT_NATIVE_ISA", raising=False)
        fast = native.deblock_frame_native(frame, bs, qp)
        monkeypatch.setenv("GVCT_NATIVE_ISA", "sse")
        base = native.deblock_frame_native(frame, bs, qp)
        _same(gold, fast, ("fast", qp))
        _same(base, fast, ("sse", qp))


def test_native_stub_build_never_dispatches_avx512(tmp_path):
    """The port's sources built WITHOUT the AVX-512 flags (the TU compiles
    its stub): dispatch stays below AVX-512 even on an AVX-512 CPU."""
    so = tmp_path / "libgvct_stub.so"
    subprocess.run(
        ["g++", "-O0", "-fPIC", "-fopenmp", "-std=c++17", *native.SSE_FLAGS, "-shared",
         "-o", str(so), str(native.SRC / "deblock_cpu.cpp"),
         str(native.SRC / "deblock_cpu_avx512.cpp")],
        check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.gvct_avx512_compiled.restype = ctypes.c_int
    lib.gvct_active_isa.restype = ctypes.c_int
    assert lib.gvct_avx512_compiled() == 0
    assert lib.gvct_active_isa() != 2


@pytest.mark.parametrize("name", native.SOURCES)
def test_runtime_sources_byte_equal_to_jax_package(name):
    """The port keeps its own copy of the JAX package's runtime sources, in
    lockstep: any edit to one must go to the other."""
    with open(native.SRC / name, "rb") as a, open(os.path.join(JAX_SRC, name), "rb") as b:
        assert a.read() == b.read(), name


def test_native_builds_outside_the_package():
    """The library lives in build/torch_kernels/, named by the sources' and
    flags' hash; nothing is built inside the package (no make, no objects)."""
    path = native.build_library()
    assert path.parent == native.BUILD_DIR and path.name.startswith("libgvct_native_")
    assert sorted(os.listdir(native.SRC)) == sorted(native.SOURCES)
    assert not [f for f in os.listdir(native.SRC.parent) if f.endswith((".so", ".o"))]


def test_failed_build_raises_and_nothing_falls_back(monkeypatch, tmp_path):
    """No g++ (or a failing one): load() raises NativeRuntimeError, and so
    do the native backend, ReadYuvFrame and the CLI; golden is not run."""
    from gpu_video_codec_tpu_torch.cli import main
    from gpu_video_codec_tpu_torch.models import golden
    from gpu_video_codec_tpu_torch.models.pipeline import DeblockPipeline

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)  # nothing built there yet
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.setattr(golden, "deblock_frame_golden",
                        lambda *a, **k: pytest.fail("fell back to golden"))
    with pytest.raises(native.NativeRuntimeError, match="g.. not found"):
        native.load()
    assert not native.available()
    pipe = DeblockPipeline(64, 48, 35, backend="native")
    with pytest.raises(native.NativeRuntimeError):
        pipe(FramePlanes(*(extend_plane(np.zeros(s, np.uint8))
                           for s in ((48, 64), (24, 32), (24, 32))), 64, 48))
    fake = tmp_path / "gxx"
    fake.write_text("#!/bin/sh\necho 'no compiler here' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(native.shutil, "which", lambda name: str(fake))
    with pytest.raises(native.NativeRuntimeError, match="no compiler here"):
        native.build_library()
    inp = tmp_path / "f.yuv"
    inp.write_bytes(bytes(3 * 64 * 48 // 2))
    assert main(["-i", str(inp), "-W", "64", "-H", "48", "--backend", "native"]) == 1
