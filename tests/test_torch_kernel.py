"""The CUDA deblock kernel of the PyTorch port (K1 luma, K1c chroma).

Here on the CPU: the deblock_tiles_cuda wrapper on CPU tensors (its plain
version) against the JAX deblock_tiles_pallas in interpret mode, the
wrapper's checks, and the kernel's own math and indexing
(csrc/deblock_quad.cuh over csrc/deblock_tile.cuh) compiled with g++
through csrc/host_shim.cpp (tests/test_torch_quad.py holds it at more
geometries).
Tests marked `cuda` launch the kernel itself and skip without a card;
they import nothing of JAX, so they also run where JAX is not installed
(`python -m pytest tests/test_torch_kernel.py -m cuda`).  Every comparison
is byte-equal."""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from gpu_video_codec_tpu_torch.models.streaming import StreamingDeblocker
from gpu_video_codec_tpu_torch.ops import chain
from gpu_video_codec_tpu_torch.ops import cuda_kernel as ck
from gpu_video_codec_tpu_torch.ops.chain import deblock_frame_cuda
from gpu_video_codec_tpu_torch.ops.deblock import deblock_frame, deblock_tiles_plain
from gpu_video_codec_tpu_torch.ops.tables import get_beta, get_tc
from gpu_video_codec_tpu_torch.utils.bs import (
    BoundaryStrength, chroma_segment_maps, luma_segment_maps,
)
from gpu_video_codec_tpu_torch.utils.yuv import extend_plane

QPS = (0, 17, 30, 35, 51)


def _tiles(rng, shape):
    """uint8 tile-planes mixing flat blocks with small steps (so strong and
    normal filters fire) and uniform noise."""
    flat = rng.integers(40, 216, shape[:-4] + (1, 1) + shape[-2:])
    t = flat + rng.integers(-3, 4, shape)
    t[..., 4:, :, :, :] += rng.integers(-20, 21, shape[:-4] + (1, 1) + shape[-2:])
    noisy = rng.random(shape[:-4] + (1, 1) + shape[-2:]) < 0.25
    t = np.where(noisy, rng.integers(0, 256, shape), t)
    return np.clip(t, 0, 255).astype(np.uint8)


def _maps(rng, shape):
    return [rng.integers(0, 3, shape, dtype=np.uint8) for _ in range(4)]


# (tiles shape, map shape): a 2-D tail grid, a batch with one shared map,
# a batch with per-frame maps
FORMS = [((8, 8, 3, 5), (3, 5)), ((2, 8, 8, 6, 9), (1, 6, 9)), ((3, 8, 8, 4, 7), (3, 4, 7))]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("chroma", [False, True])
@pytest.mark.parametrize("form", FORMS, ids=["2d-tail", "batched-shared", "batched-per-frame"])
def test_wrapper_cpu_matches_pallas(rng, form, chroma):
    import jax.numpy as jnp

    from gpu_video_codec_tpu.ops.pallas_kernel import deblock_tiles_pallas

    shape, mshape = form
    tiles = _tiles(rng, shape)
    maps = _maps(rng, mshape)
    before = dict(ck.LAUNCHES)
    for qp in (17, 35, 51):
        beta, tc = get_beta(qp), get_tc(qp)
        out = ck.deblock_tiles_cuda(torch.from_numpy(tiles), *map(torch.from_numpy, maps),
                                    beta, tc, chroma=chroma)
        ref = deblock_tiles_pallas(jnp.asarray(tiles), *map(jnp.asarray, maps), beta, tc,
                                   chroma=chroma)
        assert out.shape == tiles.shape and out.dtype == torch.uint8
        assert np.array_equal(out.numpy(), np.asarray(ref)), qp
    assert ck.LAUNCHES == before  # the CPU path launches nothing


def test_wrapper_rejects_bad_operands():
    t = torch.zeros((8, 8, 3, 5), dtype=torch.uint8)
    m = torch.zeros((3, 5), dtype=torch.uint8)
    ok = (m, m, m, m)
    with pytest.raises(ValueError, match="contiguous"):
        ck.deblock_tiles_cuda(t.transpose(2, 3).contiguous().transpose(2, 3), *ok, 6, 1)
    with pytest.raises(ValueError, match="uint8"):
        ck.deblock_tiles_cuda(t.to(torch.int32), *ok, 6, 1)
    with pytest.raises(ValueError):
        ck.deblock_tiles_cuda(t[0], *ok, 6, 1)
    with pytest.raises(ValueError):
        ck.deblock_tiles_cuda(t, m[:2], m, m, m, 6, 1)
    with pytest.raises(ValueError):
        ck.deblock_tiles_cuda(t, m.to(torch.int32), m, m, m, 6, 1)
    with pytest.raises(ValueError):
        ck.deblock_tiles_cuda(t, *ok, -1, 1)
    tb = torch.zeros((2, 8, 8, 3, 5), dtype=torch.uint8)
    shared, per = m[None], torch.zeros((2, 3, 5), dtype=torch.uint8)
    with pytest.raises(ValueError, match="one shape"):
        ck.deblock_tiles_cuda(tb, shared, per, per, per, 6, 1)
    with pytest.raises(ValueError):
        ck.deblock_tiles_cuda(tb, *ok, 6, 1)  # batched tiles need 3-D maps
    with pytest.raises(ValueError):
        ck.deblock_tiles_cuda(t.to("meta"), *(x.to("meta") for x in ok), 6, 1)


@pytest.mark.parametrize("w,h", [(64, 72), (88, 72), (352, 288)])
def test_frame_and_chroma_ext_cpu_match_jax(rng, w, h):
    """deblock_frame_cuda (sheared chroma through the chain's flat view for
    88x72) on CPU tensors against the JAX deblock_frame."""
    import jax.numpy as jnp

    import gpu_video_codec_tpu.ops.deblock as jdeblock

    qp = 37
    planes = [extend_plane(rng.integers(0, 256, s, dtype=np.uint8))
              for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    bs = BoundaryStrength.intra_default(w, h)
    lm, cm = luma_segment_maps(bs), chroma_segment_maps(bs)
    out = deblock_frame_cuda(*map(torch.from_numpy, planes),
                             [torch.from_numpy(m) for m in lm],
                             [torch.from_numpy(m) for m in cm], get_beta(qp), get_tc(qp))
    ref = jdeblock.deblock_frame(*map(jnp.asarray, planes), [jnp.asarray(m) for m in lm],
                                 [jnp.asarray(m) for m in cm], get_beta(qp), get_tc(qp))
    for a, b in zip(out, ref):
        assert np.array_equal(a.numpy(), np.asarray(b))
    y_only = deblock_frame_cuda(*map(torch.from_numpy, planes),
                                [torch.from_numpy(m) for m in lm],
                                [torch.from_numpy(m) for m in cm], get_beta(qp), get_tc(qp),
                                luma_only=True)
    assert torch.equal(y_only[0], out[0]) and np.array_equal(y_only[1].numpy(), planes[1])


@pytest.mark.parametrize("luma_only", [False, True], ids=["full", "luma_only"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int16], ids=["int32", "int16"])
@pytest.mark.parametrize("w,h", [(64, 72), (88, 72)], ids=["64x72", "sheared-88x72"])
def test_frame_cuda_goes_through_t2_t3(rng, monkeypatch, w, h, dtype, luma_only):
    """deblock_frame_cuda relayouts with T2 and T3 (plane_to_tiles_cuda,
    tiles_to_plane_cuda, as ops/chain.KERNELS holds them) -- once each for
    luma, once per plane for U and V -- and, outside the kernels' wrappers, never
    with the plain relayout (utils/tiles.py's plane_to_tiles,
    tiles_to_plane and join_covered, the relayout kernels' plain versions)
    or a torch.stack / torch.cat of the planes.  The path is the same on
    the CPU and on the card, where the wrappers launch the kernels instead
    of their plain versions; the bytes equal the JAX deblock_frame's."""
    import jax.numpy as jnp

    import gpu_video_codec_tpu.ops.deblock as jdeblock
    from gpu_video_codec_tpu_torch.ops import relayout_kernel as rk
    from gpu_video_codec_tpu_torch.utils import tiles as ut

    calls = {"T2": 0, "T3": 0, "deblock": 0}
    inside = [0]  # wrappers entered and not yet left

    def spy(name, fn):
        def counted(*args, **kwargs):
            calls[name] += 1
            inside[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                inside[0] -= 1
        return counted

    def wrappers_only(name, fn):
        def guarded(*args, **kwargs):
            assert inside[0], f"the frame path called {name} outside the kernels' wrappers"
            return fn(*args, **kwargs)
        return guarded

    t2, t3, t4, k1 = chain.KERNELS["cuda"]
    monkeypatch.setitem(chain.KERNELS, "cuda",
                        (spy("T2", t2), spy("T3", t3), t4, spy("deblock", k1)))
    for mod, name in ((ut, "plane_to_tiles"), (ut, "tiles_to_plane"), (ut, "join_covered"),
                      (rk, "plane_to_tiles_plain"), (rk, "tiles_to_plane_plain"),
                      (torch, "stack"), (torch, "cat")):
        monkeypatch.setattr(mod, name, wrappers_only(name, getattr(mod, name)))
    qp = 37
    planes = [extend_plane(rng.integers(0, 256, s, dtype=np.uint8))
              for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    bs = BoundaryStrength.intra_default(w, h)
    lm, cm = luma_segment_maps(bs), chroma_segment_maps(bs)
    out = deblock_frame_cuda(*map(torch.from_numpy, planes),
                             [torch.from_numpy(m) for m in lm],
                             [torch.from_numpy(m) for m in cm], get_beta(qp), get_tc(qp),
                             luma_only=luma_only, dtype=dtype)
    ref = jdeblock.deblock_frame(*map(jnp.asarray, planes), [jnp.asarray(m) for m in lm],
                                 [jnp.asarray(m) for m in cm], get_beta(qp), get_tc(qp),
                                 luma_only=luma_only)
    for a, b in zip(out, ref):
        assert np.array_equal(a.numpy(), np.asarray(b))
    per_frame = 1 if luma_only else 3
    assert calls == {"T2": per_frame, "T3": per_frame, "deblock": 1 if luma_only else 2}


def test_missing_nvcc_names_the_command(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(ck, "DEFAULT_NVCC", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc .*deblock_kernel.cu"):
        ck.build_library()


# -- the kernel's own arithmetic, built with g++ -------------------------------

@pytest.fixture(scope="module")
def host_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found")
    return ck.load_host_library()


def _host_deblock(lib, tiles, maps, beta, tc, chroma):
    """Run K1/K1c's blocks (the quad kernel, the default block size) over a
    tile-planes array on the host, with the CUDA grid's own indexing."""
    out = np.empty_like(tiles)
    nb = tiles.shape[0] if tiles.ndim == 5 else 1
    by, bx = tiles.shape[-2:]
    stride = 0 if tiles.ndim == 5 and maps[0].shape[0] == 1 else by * bx
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    assert lib.gvct_host_deblock_tiles_quad(ck.BLOCK_BX, ptr(tiles), ptr(out),
                                            *(ptr(m) for m in maps), beta, tc, nb, by, bx,
                                            stride, int(chroma)) == 0
    return out


@pytest.mark.parametrize("chroma", [False, True])
@pytest.mark.parametrize("form", FORMS + [((8, 8, 17, 33), (17, 33))],
                         ids=["2d-tail", "batched-shared", "batched-per-frame", "2d-wide"])
def test_host_tile_math_matches_plain(rng, host_lib, form, chroma):
    shape, mshape = form
    changed = 0
    for qp in QPS:
        tiles = _tiles(rng, shape)
        maps = _maps(rng, mshape)
        beta, tc = get_beta(qp), get_tc(qp)
        out = _host_deblock(host_lib, tiles, maps, beta, tc, chroma)
        ref = deblock_tiles_plain(torch.from_numpy(tiles), *map(torch.from_numpy, maps),
                                  beta, tc, chroma=chroma)
        assert np.array_equal(out, ref.numpy()), qp
        changed += int((out != tiles).sum())
    assert changed > 0


def test_host_tile_math_in_place(rng, host_lib):
    """in == out is allowed: a block stages all its tiles before it stores
    any, and a tile's segments never leave the tile."""
    tiles = _tiles(rng, (8, 8, 5, 6))
    maps = _maps(rng, (5, 6))
    ref = _host_deblock(host_lib, tiles, maps, 64, 20, False)
    buf = tiles.copy()
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    host_lib.gvct_host_deblock_tiles_quad(ck.BLOCK_BX, ptr(buf), ptr(buf),
                                          *(ptr(m) for m in maps), 64, 20, 1, 5, 6, 30, 0)
    assert np.array_equal(buf, ref)


def test_host_build_is_cached(host_lib):
    path, log = ck._build(["g++", "-std=c++17", "-O2", "-shared", "-fPIC"],
                          ck._HOST_SOURCES, "libgvct_host")
    assert path.is_file() and log == ""
    assert path.parent == ck.BUILD_DIR


# -- on the card -------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("chroma", [False, True])
@pytest.mark.parametrize("form", FORMS + [((8, 8, 136, 241), (136, 241)),
                                          ((2, 8, 8, 68, 121), (1, 68, 121))],
                         ids=["2d-tail", "batched-shared", "batched-per-frame",
                              "1080p-luma", "1080p-chroma"])
def test_kernel_matches_plain_on_card(rng, cuda_device, form, chroma):
    shape, mshape = form
    for qp in QPS:
        tiles = torch.from_numpy(_tiles(rng, shape)).to(cuda_device)
        maps = [torch.from_numpy(m).to(cuda_device) for m in _maps(rng, mshape)]
        beta, tc = get_beta(qp), get_tc(qp)
        before = ck.LAUNCHES["chroma" if chroma else "luma"]
        out = ck.deblock_tiles_cuda(tiles, *maps, beta, tc, chroma=chroma)
        assert ck.LAUNCHES["chroma" if chroma else "luma"] == before + 1
        ref = deblock_tiles_plain(tiles, *maps, beta, tc, chroma=chroma)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), qp


@pytest.mark.cuda
def test_frame_cuda_matches_plain_on_card(rng, cuda_device):
    w, h, qp = 88, 72, 35
    planes = [torch.from_numpy(extend_plane(rng.integers(0, 256, s, dtype=np.uint8)))
              .to(cuda_device) for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    bs = BoundaryStrength.intra_default(w, h)
    lm = [torch.from_numpy(m).to(cuda_device) for m in luma_segment_maps(bs)]
    cm = [torch.from_numpy(m).to(cuda_device) for m in chroma_segment_maps(bs)]
    from gpu_video_codec_tpu_torch.ops import relayout_kernel as rk

    before = {**ck.LAUNCHES, **rk.LAUNCHES}
    out = deblock_frame_cuda(*planes, lm, cm, get_beta(qp), get_tc(qp))
    after = {**ck.LAUNCHES, **rk.LAUNCHES}
    ran = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert ran == {"fwd": 3, "luma": 1, "chroma": 1, "inv": 3}  # T2, K1, K1c, T3
    ref = deblock_frame(*planes, lm, cm, get_beta(qp), get_tc(qp))
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("w,h", [(64, 72), (88, 72), (1920, 1080)])
@pytest.mark.parametrize("luma_only", [False, True])
def test_streaming_on_card_matches_plain(rng, cuda_device, w, h, luma_only):
    """The packed stream through the kernels equals the plain backend on the
    card, with one K2 launch per frame where its guard takes the width, and
    elsewhere (88x72) one luma launch and (unless luma_only) one chroma
    launch per frame."""
    raws = [rng.integers(0, 256, 3 * w * h // 2, dtype=np.uint8) for _ in range(3)]
    s = StreamingDeblocker(w, h, 35, luma_only=luma_only, device=cuda_device)
    before = dict(ck.LAUNCHES)
    outs = list(s.run(raws))
    k2 = ck.packed_fits(w)
    assert ck.LAUNCHES["packed"] - before["packed"] == (len(raws) if k2 else 0)
    assert ck.LAUNCHES["luma"] - before["luma"] == (0 if k2 else len(raws))
    assert ck.LAUNCHES["chroma"] - before["chroma"] == (0 if luma_only or k2 else len(raws))
    ref = StreamingDeblocker(w, h, 35, backend="torch", luma_only=luma_only,
                             device=cuda_device)
    for o, r in zip(outs, ref.run(raws)):
        assert np.array_equal(o, r)
