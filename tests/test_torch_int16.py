"""The int16 compute path of the PyTorch port: ops/filters and ops/deblock
with dtype=torch.int16, and K1-i16, the deblock kernel computing in
int16_t (deblock_tiles_cuda(dtype=torch.int16)).

Here on the CPU: the torch int16 filters and sweep against the JAX
package's dtype=jnp.int16 path and against int32, the frame wrapper on CPU
tensors against the JAX deblock_frame_pallas(dtype=jnp.int16) in interpret
mode, the kernel itself -- the quad kernel of csrc/deblock_quad.cuh at
int16_t, its blocks of TB tiles run on the host by a g++ build of
csrc/host_shim.cpp (gvct_host_deblock_tiles_i16) -- against the plain
version, K1's host build and the JAX deblock_tiles_pallas(dtype=jnp.int16)
in interpret mode at tail, batched and in-place grids, TB 1, 3, 8 and 64
and every staging word, and the int16_probe entry point.
Tests marked `cuda` launch the kernel and skip without a card; JAX is
imported only inside the tests that compare with it, so the `cuda` tests
also run where JAX is not installed
(`python -m pytest tests/test_torch_int16.py -m cuda`).  Every comparison
is byte-equal (all the math is integer)."""

import ctypes
import functools
import shutil

import numpy as np
import pytest
import torch

from gpu_video_codec_tpu_torch.ops import cuda_kernel as ck
from gpu_video_codec_tpu_torch.ops import filters as tf
from gpu_video_codec_tpu_torch.ops.chain import deblock_frame_cuda
from gpu_video_codec_tpu_torch.ops.deblock import deblock_frame, deblock_tiles, deblock_tiles_plain
from gpu_video_codec_tpu_torch.ops.tables import get_beta, get_tc
from gpu_video_codec_tpu_torch.tools import int16_probe
from gpu_video_codec_tpu_torch.utils.bs import (
    BoundaryStrength, chroma_segment_maps, luma_segment_maps,
)
from gpu_video_codec_tpu_torch.utils.tiles import plane_to_tiles
from gpu_video_codec_tpu_torch.utils.yuv import extend_plane

QPS = (18, 35, 51)  # as tests/test_pallas.py::test_int16_compute_bitexact


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


def _planes(rng, w, h):
    return [extend_plane(rng.integers(0, 256, s, dtype=np.uint8))
            for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# -- ops/filters and ops/deblock with dtype=int16, against JAX ------------------

@pytest.mark.parametrize("qp", QPS)
def test_filters_int16_match_jax(rng, qp):
    """luma/chroma_edge_filter and luma_segment_decisions in int16 against
    the JAX package's int16 filters and against int32, on segments whose
    rows mix near-flat steps (both filters fire) with noise."""
    import jax.numpy as jnp

    import gpu_video_codec_tpu.ops.filters as jf

    beta, tc = get_beta(qp), get_tc(qp)
    batch = (6, 9)
    base = rng.integers(30, 226, (1, 1) + batch)
    p = np.clip(base + rng.integers(-4, 5, (4, 4) + batch), 0, 255)
    q = np.clip(base + rng.integers(-12, 13, (1, 1) + batch) + rng.integers(-4, 5, (4, 4) + batch),
                0, 255)
    noisy = rng.random(batch) < 0.3
    p = np.where(noisy, rng.integers(0, 256, p.shape), p).astype(np.uint8)
    q = np.where(noisy, rng.integers(0, 256, q.shape), q).astype(np.uint8)
    bs = rng.integers(0, 3, batch)
    tp, tq = torch.from_numpy(p), torch.from_numpy(q)
    jp, jq = jnp.asarray(p), jnp.asarray(q)
    got = tf.luma_edge_filter(tp, tq, torch.from_numpy(bs > 0), beta, tc, dtype=torch.int16)
    want = jf.luma_edge_filter(jp, jq, jnp.asarray(bs > 0), beta, tc, dtype=jnp.int16)
    i32 = tf.luma_edge_filter(tp, tq, torch.from_numpy(bs > 0), beta, tc)
    for g, w, x in zip(got, want, i32):
        assert g.dtype == torch.int16
        assert np.array_equal(g.numpy(), np.asarray(w)) and torch.equal(g.int(), x)
    assert not torch.equal(got[0].int(), tp.int())
    dec = tf.luma_segment_decisions(tp, tq, beta, tc, dtype=torch.int16)
    jdec = jf.luma_segment_decisions(jp, jq, beta, tc, dtype=jnp.int16)
    for g, w in zip(dec, jdec):
        assert np.array_equal(g.numpy(), np.asarray(w))
    cg = tf.chroma_edge_filter(tp[:, :2], tq[:, :2], torch.from_numpy(bs == 2), tc,
                               dtype=torch.int16)
    cw = jf.chroma_edge_filter(jp[:, :2], jq[:, :2], jnp.asarray(bs == 2), tc, dtype=jnp.int16)
    for g, w in zip(cg, cw):
        assert g.dtype == torch.int16 and np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("qp", QPS)
def test_deblock_tiles_int16_matches_jax_and_int32(rng, qp):
    """deblock_tiles(dtype=torch.int16) == JAX deblock_tiles(dtype=jnp.int16)
    == int32, luma and chroma of a 64x48 frame (tests/test_pallas.py:72-95)."""
    import jax.numpy as jnp

    import gpu_video_codec_tpu.ops.deblock as jd

    w, h = 64, 48
    y, u, _ = _planes(rng, w, h)
    bs = BoundaryStrength.intra_default(w, h)
    beta, tc = get_beta(qp), get_tc(qp)
    for plane, maps, chroma in ((y, luma_segment_maps(bs), False),
                                (u, chroma_segment_maps(bs), True)):
        tiles = plane_to_tiles(torch.from_numpy(plane))
        tm = [torch.from_numpy(m) for m in maps]
        got = deblock_tiles(tiles, *tm, beta, tc, chroma=chroma, dtype=torch.int16)
        want = jd.deblock_tiles(jnp.asarray(tiles.numpy()), *map(jnp.asarray, maps), beta, tc,
                                chroma=chroma, dtype=jnp.int16)
        assert got.dtype == torch.uint8
        assert np.array_equal(got.numpy(), np.asarray(want)), (qp, chroma)
        assert torch.equal(got, deblock_tiles(tiles, *tm, beta, tc, chroma=chroma)), (qp, chroma)


def test_deblock_int16_rejects_other_dtypes():
    t = torch.zeros((8, 8, 2, 3), dtype=torch.uint8)
    m = torch.zeros((2, 3), dtype=torch.uint8)
    for fn in (deblock_tiles, ck.deblock_tiles_cuda):
        with pytest.raises(ValueError, match="dtype"):
            fn(t, m, m, m, m, 36, 4, dtype=torch.int8)
    with pytest.raises(ValueError, match="dtype"):
        deblock_frame(torch.zeros((16, 16), dtype=torch.uint8),
                      torch.zeros((12, 12), dtype=torch.uint8),
                      torch.zeros((12, 12), dtype=torch.uint8),
                      [m[:2, :2]] * 4, [m[:1, :1]] * 4, 36, 4, dtype=torch.float32)


@pytest.mark.parametrize("w,h", [(64, 48), (72, 48)], ids=["64x48", "sheared-72x48"])
def test_frame_cuda_int16_cpu_matches_pallas(rng, w, h):
    """deblock_frame_cuda(dtype=torch.int16) on CPU tensors (its plain
    version) against the JAX deblock_frame_pallas(dtype=jnp.int16) in
    interpret mode; 72x48 has sheared chroma (Q9)."""
    import jax.numpy as jnp

    from gpu_video_codec_tpu.ops.pallas_kernel import deblock_frame_pallas

    qp = 37
    planes = _planes(rng, w, h)
    bs = BoundaryStrength.intra_default(w, h)
    lm, cm = luma_segment_maps(bs), chroma_segment_maps(bs)
    before = dict(ck.LAUNCHES)
    out = deblock_frame_cuda(*map(torch.from_numpy, planes), [torch.from_numpy(m) for m in lm],
                             [torch.from_numpy(m) for m in cm], get_beta(qp), get_tc(qp),
                             dtype=torch.int16)
    assert ck.LAUNCHES == before  # the CPU path launches nothing
    ref = deblock_frame_pallas(*map(jnp.asarray, planes), [jnp.asarray(m) for m in lm],
                               [jnp.asarray(m) for m in cm], get_beta(qp), get_tc(qp),
                               dtype=jnp.int16, interpret=True)
    for a, b in zip(out, ref):
        assert np.array_equal(a.numpy(), np.asarray(b))
    i32 = deblock_frame_cuda(*map(torch.from_numpy, planes), [torch.from_numpy(m) for m in lm],
                             [torch.from_numpy(m) for m in cm], get_beta(qp), get_tc(qp))
    assert all(torch.equal(a, b) for a, b in zip(out, i32))


# -- the kernel's own int16_t arithmetic, built with g++ ----------------------------

@pytest.fixture(scope="module")
def host_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found")
    return ck.load_host_library()


def _host(fn, tiles, maps, beta, tc, chroma):
    out = np.empty_like(tiles)
    nb = tiles.shape[0] if tiles.ndim == 5 else 1
    by, bx = tiles.shape[-2:]
    stride = 0 if tiles.ndim == 5 and maps[0].shape[0] == 1 else by * bx
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    fn(ptr(tiles), ptr(out), *(ptr(m) for m in maps), beta, tc, nb, by, bx, stride, int(chroma))
    return out


@pytest.mark.parametrize("chroma", [False, True])
@pytest.mark.parametrize("form", [((8, 8, 3, 5), (3, 5)), ((2, 8, 8, 6, 9), (1, 6, 9)),
                                  ((3, 8, 8, 4, 7), (3, 4, 7)), ((8, 8, 17, 33), (17, 33))],
                         ids=["2d-tail", "batched-shared", "batched-per-frame", "2d-wide"])
def test_host_int16_tile_math_matches_plain(rng, host_lib, form, chroma):
    """gvct_host_deblock_tiles_i16 (the quad kernel's blocks at int16_t and
    K1-i16's default block, BLOCK_BX tiles) ==
    deblock_tiles_plain(dtype=torch.int16) == K1's int32 host build, over
    random QPs in 0..51."""
    shape, mshape = form
    changed = 0
    for qp in (0, 51, *rng.integers(1, 51, 4)):
        tiles, maps = _tiles(rng, shape), _maps(rng, mshape)
        beta, tc = get_beta(int(qp)), get_tc(int(qp))
        i16 = functools.partial(host_lib.gvct_host_deblock_tiles_i16, ck.BLOCK_BX)
        out = _host(i16, tiles, maps, beta, tc, chroma)
        ref = deblock_tiles_plain(torch.from_numpy(tiles), *map(torch.from_numpy, maps),
                                  beta, tc, chroma=chroma, dtype=torch.int16)
        assert np.array_equal(out, ref.numpy()), qp
        k1 = functools.partial(host_lib.gvct_host_deblock_tiles_quad, ck.BLOCK_BX)
        assert np.array_equal(out, _host(k1, tiles, maps, beta, tc, chroma)), qp
        changed += int((out != tiles).sum())
    assert changed > 0


# (tiles shape, map shape) of the quad's int16 host tests: a 2-D tail grid
# staged in 1-byte words, one whose plane (68 tiles) allows 4-byte words at
# TB 8 and 64, a batch with one shared map and one with per-frame maps
# (8-byte words at TB 8 and 64; at TB 64 a full block and a tail).
I16_GRIDS = {"tail-2x33": ((8, 8, 2, 33), (2, 33)), "words4-2x34": ((8, 8, 2, 34), (2, 34)),
             "batched-shared-3x40": ((2, 8, 8, 3, 40), (1, 3, 40)),
             "batched-per-frame-2x36": ((3, 8, 8, 2, 36), (3, 2, 36))}
I16_TBS = (1, 3, 8, 64)


def _i16_inputs(name, qp, all2=False):
    """The tiles and maps of one case, the same wherever they are made."""
    shape, mshape = I16_GRIDS[name]
    rng = np.random.default_rng([list(I16_GRIDS).index(name), qp, all2])
    maps = ([np.full(mshape, 2, np.uint8) for _ in range(4)] if all2 else _maps(rng, mshape))
    return _tiles(rng, shape), maps


def _quad16(lib, tb, tiles, maps, beta, tc, chroma, out=None):
    """The int16 quad's blocks of tb tiles on the host, into `out` (default:
    a new array)."""
    out = np.empty_like(tiles) if out is None else out
    nb = tiles.shape[0] if tiles.ndim == 5 else 1
    by, bx = tiles.shape[-2:]
    stride = 0 if tiles.ndim == 5 and maps[0].shape[0] == 1 else by * bx
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    assert lib.gvct_host_deblock_tiles_i16(tb, ptr(tiles), ptr(out), *(ptr(m) for m in maps),
                                           beta, tc, nb, by, bx, stride, int(chroma)) == 0
    return out


@pytest.mark.parametrize("tb", I16_TBS)
@pytest.mark.parametrize("chroma", [False, True], ids=["luma", "chroma"])
@pytest.mark.parametrize("grid", list(I16_GRIDS))
def test_host_int16_quad_matches_plain(host_lib, grid, chroma, tb):
    """The quad at int16_t == deblock_tiles_plain(dtype=torch.int16) == the
    quad at int (K1's host build) at the same TB, QP {0,17,30,35,51}, random
    and all-2 maps."""
    changed = 0
    for qp in (0, 17, 30, 35, 51):
        for all2 in (False, True):
            tiles, maps = _i16_inputs(grid, qp, all2)
            beta, tc = get_beta(qp), get_tc(qp)
            out = _quad16(host_lib, tb, tiles, maps, beta, tc, chroma)
            ref = deblock_tiles_plain(torch.from_numpy(tiles), *map(torch.from_numpy, maps),
                                      beta, tc, chroma=chroma, dtype=torch.int16)
            assert np.array_equal(out, ref.numpy()), (qp, all2)
            k1 = functools.partial(host_lib.gvct_host_deblock_tiles_quad, tb)
            assert np.array_equal(out, _host(k1, tiles, maps, beta, tc, chroma)), (qp, all2)
            changed += int((out != tiles).sum())
    assert changed > 0


@pytest.mark.parametrize("chroma", [False, True], ids=["luma", "chroma"])
def test_host_int16_quad_matches_pallas(host_lib, chroma):
    """The JAX package's kernel at dtype=jnp.int16 (interpret mode) on the
    tail grid (8, 8, 2, 33) and the batch with per-frame maps, at every TB."""
    import jax.numpy as jnp

    from gpu_video_codec_tpu.ops.pallas_kernel import deblock_tiles_pallas

    for grid in ("tail-2x33", "batched-per-frame-2x36"):
        for qp in (30, 51):
            tiles, maps = _i16_inputs(grid, qp)
            beta, tc = get_beta(qp), get_tc(qp)
            ref = np.asarray(deblock_tiles_pallas(jnp.asarray(tiles), *map(jnp.asarray, maps),
                                                  beta, tc, chroma=chroma, interpret=True,
                                                  dtype=jnp.int16))
            for tb in I16_TBS:
                out = _quad16(host_lib, tb, tiles, maps, beta, tc, chroma)
                assert np.array_equal(out, ref), (grid, qp, tb)


@pytest.mark.parametrize("tb", I16_TBS)
@pytest.mark.parametrize("chroma", [False, True], ids=["luma", "chroma"])
def test_host_int16_quad_in_place(host_lib, chroma, tb):
    """in == out: a block stages all its bytes before it stores any."""
    for grid in ("tail-2x33", "batched-shared-3x40"):
        tiles, maps = _i16_inputs(grid, 35)
        beta, tc = get_beta(35), get_tc(35)
        buf = tiles.copy()
        _quad16(host_lib, tb, buf, maps, beta, tc, chroma, out=buf)
        ref = deblock_tiles_plain(torch.from_numpy(tiles), *map(torch.from_numpy, maps), beta,
                                  tc, chroma=chroma, dtype=torch.int16)
        assert np.array_equal(buf, ref.numpy()), grid


def test_int16_grids_cover_every_word_size(host_lib):
    """The staging word (1, 4 or 8 bytes) the kernel picks over I16_GRIDS
    and I16_TBS: every size is tested."""
    seen = set()
    for shape, _ in I16_GRIDS.values():
        a = np.zeros(shape, np.uint8)
        ptr = a.ctypes.data_as(ctypes.c_void_p)
        seen.update(host_lib.gvct_host_quad_word_bytes(shape[-2] * shape[-1], tb, ptr, ptr)
                    for tb in I16_TBS)
    assert seen == {1, 4, 8}


# -- the entry point and the no-fallback rule -----------------------------------------

def test_int16_probe_entry_point_cpu(capsys):
    res = int16_probe.main(["--device", "cpu"])
    assert res["int16_on_cpu"] == "ok-bitexact" and len(res["cases"]) == 4
    assert all(c["bit_exact"] for c in res["cases"])
    assert all(c["changed"] > 0 for c in res["cases"][1:])
    assert '"int16_on_cpu": "ok-bitexact"' in capsys.readouterr().out


def test_cuda_tensor_without_library_raises(monkeypatch, tmp_path):
    """A CUDA tensor whose kernel library cannot be built raises; it never
    takes the plain version (fake CUDA tensors stand in for a card)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(ck, "DEFAULT_NVCC", tmp_path / "nvcc")
    monkeypatch.setattr(ck, "_libs", {})

    def no_plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor took the plain version")

    monkeypatch.setattr(ck, "deblock_tiles_plain", no_plain)
    with FakeTensorMode():
        t = torch.empty((8, 8, 3, 4), dtype=torch.uint8, device="cuda")
        m = torch.empty((3, 4), dtype=torch.uint8, device="cuda")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            ck.deblock_tiles_cuda(t, m, m, m, m, 36, 4, dtype=torch.int16)


# -- on the card -------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("chroma", [False, True])
@pytest.mark.parametrize("form", [((8, 8, 3, 5), (3, 5)), ((2, 8, 8, 6, 9), (1, 6, 9)),
                                  ((8, 8, 136, 241), (136, 241)),
                                  ((8, 8, 136, 256), (136, 256)),
                                  ((3, 8, 8, 2, 65), (3, 2, 65))],
                         ids=["2d-tail", "batched-shared", "1080p-luma-grid", "race-grid",
                              "tail-batched-per-frame"])
def test_int16_kernel_matches_plain_and_k1_on_card(rng, cuda_device, form, chroma):
    shape, mshape = form
    key = ("chroma" if chroma else "luma") + "_i16"
    for qp in (0, 17, 30, 35, 51):
        tiles = torch.from_numpy(_tiles(rng, shape)).to(cuda_device)
        maps = [torch.from_numpy(m).to(cuda_device) for m in _maps(rng, mshape)]
        beta, tc = get_beta(qp), get_tc(qp)
        before = ck.LAUNCHES[key]
        out = ck.deblock_tiles_cuda(tiles, *maps, beta, tc, chroma=chroma, dtype=torch.int16)
        assert ck.LAUNCHES[key] == before + 1
        ref = deblock_tiles_plain(tiles, *maps, beta, tc, chroma=chroma, dtype=torch.int16)
        k1 = ck.deblock_tiles_cuda(tiles, *maps, beta, tc, chroma=chroma)
        torch.cuda.synchronize()
        assert torch.equal(out, ref) and torch.equal(out, k1), qp


@pytest.mark.cuda
def test_int16_frame_and_probe_on_card(rng, cuda_device):
    w, h, qp = 88, 72, 35
    planes = [torch.from_numpy(p).to(cuda_device) for p in _planes(rng, w, h)]
    bs = BoundaryStrength.intra_default(w, h)
    lm = [torch.from_numpy(m).to(cuda_device) for m in luma_segment_maps(bs)]
    cm = [torch.from_numpy(m).to(cuda_device) for m in chroma_segment_maps(bs)]
    before = dict(ck.LAUNCHES)
    out = deblock_frame_cuda(*planes, lm, cm, get_beta(qp), get_tc(qp), dtype=torch.int16)
    assert {k: ck.LAUNCHES[k] - before[k] for k in before} == {
        "luma": 0, "chroma": 0, "luma_i16": 1, "chroma_i16": 1, "rows": 0, "packed": 0,
        "packed10": 0, "packed_422": 0, "packed10_422": 0, "packed_444": 0, "packed10_444": 0}
    ref = deblock_frame(*planes, lm, cm, get_beta(qp), get_tc(qp), dtype=torch.int16)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert int16_probe.main([])["int16_on_gpu"] == "ok-bitexact"
