"""The relayout and pack kernels of the PyTorch port (T2 plane -> tile-planes,
T3 tile-planes -> plane, T4 YV12 pack).

Here on the CPU: the wrappers on CPU tensors (their plain versions) against
the JAX tools' own Pallas kernels in interpret mode and against
gpu_video_codec_tpu.utils.tiles, the wrappers' checks, and the kernels' own
block loops and addressing (csrc/relayout_tile.cuh) compiled with g++
through csrc/host_shim.cpp, fed the wrappers' own launch arguments.  Tests
marked `cuda` launch the kernels and skip without a card; this file imports
nothing of JAX at module level, so they also run where JAX is not installed
(`python -m pytest tests/test_torch_relayout.py -m cuda`).  Every
comparison is byte-equal."""

import math
import shutil

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gpu_video_codec_tpu_torch.ops import relayout_kernel as rk
from gpu_video_codec_tpu_torch.utils.tiles import split_covered_data

# (lead, h, w, pad, extra grid rows, extra grid cols): luma; U+V with
# h % 8 == 4 (covered rows truncated, as at 1080p chroma); a tail grid
# padded past the covered tiles; a frame batch of U+V pairs
FORMS = [((), 48, 64, 4, 0, 0), ((2,), 36, 32, 4, 0, 0), ((), 16, 32, 4, 2, 3),
         ((3, 2), 20, 16, 4, 0, 0)]
FORM_IDS = ["luma", "uv-truncated", "tail-grid", "batched-uv"]


def _covered(n, pad):
    return (n + 2 * pad) // 8


def _grid(h, w, pad, ey, ex):
    return _covered(h, pad) + ey, _covered(w, pad) + ex


def _plane(rng, lead, h, w):
    return torch.from_numpy(rng.integers(0, 256, (*lead, h, w), dtype=np.uint8))


def _uv_stacked_out(lead, byg, bxg, device="cpu"):
    """A T2 destination that puts the innermost batch axis between (8, 8)
    and the grid: (.., 8, 8, m, By, Bx) storage, viewed as (.., m, 8, 8,
    By, Bx) -- how the resident path lands U and V in one launch."""
    n = len(lead) - 1
    buf = torch.zeros((*lead[:-1], 8, 8, lead[-1], byg, bxg), dtype=torch.uint8, device=device)
    return buf, buf.movedim(n + 2, n)


# -- the plain versions against the JAX tools' Pallas kernels -------------------

@pytest.mark.parametrize("rows,wg", [(64, 64), (128, 248)])
def test_plain_relayout_matches_pallas_tools(rng, rows, wg):
    """T2/T3 with pad 0 and an exact grid are the tools' fwd_inkernel and
    inv_inkernel (out[r, c, by, bx] = x[8by + r, 8bx + c])."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from tools import kernel_relayout_exp as kre

    x = rng.integers(0, 256, (rows, wg), dtype=np.uint8)
    tiles = rng.integers(0, 256, (8, 8, rows // 8, wg // 8), dtype=np.uint8)
    q = np.zeros((64, 64), np.int8)  # r-major rows -> plane rows (as the tool's main)
    for k in range(8):
        for r in range(8):
            q[k * 8 + r, r * 8 + k] = 1
    with pltpu.force_tpu_interpret_mode():
        fwd = kre.fwd_inkernel(jnp.asarray(x), jnp.asarray(kre._col_perm(wg)),
                               jnp.asarray(kre._row_picks(64)))
        inv = kre.inv_inkernel(jnp.asarray(tiles), jnp.asarray(kre._col_perm(wg).T.copy()),
                               jnp.asarray(q))
    got = rk.plane_to_tiles_cuda(torch.from_numpy(x), 0)
    assert got.is_contiguous() and np.array_equal(got.numpy(), np.asarray(fwd))
    back = rk.tiles_to_plane_cuda(torch.from_numpy(tiles), 0, rows, wg)
    assert np.array_equal(back.numpy(), np.asarray(inv))


def test_plain_pack_matches_pallas_tool(rng):
    """T4 is the tool's pack_pallas (fixed 1080p plane sizes)."""
    import jax.numpy as jnp

    from tools import pack_exp

    y, u, v = (rng.integers(0, 256, n, dtype=np.uint8)
               for n in (pack_exp.YN, pack_exp.CN, pack_exp.CN))
    ref = pack_exp.pack_pallas(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v))
    got = rk.pack_yv12_cuda(*map(torch.from_numpy, (y, u, v)))
    assert np.array_equal(got.numpy(), np.asarray(ref))


# -- pad and grid forms against gpu_video_codec_tpu.utils.tiles ------------------

@pytest.mark.parametrize("form", FORMS, ids=FORM_IDS)
def test_wrappers_match_jax_tiles(rng, form):
    import gpu_video_codec_tpu.utils.tiles as jt

    lead, h, w, pad, ey, ex = form
    byg, bxg = _grid(h, w, pad, ey, ex)
    x = _plane(rng, lead, h, w)
    ref = jt.interior_to_tiles(x.numpy(), pad, by_grid=byg, bx_grid=bxg)
    t = rk.plane_to_tiles_cuda(x, pad, by_grid=byg, bx_grid=bxg)
    assert t.shape == (*lead, 8, 8, byg, bxg) and np.array_equal(t.numpy(), ref)
    if lead:
        buf, view = _uv_stacked_out(lead, byg, bxg)
        assert rk.plane_to_tiles_cuda(x, pad, by_grid=byg, bx_grid=bxg, out=view) is view
        assert np.array_equal(view.numpy(), ref)
        # the plane axis lands next to By: (.., 8, 8, m, By, Bx)
        assert np.array_equal(buf.numpy(), np.moveaxis(ref, len(lead) - 1, len(lead) + 1))
    tiles = torch.from_numpy(rng.integers(0, 256, (*lead, 8, 8, byg, bxg), dtype=np.uint8))
    back = rk.tiles_to_plane_cuda(tiles, pad, h, w)
    assert back.is_contiguous()
    assert np.array_equal(back.numpy(), jt.tiles_to_interior(tiles.numpy(), pad, h, w))
    assert np.array_equal(rk.tiles_to_plane_cuda(t, pad, h, w).numpy(), x.numpy())


@pytest.mark.parametrize("w,h", [(40, 24), (88, 72)])
def test_sheared_chroma_core_matches_jax(rng, w, h):
    """Sheared chroma (w % 16 == 8): the covered core is a flat view of the
    padded plane; T2 with pad 0 tiles it as the JAX package's plane_to_tiles
    does, and T3 gives it back."""
    import gpu_video_codec_tpu.utils.tiles as jt

    uv = _plane(rng, (2,), h // 2, w // 2)
    core, _ = split_covered_data(F.pad(uv, (4, 4, 4, 4)))
    jcore, _ = jt.split_covered_data(np.pad(uv.numpy(), [(0, 0), (4, 4), (4, 4)]))
    t = rk.plane_to_tiles_cuda(core, 0)
    assert np.array_equal(t.numpy(), jt.plane_to_tiles(jcore))
    assert np.array_equal(rk.tiles_to_plane_cuda(t, 0, *core.shape[-2:]).numpy(), jcore)


def test_1080p_chroma_covers_544_of_548_rows(rng):
    plane = _plane(rng, (2,), 540, 960)
    t = rk.plane_to_tiles_cuda(plane, 4)
    assert t.shape == (2, 8, 8, 68, 121)
    assert np.array_equal(rk.tiles_to_plane_cuda(t, 4, 540, 960).numpy(), plane.numpy())


def test_cpu_path_launches_nothing(rng):
    before = dict(rk.LAUNCHES)
    x = _plane(rng, (), 16, 24)
    t = rk.plane_to_tiles_cuda(x, 4)
    rk.tiles_to_plane_cuda(t, 4, 16, 24)
    flat = torch.zeros(96, dtype=torch.uint8)
    rk.pack_yv12_cuda(flat[:64], flat[64:80], flat[80:])
    assert rk.LAUNCHES == before


def test_wrappers_reject_bad_operands(rng):
    x = _plane(rng, (), 16, 24)
    with pytest.raises(ValueError, match="uint8"):
        rk.plane_to_tiles_cuda(x.to(torch.int32), 4)
    with pytest.raises(ValueError, match="last axis"):
        rk.plane_to_tiles_cuda(x.t(), 4)
    with pytest.raises(ValueError, match="leading batch"):
        rk.plane_to_tiles_cuda(x[None, None, None], 4)
    with pytest.raises(ValueError, match="extended width"):
        rk.plane_to_tiles_cuda(x[:, :20], 4)  # 20 + 8 is not 8-aligned
    with pytest.raises(ValueError, match="smaller than the covered"):
        rk.plane_to_tiles_cuda(x, 4, by_grid=2)
    with pytest.raises(ValueError, match="exceed covered rows"):
        rk.plane_to_tiles_cuda(x[:14], 4)  # 14 + 8 = 22 -> 2 tile rows cover 16 < 4 + 14
    with pytest.raises(ValueError, match="out has shape"):
        rk.plane_to_tiles_cuda(x, 4, out=torch.empty((8, 8, 3, 5), dtype=torch.uint8))
    with pytest.raises(ValueError):
        rk.plane_to_tiles_cuda(x.to("meta"), 4)
    t = rk.plane_to_tiles_cuda(x, 4)
    with pytest.raises(ValueError, match=r"\(\.\., 8, 8, By, Bx\)"):
        rk.tiles_to_plane_cuda(t[:4], 4, 16, 24)
    with pytest.raises(ValueError, match="smaller than the covered"):
        rk.tiles_to_plane_cuda(t, 4, 32, 24)
    flat = torch.zeros(384, dtype=torch.uint8)  # torch's allocations are 64-byte aligned
    with pytest.raises(ValueError, match="multiples of 16"):
        rk.pack_yv12_cuda(flat[:64], flat[1:17], flat[32:48])  # misaligned start
    with pytest.raises(ValueError, match="multiples of 16"):
        rk.pack_yv12_cuda(flat[:60], flat[:15], flat[:15])
    with pytest.raises(ValueError, match="differ in size"):
        rk.pack_yv12_cuda(flat[:64], flat[:16], flat[:32])
    with pytest.raises(ValueError, match="one nb"):
        rk.pack_yv12_cuda(flat[:64], flat[:32].reshape(2, 16), flat[:32].reshape(2, 16))


def test_tiles_to_plane_out(rng):
    """T3's out=: the luma rows and the U/V pair of a packed frame buffer,
    and a view with wider rows, each written in place equal to plain, with
    nothing else touched; bad destinations raise."""
    h, w, p = 24, 48, 4
    buf = torch.from_numpy(rng.integers(0, 256, (3 * h // 2, w), dtype=np.uint8))
    keep = buf.clone()
    yt = torch.from_numpy(rng.integers(0, 256, (8, 8, 4, 7), dtype=np.uint8))
    uvt = torch.from_numpy(rng.integers(0, 256, (2, 8, 8, 2, 4), dtype=np.uint8))
    assert rk.tiles_to_plane_cuda(yt, p, h, w, out=buf[:h]).data_ptr() == buf.data_ptr()
    assert torch.equal(buf[:h], rk.tiles_to_plane_plain(yt, p, h, w))
    assert torch.equal(buf[h:], keep[h:])
    uv = buf[h:].view(2, h // 2, w // 2)
    assert rk.tiles_to_plane_cuda(uvt, p, h // 2, w // 2, out=uv) is uv
    assert torch.equal(uv, rk.tiles_to_plane_plain(uvt, p, h // 2, w // 2))
    wide = torch.zeros((h, w + 5), dtype=torch.uint8)
    rk.tiles_to_plane_cuda(yt, p, h, w, out=wide[:, :w])
    assert torch.equal(wide[:, :w], buf[:h]) and not wide[:, w:].any()
    with pytest.raises(ValueError, match="out has shape"):
        rk.tiles_to_plane_cuda(yt, p, h, w, out=buf[: h - 1])
    with pytest.raises(ValueError, match="out has shape"):
        rk.tiles_to_plane_cuda(uvt, p, h // 2, w // 2, out=buf[:h])
    with pytest.raises(ValueError, match="uint8"):
        rk.tiles_to_plane_cuda(yt, p, h, w, out=torch.empty((h, w), dtype=torch.int32))
    with pytest.raises(ValueError, match="last axis"):
        rk.tiles_to_plane_cuda(yt, p, h, w, out=torch.empty((w, h), dtype=torch.uint8).t())
    with pytest.raises(ValueError, match="expected"):
        rk.tiles_to_plane_cuda(yt, p, h, w, out=torch.empty((h, w), dtype=torch.uint8,
                                                           device="meta"))


def test_missing_nvcc_names_the_relayout_source(monkeypatch, tmp_path):
    from gpu_video_codec_tpu_torch.ops import cuda_kernel as ck

    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(ck, "DEFAULT_NVCC", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc .*relayout_kernel.cu"):
        rk.build_library()


# -- the kernels' own block loops and addressing, built with g++ -----------------

@pytest.fixture(scope="module")
def host_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found")
    return rk.load_host_library()


def _strided(rng, shape, spare=5):
    """A uint8 tensor of `shape` whose rows and leading axes have strides
    wider than its extents (a view into a larger buffer)."""
    big = torch.from_numpy(rng.integers(0, 256, tuple(s + spare for s in shape),
                                        dtype=np.uint8))
    return big[tuple(slice(0, s) for s in shape)]


def _random_geometry(rng):
    pad = int(rng.choice([0, 4, 2, 8]))
    w = 8 * int(rng.integers(1, 80)) - 2 * pad % 8
    h = int(rng.integers(8, 50))
    if 8 * _covered(h, pad) < pad + h:
        h -= (pad + h) - 8 * _covered(h, pad)
    lead = [(), (int(rng.integers(1, 4)),), (int(rng.integers(1, 3)), 2)][int(rng.integers(0, 3))]
    return tuple(lead), h, w, pad, int(rng.integers(0, 3)), int(rng.integers(0, 70))


@pytest.mark.parametrize("seed", range(8))
def test_host_relayout_matches_plain(host_lib, seed):
    """The kernels' block loops, over strided planes and strided
    destinations, with the launch arguments the wrappers pass, run by one
    thread (odd seeds) or by the kernel's block of threads (even seeds)."""
    rng = np.random.default_rng(seed)
    threads = rk.HOST_THREADS if seed % 2 == 0 else 1
    for _ in range(6):
        lead, h, w, pad, ey, ex = _random_geometry(rng)
        byg, bxg = _grid(h, w, pad, ey, ex)
        x = _strided(rng, (*lead, h, w))
        ref = rk.plane_to_tiles_plain(x, pad, byg, bxg)
        out = torch.zeros((*lead, 8, 8, byg, bxg), dtype=torch.uint8)
        dests = [out]
        if lead:
            dests.append(_uv_stacked_out(lead, byg, bxg)[1])
        for dst in dests:
            assert host_lib.gvct_host_relayout(
                threads, 0, x.data_ptr(), dst.data_ptr(),
                *rk._geom_args(x, dst, h, w, pad, byg, bxg)) == 0
            assert torch.equal(dst, ref), (lead, h, w, pad, byg, bxg)
            back = torch.zeros((*lead, h, w), dtype=torch.uint8)
            tiles = _strided(rng, (*lead, 8, 8, byg, bxg)) if dst is out else dst
            assert host_lib.gvct_host_relayout(
                threads, 1, tiles.data_ptr(), back.data_ptr(),
                *rk._geom_args(back, tiles, h, w, pad, byg, bxg)) == 0
            assert torch.equal(back, rk.tiles_to_plane_plain(tiles, pad, h, w))


def _at_residue(rng, shape, off, row_pad=3, device="cpu"):
    """A random uint8 view of `shape` that starts `off` bytes past a 16-byte
    boundary, with rows `row_pad` bytes wider than they are long and every
    outer stride one byte more than the extent inside it (so no stride is
    a multiple of 4).  Returns (view, the whole buffer)."""
    strides = [shape[-1] + row_pad, 1]
    for n in reversed(shape[1:-1]):
        strides.insert(0, strides[0] * n + 1)
    size = off + sum((n - 1) * st for n, st in zip(shape, strides)) + 1 + 64
    big = torch.empty(size + 16, dtype=torch.uint8, device=device)
    big.copy_(torch.from_numpy(rng.integers(0, 256, size + 16, dtype=np.uint8)))
    start = off - big.data_ptr() % 16 + (16 if big.data_ptr() % 16 > off else 0)
    view = torch.as_strided(big, shape, strides, storage_offset=start)
    assert view.data_ptr() % 16 == off and view.stride() == tuple(strides)
    return view, big


def _expect(big, view, value):
    """`big` as it should read once `view` (a view into it) holds `value`
    and no other byte changed."""
    want = big.clone()
    torch.as_strided(want, view.shape, view.stride(), view.storage_offset()).copy_(value)
    return want


def _host_round_trip(host_lib, rng, lead, h, w, pad, p_off, t_off, threads):
    """T2 from a plane view at residue p_off into a tile view at residue
    t_off, then T3 back into a second plane view at p_off: each equal to the
    plain version, with every byte outside the destination view unchanged."""
    byg, bxg = _grid(h, w, pad, 0, 0)
    x, _ = _at_residue(rng, (*lead, h, w), p_off)
    t, tbig = _at_residue(rng, (*lead, 8, 8, byg, bxg), t_off)
    want = _expect(tbig, t, rk.plane_to_tiles_plain(x, pad, byg, bxg))
    assert host_lib.gvct_host_relayout(
        threads, 0, x.data_ptr(), t.data_ptr(), *rk._geom_args(x, t, h, w, pad, byg, bxg)) == 0
    assert torch.equal(tbig, want), ("T2", lead, h, w, pad, p_off, t_off, threads)
    t.copy_(torch.from_numpy(rng.integers(0, 256, t.shape, dtype=np.uint8)))
    back, bbig = _at_residue(rng, (*lead, h, w), p_off)
    want = _expect(bbig, back, rk.tiles_to_plane_plain(t, pad, h, w))
    assert host_lib.gvct_host_relayout(
        threads, 1, t.data_ptr(), back.data_ptr(),
        *rk._geom_args(back, t, h, w, pad, byg, bxg)) == 0
    assert torch.equal(bbig, want), ("T3", lead, h, w, pad, p_off, t_off, threads)


@pytest.mark.parametrize("off", range(16))
def test_host_relayout_every_base_residue(host_lib, off):
    """Every start address residue mod 16, on the plane side and on the
    tile side, with pad 4 (tile boundaries 4 bytes into a word) and pad 0,
    alone and as a U+V pair."""
    rng = np.random.default_rng(100 + off)
    for lead, h, w, pad in (((), 20, 136, 4), ((2,), 16, 64, 0)):
        for threads in (1, rk.HOST_THREADS):
            _host_round_trip(host_lib, rng, lead, h, w, pad, off, 0, threads)
            _host_round_trip(host_lib, rng, lead, h, w, pad, 0, off, threads)
            _host_round_trip(host_lib, rng, lead, h, w, pad, off, 15 - off, threads)


ODD_BX = [(bx, pad) for bx in (1, 2, 15, 16, 17, 31, 33, 241) for pad in (0, 4)
          if 8 * bx > 2 * pad]


@pytest.mark.parametrize("bx,pad", ODD_BX, ids=[f"bx{bx}-pad{pad}" for bx, pad in ODD_BX])
def test_host_relayout_odd_bx(host_lib, bx, pad):
    """Grids of Bx tiles around the chunk and span sizes (and 1080p luma's
    241), at misaligned starts, held byte for byte against the plain
    versions."""
    rng = np.random.default_rng(bx * 10 + pad)
    h = 12 if pad else 16  # pad 4: 12 + 8 rows in 2 tile rows, as 1080p chroma
    for lead in ((), (2,)):
        for threads in (1, rk.HOST_THREADS):
            _host_round_trip(host_lib, rng, lead, h, 8 * bx - 2 * pad, pad, bx % 16,
                             (3 * bx + 5) % 16, threads)


def test_host_relayout_refuses_bad_geometry(host_lib):
    x = torch.zeros((16, 24), dtype=torch.uint8)
    t = torch.zeros((8, 8, 3, 4), dtype=torch.uint8)
    args = list(rk._geom_args(x, t, 16, 24, 4, 3, 4))
    assert host_lib.gvct_host_relayout(1, 0, x.data_ptr(), t.data_ptr(), *args) == 0
    for i, bad in ((3, 2), (4, 3), (1, 20), (2, -1), (0, 14),  # grid, w + 2pad, pad, rows
                   (9, -24), (13, 2**31)):  # a negative row stride; 32-bit offsets
        wrong = args.copy()
        wrong[i] = bad
        assert host_lib.gvct_host_relayout(1, 0, x.data_ptr(), t.data_ptr(), *wrong) == -1, i
    assert host_lib.gvct_host_relayout(7, 0, x.data_ptr(), t.data_ptr(), *args) == -1


def test_host_covered_tiles(host_lib):
    """Q9: 1080p chroma's 540 rows + 8 padding give 68 tile rows (544 of
    548 extended rows); luma and 8-aligned chroma cover everything."""
    for n, pad, want in ((540, 4, 68), (1080, 4, 136), (1920, 4, 241), (960, 4, 121),
                         (36, 4, 5), (40, 0, 5)):
        assert host_lib.gvct_host_covered_tiles(n, pad) == want == _covered(n, pad)


@pytest.mark.parametrize("nb", [1, 3])
def test_host_pack_matches_plain(rng, host_lib, nb):
    for w, h in ((64, 48), (40, 24), (1920, 1080), (8, 8)):
        yn, cn = w * h, w * h // 4
        y = torch.from_numpy(rng.integers(0, 256, (nb, yn), dtype=np.uint8)).clone()
        uv = torch.from_numpy(rng.integers(0, 256, (nb, 2, cn), dtype=np.uint8)).clone()
        u, v = uv[:, 0], uv[:, 1]  # batch stride 2cn, as the resident readback has them
        out = torch.zeros((nb, yn + 2 * cn), dtype=torch.uint8)
        host_lib.gvct_host_pack_yv12(y.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(),
                                     yn, cn, nb, y.stride(0), u.stride(0), v.stride(0),
                                     out.stride(0))
        assert torch.equal(out, rk.pack_yv12_plain(y, u, v)), (w, h)
        assert torch.equal(rk.pack_yv12_cuda(y, u, v), out)


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS + [((), 1080, 1920, 4, 0, 0), ((2,), 540, 960, 4, 0, 0),
                                          ((4,), 1080, 1920, 4, 0, 0)],
                         ids=FORM_IDS + ["1080p-luma", "1080p-uv", "1080p-luma-batch4"])
def test_relayout_kernels_match_plain_on_card(rng, cuda_device, form):
    lead, h, w, pad, ey, ex = form
    byg, bxg = _grid(h, w, pad, ey, ex)
    x = _strided(rng, (*lead, h, w)).to(cuda_device)
    before = dict(rk.LAUNCHES)
    t = rk.plane_to_tiles_cuda(x, pad, by_grid=byg, bx_grid=bxg)
    back = rk.tiles_to_plane_cuda(t, pad, h, w)
    assert rk.LAUNCHES["fwd"] == before["fwd"] + 1 and rk.LAUNCHES["inv"] == before["inv"] + 1
    assert torch.equal(t, rk.plane_to_tiles_plain(x, pad, byg, bxg))
    assert torch.equal(back, x)
    if lead:
        _, view = _uv_stacked_out(lead, byg, bxg, cuda_device)
        rk.plane_to_tiles_cuda(x, pad, by_grid=byg, bx_grid=bxg, out=view)
        assert torch.equal(view, t)
        assert torch.equal(rk.tiles_to_plane_cuda(view, pad, h, w), x)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("w,h,nb", [(1920, 1080, 1), (360, 288, 1), (64, 48, 4)])
def test_pack_kernel_matches_plain_on_card(rng, cuda_device, w, h, nb):
    yn, cn = w * h, w * h // 4
    y = torch.from_numpy(rng.integers(0, 256, (nb, yn), dtype=np.uint8)).to(cuda_device)
    uv = torch.from_numpy(rng.integers(0, 256, (nb, 2, cn), dtype=np.uint8)).to(cuda_device)
    before = rk.LAUNCHES["pack"]
    out = rk.pack_yv12_cuda(y, uv[:, 0], uv[:, 1])
    assert rk.LAUNCHES["pack"] == before + 1
    assert torch.equal(out, rk.pack_yv12_plain(y, uv[:, 0], uv[:, 1]))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("w,h", [(64, 48), (40, 24), (1920, 1080)])
def test_resident_on_card_matches_plain(rng, cuda_device, w, h):
    """A 3-frame batch through ingest -> 2 steps -> readback on the card
    equals the plain backend, with 2 T2, 2 T3 and 1 T4 launches."""
    from gpu_video_codec_tpu_torch.models.resident import ResidentDeblocker

    raws = np.stack([rng.integers(0, 256, 3 * w * h // 2, dtype=np.uint8) for _ in range(3)])
    rd = ResidentDeblocker(w, h, 35, device=cuda_device)
    before = dict(rk.LAUNCHES)
    out = rd.readback(rd.run_steps(rd.ingest(raws), 2))
    assert {k: rk.LAUNCHES[k] - before[k] for k in before} == {"fwd": 2, "inv": 2, "pack": 1}
    ref = ResidentDeblocker(w, h, 35, backend="torch", device=cuda_device)
    assert np.array_equal(out, ref.readback(ref.run_steps(ref.ingest(raws), 2)))
    on_card = torch.from_numpy(raws).to(cuda_device)  # ingest without a host copy
    assert np.array_equal(out, rd.readback(rd.run_steps(rd.ingest(on_card), 2)))


def _card_round_trip(rng, dev, lead, h, w, pad, p_off, t_off):
    """_host_round_trip through the wrappers on the card: T2 into a tile
    view at residue t_off, T3 into a plane view at p_off (out=), each equal
    to the plain version with no byte outside the view changed."""
    byg, bxg = _grid(h, w, pad, 0, 0)
    x, _ = _at_residue(rng, (*lead, h, w), p_off, device=dev)
    t, tbig = _at_residue(rng, (*lead, 8, 8, byg, bxg), t_off, device=dev)
    want = _expect(tbig, t, rk.plane_to_tiles_plain(x, pad, byg, bxg))
    assert rk.plane_to_tiles_cuda(x, pad, out=t) is t
    assert torch.equal(tbig, want), ("T2", lead, h, w, pad, p_off, t_off)
    back, bbig = _at_residue(rng, (*lead, h, w), p_off, device=dev)
    want = _expect(bbig, back, rk.tiles_to_plane_plain(t, pad, h, w))
    assert rk.tiles_to_plane_cuda(t, pad, h, w, out=back) is back
    assert torch.equal(bbig, want), ("T3", lead, h, w, pad, p_off, t_off)


@pytest.mark.cuda
@pytest.mark.parametrize("off", range(16))
def test_relayout_every_base_residue_on_card(cuda_device, off):
    rng = np.random.default_rng(100 + off)
    for lead, h, w, pad in (((), 20, 136, 4), ((2,), 16, 64, 0), ((), 1080, 1920, 4)):
        _card_round_trip(rng, cuda_device, lead, h, w, pad, off, 0)
        _card_round_trip(rng, cuda_device, lead, h, w, pad, 0, off)
        _card_round_trip(rng, cuda_device, lead, h, w, pad, off, 15 - off)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("bx,pad", ODD_BX, ids=[f"bx{bx}-pad{pad}" for bx, pad in ODD_BX])
def test_relayout_odd_bx_on_card(cuda_device, bx, pad):
    rng = np.random.default_rng(bx * 10 + pad)
    h = 12 if pad else 16
    for lead in ((), (2,)):
        _card_round_trip(rng, cuda_device, lead, h, 8 * bx - 2 * pad, pad, bx % 16,
                         (3 * bx + 5) % 16)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_tiles_to_plane_out_on_card(rng, cuda_device):
    """T3 straight into the luma rows and the U/V pair of a 1080p packed
    frame buffer equals plain, and leaves the other rows alone."""
    h, w, p = 1080, 1920, 4
    buf = torch.from_numpy(rng.integers(0, 256, (3 * h // 2, w), dtype=np.uint8)).to(cuda_device)
    keep = buf.clone()
    yt = torch.randint(0, 256, (8, 8, 136, 241), dtype=torch.uint8, device=cuda_device)
    uvt = torch.randint(0, 256, (2, 8, 8, 68, 121), dtype=torch.uint8, device=cuda_device)
    before = rk.LAUNCHES["inv"]
    rk.tiles_to_plane_cuda(yt, p, h, w, out=buf[:h])
    assert torch.equal(buf[:h], rk.tiles_to_plane_plain(yt, p, h, w))
    assert torch.equal(buf[h:], keep[h:])
    rk.tiles_to_plane_cuda(uvt, p, h // 2, w // 2, out=buf[h:].view(2, h // 2, w // 2))
    assert torch.equal(buf[h:].view(2, h // 2, w // 2),
                       rk.tiles_to_plane_plain(uvt, p, h // 2, w // 2))
    assert rk.LAUNCHES["inv"] == before + 2
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("luma_only", [False, True], ids=["full", "luma_only"])
@pytest.mark.parametrize("w,h", [(64, 48), (40, 24), (360, 288)],
                         ids=["64x48", "sheared-40x24", "sheared-360x288"])
def test_streaming_on_card_goes_through_t2_t3(rng, cuda_device, w, h, luma_only):
    """The streaming packed step on the card launches K2 once where its
    guard takes the width (64x48), and elsewhere (the sheared widths) T2,
    K1 and T3 once each for luma and T2, K1c and T3 once each for U+V, in
    place or not, and equals the plain backend."""
    from gpu_video_codec_tpu_torch.models.streaming import StreamingDeblocker
    from gpu_video_codec_tpu_torch.ops import cuda_kernel as ck

    raw = rng.integers(0, 256, 3 * w * h // 2, dtype=np.uint8)
    s = StreamingDeblocker(w, h, 35, luma_only=luma_only, device=cuda_device)
    ref = StreamingDeblocker(w, h, 35, luma_only=luma_only, backend="torch",
                             device=cuda_device)
    want = ref._packed(s._put(raw), False)
    for inplace in (False, True):
        buf = s._put(raw)
        keep = buf.clone()
        before = {**rk.LAUNCHES, **ck.LAUNCHES}
        out = s._packed(buf, inplace)
        after = {**rk.LAUNCHES, **ck.LAUNCHES}
        n = 1 if luma_only else 2
        ran = ({"packed": 1} if ck.packed_fits(w)
               else {"fwd": n, "inv": n, "luma": 1, "chroma": n - 1})
        assert {k: after[k] - before[k] for k in before} == {**dict.fromkeys(before, 0), **ran}
        assert (out is buf) == inplace
        assert torch.equal(out, want)
        if not inplace:
            assert torch.equal(buf, keep)
    torch.cuda.synchronize()
