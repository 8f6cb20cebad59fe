"""T5, the deblock kernel on the (By, 8, 8, Bx) "rows" tile layout, of the
PyTorch port (deblock_rows_cuda, ops/deblock.deblock_rows_plain).

T5 is K1's quad (csrc/deblock_quad.cuh) on the rows layout: a block owns TB
tiles of one tile row, staged through shared memory by the tensor memory
accelerator (route A, where Bx, TB and the addresses allow it) or in 8-,
4- or 1-byte words (route B).  Here on the CPU the g++ build of the kernel
(csrc/host_shim.cpp, gvct_host_deblock_rows) runs a block's 4 * TB threads
one after another between the kernel's exchange points, staging in route
B's words or as route A's TMA boxes would (zero fill past the grid and in
the pad column, no store there).  It is held byte for byte against
deblock_rows_plain over TB 1, 3, 8, 64 (words) and 32, 64 (TMA boxes),
Bx in {1, 5, 16, 63, 64, 65, 241, 272}, By 1 and 3, luma and chroma, with
every BS byte 0, and against the JAX tool's own Pallas kernel,
tools/rowslayout_exp.deblock_rows_layout, in interpret mode; the route
rule (gvct_host_rows_staging), the wrapper's checks and the rowslayout_exp
entry point are tested too.  Tests marked `cuda` launch the kernel on both
routes and skip without a card; JAX is imported only inside the test that
compares with it, so the `cuda` tests also run where JAX is not installed
(`python -m pytest tests/test_torch_rows.py -m cuda`).  Every comparison
is byte-equal."""

import ctypes
import functools
import shutil

import numpy as np
import pytest
import torch

from gpu_video_codec_tpu_torch.ops import cuda_kernel as ck
from gpu_video_codec_tpu_torch.ops.deblock import deblock_rows_plain, deblock_tiles_plain
from gpu_video_codec_tpu_torch.ops.tables import get_beta, get_tc
from gpu_video_codec_tpu_torch.tools import rowslayout_exp
from test_torch_quad import _outcomes  # the filter outcomes of K1's quad tests

QPS = (0, 17, 30, 35, 51)
BS_KINDS = ("random", "all-2")
# (tiles per block, staging): route B's words at these TB, route A's boxes
# (TB a multiple of 32)
STAGINGS = [(1, "words"), (3, "words"), (8, "words"), (64, "words"), (32, "tma"), (64, "tma")]
STAGING_IDS = [f"tb{tb}-{how}" for tb, how in STAGINGS]
# (By, Bx): tails of every block size, both 16-byte classes of Bx, the 1080p
# luma width and the race grid's tail
GRIDS = [(by, bx) for by in (1, 3) for bx in (1, 5, 16, 63, 64, 65, 241, 272)] + [(17, 33)]
GRID_IDS = [f"{by}x{bx}" for by, bx in GRIDS]


def _tiles(rng, shape):
    """uint8 tile-planes (8, 8, By, Bx): flat blocks with small noise and
    steps between the tile's halves across both edges (skip, strong,
    normal and the normal filter's |delta0| gate both ways), a quarter of
    the tiles uniform noise (cond1 fails)."""
    cell = (1, 1) + shape[-2:]
    t = rng.integers(40, 216, cell) + rng.integers(-3, 4, shape)
    t[4:] += rng.integers(-24, 25, cell)
    t[:, 4:] += rng.integers(-24, 25, cell)
    t = np.where(rng.random(cell) < 0.25, rng.integers(0, 256, shape), t)
    return np.clip(t, 0, 255).astype(np.uint8)


def _rows(tiles):
    return np.ascontiguousarray(tiles.transpose(2, 0, 1, 3))


def _maps(rng, shape, kind="random"):
    if kind == "all-2":
        return [np.full(shape, 2, np.uint8) for _ in range(4)]
    return [rng.integers(0, 3, shape, dtype=np.uint8) for _ in range(4)]


@functools.lru_cache(maxsize=None)
def _cases(by, bx, chroma):
    """The grid's inputs over QPS and BS_KINDS with the plain version's
    output: [(tiles, rows, maps, beta, tc, want)], made once per grid."""
    out = []
    for qp in QPS:
        for kind in BS_KINDS:
            rng = np.random.default_rng([by, bx, qp, BS_KINDS.index(kind)])
            tiles = _tiles(rng, (8, 8, by, bx))
            rows, maps = _rows(tiles), _maps(rng, (by, bx), kind)
            beta, tc = get_beta(qp), get_tc(qp)
            want = deblock_rows_plain(torch.from_numpy(rows), *map(torch.from_numpy, maps), beta,
                                      tc, chroma=chroma).numpy()
            out.append((tiles, rows, maps, beta, tc, want))
    return out


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


@pytest.fixture(scope="module")
def host_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found")
    return ck.load_host_library()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _host_rows(lib, tb, how, rows, maps, beta, tc, chroma):
    """The rows quad's blocks of tb tiles on the host, staged as `how`
    ("words": route B; "tma": route A's boxes)."""
    out = np.empty_like(rows)
    rc = lib.gvct_host_deblock_rows(tb, int(how == "tma"), _ptr(rows), _ptr(out),
                                    *(_ptr(m) for m in maps), beta, tc, rows.shape[0],
                                    rows.shape[3], int(chroma))
    assert rc == 0
    return out


@functools.lru_cache(maxsize=None)
def _pallas(chroma):
    """The JAX tool's kernel (interpret, block 8x16) at (8, 8, 8, 16) over
    three QPs: [(tiles, rows, maps, beta, tc, want)]."""
    import jax.numpy as jnp

    from tools.rowslayout_exp import deblock_rows_layout

    rng = np.random.default_rng(7 + chroma)
    out = []
    for qp in (22, 37, 51):
        beta, tc = get_beta(qp), get_tc(qp)
        tiles = _tiles(rng, (8, 8, 8, 16))
        rows, maps = _rows(tiles), _maps(rng, (8, 16))
        want = np.asarray(deblock_rows_layout(jnp.asarray(rows), *map(jnp.asarray, maps), beta,
                                              tc, chroma=chroma, block_by=8, block_bx=16))
        out.append((tiles, rows, maps, beta, tc, want))
    return out


@pytest.mark.parametrize("tb,how", STAGINGS, ids=STAGING_IDS)
@pytest.mark.parametrize("chroma", [False, True])
def test_rows_match_pallas_tool(host_lib, chroma, tb, how):
    """The host build of the rows quad, deblock_rows_plain and
    deblock_rows_cuda on CPU tensors == the JAX deblock_rows_layout
    (interpret, block 8x16) at (8, 8, 8, 16), and == the canonical deblock
    permuted."""
    for tiles, rows, maps, beta, tc, want in _pallas(chroma):
        tr, tm = torch.from_numpy(rows), [torch.from_numpy(m) for m in maps]
        plain = deblock_rows_plain(tr, *tm, beta, tc, chroma=chroma)
        assert plain.is_contiguous() and np.array_equal(plain.numpy(), want), beta
        before = dict(ck.LAUNCHES)
        assert torch.equal(ck.deblock_rows_cuda(tr, *tm, beta, tc, chroma=chroma), plain)
        assert ck.LAUNCHES == before  # the CPU path launches nothing
        got = _host_rows(host_lib, tb, how, rows, maps, beta, tc, chroma)
        assert np.array_equal(got, want), beta
        canon = deblock_tiles_plain(torch.from_numpy(tiles), *tm, beta, tc, chroma=chroma)
        assert torch.equal(plain.permute(1, 2, 0, 3), canon)
        assert not np.array_equal(want, rows)


@pytest.mark.parametrize("chroma", [False, True], ids=["luma", "chroma"])
@pytest.mark.parametrize("tb,how", STAGINGS, ids=STAGING_IDS)
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_host_rows_matches_plain(host_lib, grid, tb, how, chroma):
    """The rows quad's blocks == deblock_rows_plain over QPS, random and
    all-2 BS maps."""
    changed = 0
    for _, rows, maps, beta, tc, want in _cases(*grid, chroma):
        out = _host_rows(host_lib, tb, how, rows, maps, beta, tc, chroma)
        assert np.array_equal(out, want), (beta, tc)
        changed += int((out != rows).sum())
    assert changed > 0


@pytest.mark.parametrize("chroma", [False, True], ids=["luma", "chroma"])
@pytest.mark.parametrize("tb,how", STAGINGS, ids=STAGING_IDS)
def test_host_rows_bs0_returns_input(host_lib, tb, how, chroma):
    """With every BS byte 0 no segment is filtered: the output is the
    input, on full blocks and tails."""
    for by, bx in ((3, 65), (1, 272), (3, 5)):
        rng = np.random.default_rng([by, bx])
        rows = _rows(_tiles(rng, (8, 8, by, bx)))
        zero = [np.zeros((by, bx), np.uint8) for _ in range(4)]
        out = _host_rows(host_lib, tb, how, rows, zero, get_beta(51), get_tc(51), chroma)
        assert np.array_equal(out, rows), (by, bx)


@pytest.mark.parametrize("tb", [8, 32, 64])
@pytest.mark.parametrize("offsets", [(1, 0), (0, 3), (2, 1), (8, 8)], ids=lambda o: f"in{o[0]}-out{o[1]}")
def test_host_rows_misaligned(host_lib, offsets, tb):
    """Route B on rows and outputs that start 1-15 bytes past a 16-byte
    boundary (byte words, or 8-byte words at 8) == plain, and no byte
    around the output changes."""
    for by, bx in ((3, 64), (2, 241), (1, 5)):
        _, rows, maps, beta, tc, want = _cases(by, bx, False)[3]
        bufs = [np.zeros(rows.size + 64, np.uint8) for _ in range(2)]
        views = []
        for buf, off in zip(bufs, offsets):
            start = (-buf.ctypes.data) % 16 + off
            views.append(buf[start:start + rows.size].reshape(rows.shape))
        src, dst = views
        src[...] = rows
        before = bufs[1].copy()
        assert host_lib.gvct_host_rows_staging(bx, tb, _ptr(src), _ptr(dst)) != 0
        rc = host_lib.gvct_host_deblock_rows(tb, 0, _ptr(src), _ptr(dst),
                                             *(_ptr(m) for m in maps), beta, tc, by, bx, 0)
        assert rc == 0 and np.array_equal(dst, want), (by, bx)
        outside = np.ones(bufs[1].size, bool)
        outside[dst.ctypes.data - bufs[1].ctypes.data:][:rows.size] = False
        assert np.array_equal(bufs[1][outside], before[outside]), (by, bx)


def test_rows_inputs_reach_every_outcome():
    """The luma inputs of test_host_rows_matches_plain reach every branch
    of the filter: skip, strong, normal, and the per-row gate both ways."""
    total = {}
    for grid in GRIDS:
        for tiles, _, maps, beta, tc, _ in _cases(*grid, False):
            for k, v in _outcomes(tiles, maps, beta, tc).items():
                total[k] = total.get(k, 0) + v
    assert all(v > 0 for v in total.values()), total


@pytest.mark.parametrize("bx", [5, 16, 241, 256, 272])
def test_rows_route_rule(host_lib, bx):
    """Route A (TMA, 0) exactly where TB is a multiple of 32 and Bx and both
    addresses are multiples of 16; otherwise route B's widest word that
    Bx, TB and the addresses allow (8, 4 or 1)."""
    buf = np.zeros(64 + 32, np.uint8)
    base = (-buf.ctypes.data) % 64  # a 64-byte-aligned start inside buf
    for tb in (1, 4, 8, 16, 32, 64):
        for off_in in (0, 1, 2, 4, 8, 16):
            for off_out in (0, 4, 8):
                a_in, a_out = buf[base + off_in:], buf[base + off_out:]
                addr = off_in | off_out
                if tb % 32 == 0 and bx % 16 == 0 and addr % 16 == 0:
                    want = 0
                else:
                    want = next((w for w in (8, 4) if bx % w == 0 and tb % w == 0
                                 and addr % w == 0), 1)
                got = host_lib.gvct_host_rows_staging(bx, tb, _ptr(a_in), _ptr(a_out))
                assert got == want, (tb, off_in, off_out)
    # the host build refuses TMA boxes at a TB that route A cannot take
    r = np.zeros((1, 8, 8, bx), np.uint8)
    zero = [np.zeros((1, bx), np.uint8) for _ in range(4)]
    assert host_lib.gvct_host_deblock_rows(16, 1, _ptr(r), _ptr(r), *(_ptr(m) for m in zero),
                                           36, 4, 1, bx, 0) == -1
    assert host_lib.gvct_host_deblock_rows(65, 0, _ptr(r), _ptr(r), *(_ptr(m) for m in zero),
                                           36, 4, 1, bx, 0) == -1


def test_rows_wrapper_rejects_bad_operands():
    r = torch.zeros((3, 8, 8, 5), dtype=torch.uint8)
    m = torch.zeros((3, 5), dtype=torch.uint8)
    ok = (m, m, m, m)
    with pytest.raises(ValueError, match=r"\(By, 8, 8, Bx\)"):
        ck.deblock_rows_cuda(torch.zeros((8, 8, 3, 5), dtype=torch.uint8), *ok, 36, 4)
    with pytest.raises(ValueError, match="uint8"):
        ck.deblock_rows_cuda(r.to(torch.int32), *ok, 36, 4)
    with pytest.raises(ValueError, match="contiguous"):
        ck.deblock_rows_cuda(r.transpose(0, 3).contiguous().transpose(0, 3), *ok, 36, 4)
    with pytest.raises(ValueError, match="shape"):
        ck.deblock_rows_cuda(r, m[:2], m, m, m, 36, 4)
    with pytest.raises(ValueError, match="bs_hor2"):
        ck.deblock_rows_cuda(r, m, m, m, m.to(torch.int32), 36, 4)
    with pytest.raises(ValueError, match="non-negative"):
        ck.deblock_rows_cuda(r, *ok, 36, -1)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ck.deblock_rows_cuda(r.to("meta"), *(x.to("meta") for x in ok), 36, 4)


def test_rowslayout_entry_point_cpu(capsys):
    res = rowslayout_exp.main(["--device", "cpu"])
    assert res["bit_exact"] is True and res["grid"] == "136x256"
    assert res["canonical_us"] is None and res["rows_layout_us"] is None  # not measured on CPU
    assert res["rows_route"] is None
    assert '"bit_exact": true' in capsys.readouterr().out


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

    monkeypatch.setattr(ck, "deblock_rows_plain", no_plain)
    with FakeTensorMode():
        r = torch.empty((3, 8, 8, 4), dtype=torch.uint8, device="cuda")
        m = torch.empty((3, 4), dtype=torch.uint8, device="cuda")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            ck.deblock_rows_cuda(r, m, m, m, m, 36, 4)


# -- on the card -------------------------------------------------------------

# (By, Bx, bytes past a 16-byte boundary, route): route A at the race grid
# and its tail, route B at the 1080p luma width, on views that start 8 and
# 1 bytes past a 16-byte boundary and on a tail grid
CARD_GRIDS = [(3, 5, 0, "words"), (136, 241, 0, "words"), (136, 256, 0, "tma"),
              (136, 272, 0, "tma"), (136, 256, 8, "words"), (136, 256, 1, "words")]
CARD_IDS = ["tail", "1080p-luma", "race-grid", "race-grid-tail", "misaligned-8", "misaligned-1"]


@pytest.mark.cuda
@pytest.mark.parametrize("chroma", [False, True])
@pytest.mark.parametrize("grid", CARD_GRIDS, ids=CARD_IDS)
def test_rows_kernel_matches_plain_on_card(rng, cuda_device, grid, chroma):
    by, bx, off, route = grid
    for qp in (0, 17, 30, 35, 51):
        beta, tc = get_beta(qp), get_tc(qp)
        src = torch.from_numpy(_rows(_tiles(rng, (8, 8, by, bx))))
        buf = torch.empty(src.numel() + 16, dtype=torch.uint8, device=cuda_device)
        rows = buf[off:off + src.numel()].view(src.shape)
        rows.copy_(src)
        maps = [torch.from_numpy(m).to(cuda_device) for m in _maps(rng, (by, bx))]
        assert ck.deblock_rows_occupancy(rows, chroma=chroma)["route"] == route
        before = ck.LAUNCHES["rows"]
        out = ck.deblock_rows_cuda(rows, *maps, beta, tc, chroma=chroma)
        assert ck.LAUNCHES["rows"] == before + 1
        ref = deblock_rows_plain(rows, *maps, beta, tc, chroma=chroma)
        zero = [torch.zeros_like(m) for m in maps]
        off_out = ck.deblock_rows_cuda(rows, *zero, beta, tc, chroma=chroma)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), qp
        assert torch.equal(off_out, rows), qp  # every BS byte 0: the input


@pytest.mark.cuda
def test_rowslayout_entry_point_on_card(cuda_device):
    res = rowslayout_exp.main([])
    assert res["bit_exact"] is True
    assert res["canonical_us"] > 0 and res["rows_layout_us"] > 0
    assert res["rows_route"] == "tma"  # (136, 8, 8, 256): Bx a multiple of 16
