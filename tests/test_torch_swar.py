"""T1, the SWAR deblock kernel of the PyTorch port (tile pairs as the two
signed 16-bit lanes of 32-bit words, four lanes per pair; ops/swar_kernel.py,
csrc/swar_kernel.cu, csrc/swar_tile.cuh).

Here on the CPU: the kernel's blocks (four lanes per tile pair, TB pairs
staged interleaved in shared memory), compiled with g++ through
csrc/host_shim.cpp (with the host fallbacks of the halfword intrinsics) and
run one thread after another between the kernel's exchange points, against
the JAX tool's SWAR sweep (tools/swar_exp.swar_deblock_tiles) and against
deblock_tiles_plain, at TB 1, 3, 8 and 64 with Bx/2 not a multiple of TB,
in place, with every BS byte 0 and in every staging word; each halfword
fallback against numpy int16 arithmetic; the wrapper's checks; and the
swar_exp entry point.  Tests marked `cuda` launch the kernel and
skip without a card; JAX is imported only inside the test that compares
with it, so the `cuda` tests also run where JAX is not installed
(`python -m pytest tests/test_torch_swar.py -m cuda`).  Every comparison
is byte-equal."""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from gpu_video_codec_tpu_torch.ops import cuda_kernel as ck
from gpu_video_codec_tpu_torch.ops import swar_kernel as sk
from gpu_video_codec_tpu_torch.ops.deblock import deblock_tiles_plain
from gpu_video_codec_tpu_torch.ops.tables import get_beta, get_tc
from gpu_video_codec_tpu_torch.tools import swar_exp


def _tiles(rng, shape):
    """uint8 tile-planes (8, 8, By, Bx) mixing flat blocks with small steps
    and uniform noise."""
    flat = rng.integers(40, 216, (1, 1) + shape[-2:])
    t = flat + rng.integers(-3, 4, shape)
    t[4:] += rng.integers(-20, 21, (1, 1) + shape[-2:])
    t = np.where(rng.random((1, 1) + shape[-2:]) < 0.25, rng.integers(0, 256, shape), t)
    return np.clip(t, 0, 255).astype(np.uint8)


def _maps(rng, shape):
    return [rng.integers(0, 3, shape, dtype=np.uint8) for _ in range(4)]


@pytest.fixture(scope="module")
def host_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found")
    return sk.load_host_library()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _host_swar(lib, tiles, maps, beta, tc, chroma, tb=sk.BLOCK, out=None):
    """T1's blocks of tb pairs on the host over `tiles` into `out`
    (default: a new array)."""
    out = np.empty_like(tiles) if out is None else out
    rc = lib.gvct_host_swar_tiles(tb, _ptr(tiles), _ptr(out), *(_ptr(m) for m in maps), beta, tc,
                                  tiles.shape[2], tiles.shape[3], int(chroma))
    assert rc == 0
    return out


@pytest.mark.parametrize("chroma,qp,grid", [(False, 37, (5, 12)), (True, 20, (3, 6))],
                         ids=["luma-qp37", "chroma-qp20"])
def test_host_swar_matches_jax_swar(rng, host_lib, chroma, qp, grid):
    """The host build of T1 == the JAX SWAR sweep (eager; its bias
    bookkeeping differs, its function does not) == deblock_tiles_plain."""
    import jax.numpy as jnp

    from tools.swar_exp import swar_deblock_tiles

    beta, tc = get_beta(qp), get_tc(qp)
    tiles, maps = _tiles(rng, (8, 8, *grid)), _maps(rng, grid)
    want = np.asarray(swar_deblock_tiles(jnp.asarray(tiles), [jnp.asarray(m) for m in maps],
                                         beta, tc, chroma=chroma))
    got = _host_swar(host_lib, tiles, maps, beta, tc, chroma)
    assert np.array_equal(got, want)
    ref = deblock_tiles_plain(torch.from_numpy(tiles), *map(torch.from_numpy, maps), beta, tc,
                              chroma=chroma)
    assert np.array_equal(got, ref.numpy()) and not np.array_equal(got, tiles)


@pytest.mark.parametrize("chroma", [False, True])
@pytest.mark.parametrize("grid", [(3, 4), (1, 2), (17, 34)], ids=["tail", "one-pair", "wide"])
def test_host_swar_matches_plain(rng, host_lib, grid, chroma):
    """T1's grid of tile pairs on the host == deblock_tiles_plain, over
    random QPs in 0..51 and the swar_exp --check entry on the CPU."""
    changed = 0
    for qp in (0, 51, *rng.integers(1, 51, 4)):
        beta, tc = get_beta(int(qp)), get_tc(int(qp))
        tiles, maps = _tiles(rng, (8, 8, *grid)), _maps(rng, grid)
        out = _host_swar(host_lib, tiles, maps, beta, tc, chroma)
        ref = deblock_tiles_plain(torch.from_numpy(tiles), *map(torch.from_numpy, maps), beta, tc,
                                  chroma=chroma)
        assert np.array_equal(out, ref.numpy()), qp
        changed += int((out != tiles).sum())
    assert changed > 0


# (tile grid) of the block tests: Bx/2 = 17 (a multiple of no TB but 1),
# 40 (8-byte words at TB 8; one partial block at TB 64) and 36 (4-byte
# words at TB 8); one pair.
SWAR_GRIDS = {"half17": (3, 34), "half40": (2, 80), "half36": (2, 72), "one-pair": (1, 2)}
SWAR_TBS = (1, 3, 8, 64)


@pytest.mark.parametrize("tb", SWAR_TBS)
@pytest.mark.parametrize("chroma", [False, True], ids=["luma", "chroma"])
@pytest.mark.parametrize("grid", list(SWAR_GRIDS))
def test_host_swar_blocks_match_plain(rng, host_lib, grid, chroma, tb):
    """T1's blocks of tb pairs == deblock_tiles_plain over QP
    {0,17,30,35,51}, random maps."""
    changed = 0
    for qp in (0, 17, 30, 35, 51):
        beta, tc = get_beta(qp), get_tc(qp)
        tiles, maps = _tiles(rng, (8, 8, *SWAR_GRIDS[grid])), _maps(rng, SWAR_GRIDS[grid])
        out = _host_swar(host_lib, tiles, maps, beta, tc, chroma, tb=tb)
        ref = deblock_tiles_plain(torch.from_numpy(tiles), *map(torch.from_numpy, maps), beta, tc,
                                  chroma=chroma)
        assert np.array_equal(out, ref.numpy()), qp
        changed += int((out != tiles).sum())
    assert changed > 0


@pytest.mark.parametrize("tb", SWAR_TBS)
def test_host_swar_blocks_match_jax_swar(rng, host_lib, tb):
    """T1's blocks == the JAX SWAR sweep at Bx/2 = 17, luma and chroma."""
    import jax.numpy as jnp

    from tools.swar_exp import swar_deblock_tiles

    grid = SWAR_GRIDS["half17"]
    for chroma, qp in ((False, 37), (True, 30)):
        beta, tc = get_beta(qp), get_tc(qp)
        tiles, maps = _tiles(rng, (8, 8, *grid)), _maps(rng, grid)
        want = np.asarray(swar_deblock_tiles(jnp.asarray(tiles), [jnp.asarray(m) for m in maps],
                                             beta, tc, chroma=chroma))
        assert np.array_equal(_host_swar(host_lib, tiles, maps, beta, tc, chroma, tb=tb), want)


@pytest.mark.parametrize("tb", SWAR_TBS)
@pytest.mark.parametrize("chroma", [False, True], ids=["luma", "chroma"])
def test_host_swar_in_place(rng, host_lib, chroma, tb):
    """in == out: a block stages both its runs before it stores any byte."""
    for grid in ("half17", "half40"):
        tiles, maps = _tiles(rng, (8, 8, *SWAR_GRIDS[grid])), _maps(rng, SWAR_GRIDS[grid])
        beta, tc = get_beta(35), get_tc(35)
        buf = tiles.copy()
        _host_swar(host_lib, buf, maps, beta, tc, chroma, tb=tb, out=buf)
        ref = deblock_tiles_plain(torch.from_numpy(tiles), *map(torch.from_numpy, maps), beta, tc,
                                  chroma=chroma)
        assert np.array_equal(buf, ref.numpy()), grid


@pytest.mark.parametrize("chroma", [False, True], ids=["luma", "chroma"])
def test_host_swar_bs_zero(rng, host_lib, chroma):
    """With every BS byte 0 no segment is filtered: the output is the input
    (the branchless sweep computes every delta and selects none)."""
    grid = SWAR_GRIDS["half40"]
    tiles = _tiles(rng, (8, 8, *grid))
    maps = [np.zeros(grid, np.uint8) for _ in range(4)]
    for tb in SWAR_TBS:
        assert np.array_equal(_host_swar(host_lib, tiles, maps, 38, 4, chroma, tb=tb), tiles)


def test_swar_grids_cover_every_word_size(host_lib):
    """The staging word (1, 4 or 8 bytes) T1 picks over SWAR_GRIDS and
    SWAR_TBS: every size is tested; an odd address stages bytes."""
    seen = set()
    for by, bx in SWAR_GRIDS.values():
        a = np.zeros((8, 8, by, bx), np.uint8)
        seen.update(host_lib.gvct_host_swar_word_bytes(bx, tb, _ptr(a), _ptr(a))
                    for tb in SWAR_TBS)
    assert seen == {1, 4, 8}
    b = np.zeros(257, np.uint8)
    assert host_lib.gvct_host_swar_word_bytes(80, 8, b[1:].ctypes.data_as(ctypes.c_void_p),
                                              _ptr(b)) == 1


def test_host_swar_block_is_checked(host_lib):
    """The host grid takes 1..64 pairs per block and an even Bx only."""
    a, maps = np.zeros((8, 8, 3, 6), np.uint8), [np.zeros((3, 6), np.uint8)] * 4
    most = ck.MAX_QUAD_BLOCK_BX
    for tb, bx in ((0, 6), (most + 1, 6), (most, 5)):
        assert host_lib.gvct_host_swar_tiles(tb, _ptr(a), _ptr(a), *map(_ptr, maps), 38, 4, 3,
                                             bx, 0) == -1
    assert host_lib.gvct_host_swar_tiles(most, _ptr(a), _ptr(a), *map(_ptr, maps), 38, 4, 3, 6,
                                         0) == 0


# -- the halfword fallbacks against numpy int16 --------------------------------------

def _lanes(w):
    return ((w & 0xFFFF).astype(np.uint16).view(np.int16),
            (w >> 16).astype(np.uint16).view(np.int16))


def _pack(lo, hi):
    return ((hi.view(np.uint16).astype(np.uint32) << 16)
            | lo.view(np.uint16).astype(np.uint32))


def _numpy_op(op, a, b, c, k):
    """The op on int16 lanes in numpy's own int16 arithmetic (wrap-around)."""
    with np.errstate(over="ignore"):
        if op == "add":
            return a + b
        if op == "sub":
            return a - b
        if op == "neg":
            return -a
        if op == "abs":
            return np.abs(a)
        if op == "max":
            return np.maximum(a, b)
        if op == "min":
            return np.minimum(a, b)
        if op == "lt":
            return np.where(a < b, -1, 0).astype(np.int16)
        if op == "asr":
            return a >> np.int16(k)
        if op == "shl":
            return a << np.int16(k)
        return np.maximum(np.minimum(a + b, c), np.int16(0))  # addmin_relu


@pytest.mark.parametrize("op", sk.HOST_OPS)
def test_halfword_fallbacks_match_numpy(rng, host_lib, op):
    """Each host fallback of swar_tile.cuh's halfword primitives == numpy
    int16 arithmetic per lane, on random words and on every pair of
    lane-boundary values (0x7FFF, 0x8000, 0xFFFF, ...)."""
    edge = np.array([0, 1, 0x7FFF, 0x8000, 0xFFFF, 0x00FF, 0xFF01, 0x7FFE, 0x8001],
                    dtype=np.uint32)
    pairs = (edge[:, None] | (edge[None, :] << 16)).ravel()
    n = 4096
    a = np.concatenate([rng.integers(0, 2**32, n, dtype=np.uint32), pairs,
                        np.repeat(pairs, pairs.size)])
    b = np.concatenate([rng.integers(0, 2**32, n, dtype=np.uint32), pairs[::-1],
                        np.tile(pairs, pairs.size)])
    c = rng.integers(0, 2**32, a.size, dtype=np.uint32)
    c[: pairs.size] = pairs
    ptr = lambda x: x.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    for k in ((1, 2, 3, 4, 15) if op in ("asr", "shl") else (0,)):
        out = np.empty_like(a)
        assert host_lib.gvct_host_swar_op(sk.HOST_OPS.index(op), ptr(a), ptr(b), ptr(c), ptr(out),
                                          a.size, k) == 0
        (alo, ahi), (blo, bhi), (clo, chi) = _lanes(a), _lanes(b), _lanes(c)
        want = _pack(_numpy_op(op, alo, blo, clo, k), _numpy_op(op, ahi, bhi, chi, k))
        bad = np.flatnonzero(out != want)
        assert bad.size == 0, (op, k, hex(a[bad[0]]), hex(b[bad[0]]), hex(out[bad[0]]),
                               hex(want[bad[0]]))
    assert host_lib.gvct_host_swar_op(len(sk.HOST_OPS), ptr(a), ptr(b), ptr(c), ptr(out), 1, 0) == -1


# -- the wrapper and the entry point --------------------------------------------------

def test_swar_wrapper_checks_and_cpu_path(rng):
    t = torch.from_numpy(_tiles(rng, (8, 8, 3, 6)))
    m = [torch.from_numpy(x) for x in _maps(rng, (3, 6))]
    before = dict(sk.LAUNCHES)
    out = sk.deblock_tiles_swar_cuda(t, *m, 38, 4)
    assert sk.LAUNCHES == before  # the CPU path launches nothing
    assert torch.equal(out, deblock_tiles_plain(t, *m, 38, 4))
    with pytest.raises(ValueError, match="even"):
        sk.deblock_tiles_swar_cuda(t[..., :5].contiguous(), *(x[:, :5].contiguous() for x in m),
                                   38, 4)
    with pytest.raises(ValueError, match="even"):
        swar_exp.swar_deblock_tiles(t[..., :5].contiguous(), [x[:, :5].contiguous() for x in m],
                                    38, 4)
    with pytest.raises(ValueError, match=r"\(8, 8, By, Bx\)"):
        sk.deblock_tiles_swar_cuda(t[None], *m, 38, 4)
    with pytest.raises(ValueError, match="shape"):
        sk.deblock_tiles_swar_cuda(t, m[0][:2], *m[1:], 38, 4)
    with pytest.raises(ValueError, match="uint8"):
        sk.deblock_tiles_swar_cuda(t.to(torch.int16), *m, 38, 4)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        sk.deblock_tiles_swar_cuda(t.to("meta"), *(x.to("meta") for x in m), 38, 4)


def test_swar_exp_entry_points_cpu(capsys):
    res = swar_exp.main(["--check", "--device", "cpu"])
    assert res["ok"] is True and len(res["check"]) == 4
    assert [c["chroma"] for c in res["check"]] == [False, True, False, True]
    assert [c["qp"] for c in res["check"]] == [0, 20, 37, 51]
    race = swar_exp.main(["--race", "--device", "cpu"])
    assert race["bit_exact"] is True and race["swar_kernel_us"] is None  # not measured on CPU
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and all(line.startswith("{") for line in out)
    with pytest.raises(SystemExit):
        swar_exp.main(["--device", "cpu"])  # --check or --race is required


def test_kernel_time_needs_a_card(monkeypatch, capsys):
    """tools/kernel_time.py measures on a CUDA device or not at all; its
    blocky tiles are uint8 of the shape asked for."""
    from gpu_video_codec_tpu_torch.tools import kernel_time

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_time.main(["--repeats", "1"]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
    t = kernel_time.blocky_tiles(np.random.default_rng(0), (2, 8, 8, 3, 5))
    assert t.dtype == np.uint8 and t.shape == (2, 8, 8, 3, 5)


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

    monkeypatch.setattr(sk, "deblock_tiles_plain", no_plain)
    with FakeTensorMode():
        t = torch.empty((8, 8, 3, 4), dtype=torch.uint8, device="cuda")
        m = torch.empty((3, 4), dtype=torch.uint8, device="cuda")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            sk.deblock_tiles_swar_cuda(t, m, m, m, m, 36, 4)


# -- on the card -------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("chroma", [False, True])
@pytest.mark.parametrize("grid", [(3, 4), (68, 120), (136, 256)],
                         ids=["tail", "1080p-uv-even", "race-grid"])
def test_swar_kernel_matches_plain_on_card(rng, cuda_device, grid, chroma):
    for qp in (0, 17, 30, 35, 51):
        beta, tc = get_beta(qp), get_tc(qp)
        tiles = torch.from_numpy(_tiles(rng, (8, 8, *grid))).to(cuda_device)
        maps = [torch.from_numpy(m).to(cuda_device) for m in _maps(rng, grid)]
        before = sk.LAUNCHES["swar"]
        out = sk.deblock_tiles_swar_cuda(tiles, *maps, beta, tc, chroma=chroma)
        assert sk.LAUNCHES["swar"] == before + 1
        ref = deblock_tiles_plain(tiles, *maps, beta, tc, chroma=chroma)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), qp


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(5, 70), (3, 72), (2, 80)],
                         ids=["half35-bytes", "half36-words4", "half40-words8"])
def test_swar_kernel_tails_on_card(rng, cuda_device, grid):
    """Tail blocks (Bx/2 not a multiple of the block) staged in each word
    size, luma and chroma, and with every BS byte 0."""
    for chroma in (False, True):
        for qp in (17, 35, 51):
            beta, tc = get_beta(qp), get_tc(qp)
            tiles = torch.from_numpy(_tiles(rng, (8, 8, *grid))).to(cuda_device)
            maps = [torch.from_numpy(m).to(cuda_device) for m in _maps(rng, grid)]
            out = sk.deblock_tiles_swar_cuda(tiles, *maps, beta, tc, chroma=chroma)
            ref = deblock_tiles_plain(tiles, *maps, beta, tc, chroma=chroma)
            torch.cuda.synchronize()
            assert torch.equal(out, ref), (chroma, qp)
        off = [torch.zeros_like(m) for m in maps]
        out = sk.deblock_tiles_swar_cuda(tiles, *off, 38, 4, chroma=chroma)
        torch.cuda.synchronize()
        assert torch.equal(out, tiles)


@pytest.mark.cuda
def test_swar_exp_on_card(cuda_device):
    assert swar_exp.main(["--check"])["ok"] is True
    race = swar_exp.main(["--race"])
    assert race["bit_exact"] is True and race["swar_over_int32"] > 0
    t = torch.zeros((8, 8, 3, 5), dtype=torch.uint8, device=cuda_device)
    m = torch.zeros((3, 5), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="even"):
        sk.deblock_tiles_swar_cuda(t, m, m, m, m, 36, 4)
