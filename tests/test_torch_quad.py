"""K1 and K1c's quad decomposition (csrc/deblock_quad.cuh): four lanes per
tile, a block of TB consecutive tiles staged in shared memory, each luma
segment's decision exchanged between the lanes of its quad.

Here on the CPU through the g++ build (csrc/host_shim.cpp,
gvct_host_deblock_tiles_quad): a block's 4 * TB threads run one after
another between the kernel's exchange points, arrays standing in for the
shuffles.  It is held byte for byte against deblock_tiles_plain at tail
grids (By*Bx not a multiple of TB), batched grids with shared and
per-frame maps and in place, staged in 1-, 4- and 8-byte words, for TB 32
and 64 and other block sizes from 1 to 64, and against the JAX package's
deblock_tiles_pallas in interpret mode.  Tests marked `cuda` launch the
kernel itself and skip without a card; the module imports nothing of JAX
at module level, so they also run where JAX is not installed
(`python -m pytest tests/test_torch_quad.py -m cuda`)."""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from gpu_video_codec_tpu_torch.ops import cuda_kernel as ck
from gpu_video_codec_tpu_torch.ops.deblock import (
    _PHASE_ORDER, _SEGMENT_GEOMETRY, _apply_phase, deblock_tiles_plain,
)
from gpu_video_codec_tpu_torch.ops.filters import luma_segment_decisions
from gpu_video_codec_tpu_torch.ops.tables import get_beta, get_tc

QPS = (0, 17, 30, 35, 51)
TBS = (32, 64)
BS_KINDS = ("random", "all-2")
# (tiles shape, map shape): 2-D grids at small By whose Bx is not a multiple
# of TB, a batch with one shared map, a batch with per-frame maps; the
# kernel stages in 1-byte words there, and in 4- and 8-byte words where the
# plane size By*Bx allows (132 = 4 mod 8, 248 and 128 = 0 mod 8)
GRIDS = [((8, 8, 2, bx), (2, bx)) for bx in (1, 3, 31, 33, 65)] + [
    ((2, 8, 8, 3, 33), (1, 3, 33)), ((3, 8, 8, 2, 65), (3, 2, 65)),
    ((8, 8, 4, 33), (4, 33)), ((8, 8, 8, 31), (8, 31)),
    ((2, 8, 8, 2, 64), (1, 2, 64)), ((3, 8, 8, 4, 33), (3, 4, 33))]
GRID_IDS = [f"bx{bx}" for bx in (1, 3, 31, 33, 65)] + [
    "batched-shared", "batched-per-frame", "words4", "words8", "batched-shared-words8",
    "batched-per-frame-words4"]


def _tiles(rng, shape):
    """uint8 tile-planes of flat blocks with small noise and steps between
    the tile's halves across both edges (strong, normal, and the normal
    filter's |delta0| gate both ways), a quarter of the tiles uniform noise
    (cond1 fails)."""
    cell = shape[:-4] + (1, 1) + shape[-2:]
    t = rng.integers(40, 216, cell) + rng.integers(-3, 4, shape)
    t[..., 4:, :, :, :] += rng.integers(-24, 25, cell)
    t[..., :, 4:, :, :] += rng.integers(-24, 25, cell)
    t = np.where(rng.random(cell) < 0.25, rng.integers(0, 256, shape), t)
    return np.clip(t, 0, 255).astype(np.uint8)


def _inputs(grid_index: int, qp: int, kind: str):
    """The tiles and maps of one case, the same wherever they are made."""
    shape, mshape = GRIDS[grid_index]
    rng = np.random.default_rng([grid_index, qp, BS_KINDS.index(kind)])
    tiles = _tiles(rng, shape)
    if kind == "all-2":
        maps = [np.full(mshape, 2, np.uint8) for _ in range(4)]
    else:
        maps = [rng.integers(0, 3, mshape, dtype=np.uint8) for _ in range(4)]
    return tiles, maps


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _quad(lib, tb, tiles, maps, beta, tc, chroma, out=None):
    """Run the quad kernel's blocks on the host over `tiles` into `out`
    (default: a new array)."""
    out = np.empty_like(tiles) if out is None else out
    nb = tiles.shape[0] if tiles.ndim == 5 else 1
    by, bx = tiles.shape[-2:]
    stride = 0 if tiles.ndim == 5 and maps[0].shape[0] == 1 else by * bx
    rc = lib.gvct_host_deblock_tiles_quad(tb, _ptr(tiles), _ptr(out), *(_ptr(m) for m in maps),
                                          beta, tc, nb, by, bx, stride, int(chroma))
    assert rc == 0
    return out


def _plain(tiles, maps, beta, tc, chroma):
    return deblock_tiles_plain(torch.from_numpy(tiles), *map(torch.from_numpy, maps), beta, tc,
                               chroma=chroma).numpy()


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


@pytest.mark.parametrize("tb", TBS)
@pytest.mark.parametrize("chroma", [False, True], ids=["luma", "chroma"])
@pytest.mark.parametrize("grid", range(len(GRIDS)), ids=GRID_IDS)
def test_quad_matches_plain(host_lib, grid, chroma, tb):
    changed = 0
    for qp in QPS:
        for kind in BS_KINDS:
            tiles, maps = _inputs(grid, qp, kind)
            beta, tc = get_beta(qp), get_tc(qp)
            out = _quad(host_lib, tb, tiles, maps, beta, tc, chroma)
            assert np.array_equal(out, _plain(tiles, maps, beta, tc, chroma)), (qp, kind)
            changed += int((out != tiles).sum())
    assert changed > 0


@pytest.mark.parametrize("chroma", [False, True], ids=["luma", "chroma"])
def test_quad_matches_pallas(host_lib, chroma):
    """The JAX package's kernel (interpret mode) on the widest tail grid,
    (8, 8, 2, 65): one block and a 1-tile tail at TB 64, two and a tail at
    TB 32."""
    import jax.numpy as jnp

    from gpu_video_codec_tpu.ops.pallas_kernel import deblock_tiles_pallas

    grid = GRID_IDS.index("bx65")
    for qp in QPS:
        for kind in BS_KINDS:
            tiles, maps = _inputs(grid, qp, kind)
            beta, tc = get_beta(qp), get_tc(qp)
            ref = np.asarray(deblock_tiles_pallas(jnp.asarray(tiles), *map(jnp.asarray, maps),
                                                  beta, tc, chroma=chroma))
            for tb in TBS:
                out = _quad(host_lib, tb, tiles, maps, beta, tc, chroma)
                assert np.array_equal(out, ref), (qp, kind, tb)


@pytest.mark.parametrize("tb", TBS)
@pytest.mark.parametrize("chroma", [False, True], ids=["luma", "chroma"])
@pytest.mark.parametrize("grid", [GRID_IDS.index(g) for g in ("bx33", "batched-per-frame",
                                                                  "words8")],
                         ids=["bx33", "batched-per-frame", "words8"])
def test_quad_in_place(host_lib, grid, chroma, tb):
    """in == out: a block stages all its bytes before it stores any."""
    for qp in (30, 51):
        tiles, maps = _inputs(grid, qp, "random")
        beta, tc = get_beta(qp), get_tc(qp)
        buf = tiles.copy()
        _quad(host_lib, tb, buf, maps, beta, tc, chroma, out=buf)
        assert np.array_equal(buf, _plain(tiles, maps, beta, tc, chroma)), qp


@pytest.mark.parametrize("tb", [1, 5, 12, 40, 64])
@pytest.mark.parametrize("chroma", [False, True], ids=["luma", "chroma"])
def test_quad_block_sizes(host_lib, chroma, tb):
    """Other block sizes up to the largest (64 tiles, 256 threads),
    staged in 1-, 4- and 8-byte words."""
    grid = GRID_IDS.index("batched-shared-words8")
    for qp in (35, 51):
        tiles, maps = _inputs(grid, qp, "random")
        beta, tc = get_beta(qp), get_tc(qp)
        assert np.array_equal(_quad(host_lib, tb, tiles, maps, beta, tc, chroma),
                              _plain(tiles, maps, beta, tc, chroma)), qp


def test_grids_cover_every_word_size(host_lib):
    """The kernel's choice of staging word (1, 4 or 8 bytes) over the
    grids and block sizes above: every size is tested."""
    seen = set()
    for shape, _ in GRIDS:
        a = np.zeros(shape, np.uint8)
        for tb in (*TBS, 1, 5, 12, 40, 64):
            seen.add(host_lib.gvct_host_quad_word_bytes(shape[-2] * shape[-1], tb, _ptr(a),
                                                        _ptr(a)))
    assert seen == {1, 4, 8}
    b = np.zeros(256 + 1, np.uint8)
    odd = b[1:].ctypes.data_as(ctypes.c_void_p)  # an address that is not 4-aligned
    assert host_lib.gvct_host_quad_word_bytes(248, 32, odd, _ptr(b)) == 1


def _outcomes(tiles, maps, beta, tc) -> dict:
    """How often the plain version's luma phases skip a BS-gated segment
    (cond1 fails), filter it strong or normal, and pass or stop a normal
    row at its |delta0| < 10 tc gate."""
    t = torch.from_numpy(tiles).to(torch.int32)
    if t.dim() == 5:
        t = t.permute(1, 2, 0, 3, 4)
    planes = [[t[r, c] for c in range(8)] for r in range(8)]
    seen = dict.fromkeys(("skip", "strong", "normal", "row passes", "row stops"), 0)
    for phase, bs in zip(_PHASE_ORDER, maps):
        p_at, q_at = _SEGMENT_GEOMETRY[phase]
        p = torch.stack([torch.stack([planes[p_at(r, j)[0]][p_at(r, j)[1]] for j in range(4)])
                         for r in range(4)])
        q = torch.stack([torch.stack([planes[q_at(r, j)[0]][q_at(r, j)[1]] for j in range(4)])
                         for r in range(4)])
        gate = torch.from_numpy(bs) > 0
        cond1, strong = luma_segment_decisions(p, q, beta, tc)
        normal = gate & cond1 & ~strong
        seen["skip"] += int((gate & ~cond1).sum())
        seen["strong"] += int((gate & cond1 & strong).sum())
        seen["normal"] += int(normal.sum())
        delta0 = (9 * (q[:, 0] - p[:, 0]) - 3 * (q[:, 1] - p[:, 1]) + 8) >> 4
        passes = delta0.abs() < 10 * tc
        seen["row passes"] += int((normal & passes).sum())
        seen["row stops"] += int((normal & ~passes).sum())
        _apply_phase(planes, phase, gate, beta, tc, False)
    return seen


def test_inputs_reach_every_outcome():
    """The luma inputs of test_quad_matches_plain reach every branch of the
    filter: skip, strong, normal, and the per-row gate both ways."""
    total = {}
    for grid in range(len(GRIDS)):
        for qp in QPS:
            for kind in BS_KINDS:
                tiles, maps = _inputs(grid, qp, kind)
                for k, v in _outcomes(tiles, maps, get_beta(qp), get_tc(qp)).items():
                    total[k] = total.get(k, 0) + v
    assert all(v > 0 for v in total.values()), total


def test_block_bx_is_checked(host_lib):
    """Both compute types run the quad kernel: 1..MAX_QUAD_BLOCK_BX tiles
    per block, in the wrapper and in both host entries."""
    t = torch.zeros((8, 8, 3, 5), dtype=torch.uint8)
    m = torch.zeros((3, 5), dtype=torch.uint8)
    for dtype in (torch.int32, torch.int16):
        for bad in (0, ck.MAX_QUAD_BLOCK_BX + 1):
            with pytest.raises(ValueError, match="block_bx"):
                ck.deblock_tiles_cuda(t, m, m, m, m, 38, 4, block_bx=bad, dtype=dtype)
        ck.deblock_tiles_cuda(t, m, m, m, m, 38, 4, block_bx=ck.MAX_QUAD_BLOCK_BX, dtype=dtype)
    a = np.zeros((8, 8, 3, 5), np.uint8)
    maps = [np.zeros((3, 5), np.uint8)] * 4
    for entry in (host_lib.gvct_host_deblock_tiles_quad, host_lib.gvct_host_deblock_tiles_i16):
        for bad in (0, ck.MAX_QUAD_BLOCK_BX + 1):
            assert entry(bad, _ptr(a), _ptr(a), *map(_ptr, maps), 38, 4, 1, 3, 5, 15, 0) == -1
        assert entry(ck.MAX_QUAD_BLOCK_BX, _ptr(a), _ptr(a), *map(_ptr, maps), 38, 4, 1, 3, 5,
                     15, 0) == 0


# -- on the card -------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("tb", TBS)
@pytest.mark.parametrize("form", [(False, (8, 8, 136, 241), (136, 241)),
                                  (True, (2, 8, 8, 68, 121), (1, 68, 121)),
                                  (False, (3, 8, 8, 2, 65), (3, 2, 65)),
                                  (True, (8, 8, 2, 33), (2, 33))],
                         ids=["1080p-luma", "1080p-chroma", "luma-tail-batched", "chroma-tail"])
def test_quad_kernel_matches_plain_on_card(cuda_device, form, tb):
    chroma, shape, mshape = form
    rng = np.random.default_rng(tb)
    for qp in QPS:
        for kind in BS_KINDS:
            tiles = torch.from_numpy(_tiles(rng, shape)).to(cuda_device)
            maps = [torch.from_numpy(np.full(mshape, 2, np.uint8) if kind == "all-2"
                                     else rng.integers(0, 3, mshape, dtype=np.uint8))
                    .to(cuda_device) for _ in range(4)]
            beta, tc = get_beta(qp), get_tc(qp)
            out = ck.deblock_tiles_cuda(tiles, *maps, beta, tc, chroma=chroma, block_bx=tb)
            ref = deblock_tiles_plain(tiles, *maps, beta, tc, chroma=chroma)
            torch.cuda.synchronize()
            assert torch.equal(out, ref), (qp, kind)
