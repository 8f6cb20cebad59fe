"""T5, the deblock kernel on the (By, 8, 8, Bx) "rows" tile layout, of the
PyTorch port (deblock_rows_cuda, ops/deblock.deblock_rows_plain).

Here on the CPU: the plain version and the kernel's grid loop (csrc
deblock_tile.cuh with the rows layout's strides, compiled with g++ through
csrc/host_shim.cpp) against the JAX tool's own Pallas kernel,
tools/rowslayout_exp.deblock_rows_layout, in interpret mode; the wrapper's
checks; and the rowslayout_exp entry point.  Tests marked `cuda` launch
the kernel and skip without a card; JAX is imported only inside the tests
that compare with it, so the `cuda` tests also run where JAX is not
installed (`python -m pytest tests/test_torch_rows.py -m cuda`).  Every
comparison is byte-equal."""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from gpu_video_codec_tpu_torch.ops import cuda_kernel as ck
from gpu_video_codec_tpu_torch.ops.deblock import deblock_rows_plain, deblock_tiles_plain
from gpu_video_codec_tpu_torch.ops.tables import get_beta, get_tc
from gpu_video_codec_tpu_torch.tools import rowslayout_exp


def _tiles(rng, shape):
    """uint8 tile-planes (8, 8, By, Bx) mixing flat blocks with small steps
    and uniform noise."""
    flat = rng.integers(40, 216, (1, 1) + shape[-2:])
    t = flat + rng.integers(-3, 4, shape)
    t[4:] += rng.integers(-20, 21, (1, 1) + shape[-2:])
    t = np.where(rng.random((1, 1) + shape[-2:]) < 0.25, rng.integers(0, 256, shape), t)
    return np.clip(t, 0, 255).astype(np.uint8)


def _rows(tiles):
    return np.ascontiguousarray(tiles.transpose(2, 0, 1, 3))


def _maps(rng, shape):
    return [rng.integers(0, 3, shape, dtype=np.uint8) for _ in range(4)]


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


def _host_rows(lib, rows, maps, beta, tc, chroma):
    out = np.empty_like(rows)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    lib.gvct_host_deblock_rows(ptr(rows), ptr(out), *(ptr(m) for m in maps), beta, tc,
                               rows.shape[0], rows.shape[3], int(chroma))
    return out


@pytest.mark.parametrize("chroma", [False, True])
def test_rows_match_pallas_tool(rng, host_lib, chroma):
    """deblock_rows_plain, deblock_rows_cuda on CPU tensors and the host
    build == the JAX deblock_rows_layout (interpret, block 8x16) at
    (8, 8, 8, 16), and == the canonical deblock permuted."""
    import jax.numpy as jnp

    from tools.rowslayout_exp import deblock_rows_layout

    for qp in (22, 37, 51):
        beta, tc = get_beta(qp), get_tc(qp)
        tiles = _tiles(rng, (8, 8, 8, 16))
        rows, maps = _rows(tiles), _maps(rng, (8, 16))
        want = np.asarray(deblock_rows_layout(jnp.asarray(rows), *map(jnp.asarray, maps), beta,
                                              tc, chroma=chroma, block_by=8, block_bx=16))
        tr, tm = torch.from_numpy(rows), [torch.from_numpy(m) for m in maps]
        plain = deblock_rows_plain(tr, *tm, beta, tc, chroma=chroma)
        assert plain.is_contiguous() and np.array_equal(plain.numpy(), want), qp
        before = dict(ck.LAUNCHES)
        assert torch.equal(ck.deblock_rows_cuda(tr, *tm, beta, tc, chroma=chroma), plain)
        assert ck.LAUNCHES == before  # the CPU path launches nothing
        assert np.array_equal(_host_rows(host_lib, rows, maps, beta, tc, chroma), want), qp
        canon = deblock_tiles_plain(torch.from_numpy(tiles), *tm, beta, tc, chroma=chroma)
        assert torch.equal(plain.permute(1, 2, 0, 3), canon)
        assert not np.array_equal(want, rows)


@pytest.mark.parametrize("chroma", [False, True])
@pytest.mark.parametrize("grid", [(3, 5), (1, 1), (17, 33)], ids=["tail", "one-tile", "wide"])
def test_host_rows_matches_plain(rng, host_lib, grid, chroma):
    """The kernel's rows-layout grid loop == deblock_rows_plain over random
    grids and QPs in 0..51."""
    changed = 0
    for qp in (0, 51, *rng.integers(1, 51, 4)):
        beta, tc = get_beta(int(qp)), get_tc(int(qp))
        rows, maps = _rows(_tiles(rng, (8, 8, *grid))), _maps(rng, grid)
        ref = deblock_rows_plain(torch.from_numpy(rows), *map(torch.from_numpy, maps), beta, tc,
                                 chroma=chroma)
        out = _host_rows(host_lib, rows, maps, beta, tc, chroma)
        assert np.array_equal(out, ref.numpy()), qp
        changed += int((out != rows).sum())
    assert changed > 0


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

@pytest.mark.cuda
@pytest.mark.parametrize("chroma", [False, True])
@pytest.mark.parametrize("grid", [(3, 5), (136, 241), (136, 256)],
                         ids=["tail", "1080p-luma", "race-grid"])
def test_rows_kernel_matches_plain_on_card(rng, cuda_device, grid, chroma):
    for qp in (0, 17, 30, 35, 51):
        beta, tc = get_beta(qp), get_tc(qp)
        rows = torch.from_numpy(_rows(_tiles(rng, (8, 8, *grid)))).to(cuda_device)
        maps = [torch.from_numpy(m).to(cuda_device) for m in _maps(rng, grid)]
        before = ck.LAUNCHES["rows"]
        out = ck.deblock_rows_cuda(rows, *maps, beta, tc, chroma=chroma)
        assert ck.LAUNCHES["rows"] == before + 1
        ref = deblock_rows_plain(rows, *maps, beta, tc, chroma=chroma)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), qp


@pytest.mark.cuda
def test_rowslayout_entry_point_on_card(cuda_device):
    res = rowslayout_exp.main([])
    assert res["bit_exact"] is True
    assert res["canonical_us"] > 0 and res["rows_layout_us"] > 0
