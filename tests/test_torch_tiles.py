"""Tile-planes layout of the PyTorch port (the transpose engine) against
gpu_video_codec_tpu.utils.tiles on numpy, byte for byte: CIF, 1920x1080,
64x72 (h % 16 == 8, like 1080p) and 88x72 (sheared chroma, w % 16 == 8)."""

import numpy as np
import pytest
import torch

import gpu_video_codec_tpu.utils.tiles as jt
import gpu_video_codec_tpu_torch.utils.tiles as tt

GEOMS = [(352, 288), (1920, 1080), (64, 72), (88, 72)]
PAD = 4


def _planes(rng, w, h):
    """(name, interior plane) for luma, one chroma plane and the U/V pair."""
    return [
        ("luma", rng.integers(0, 256, (h, w), dtype=np.uint8)),
        ("chroma", rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)),
        ("uv", rng.integers(0, 256, (2, h // 2, w // 2), dtype=np.uint8)),
    ]


@pytest.mark.parametrize("w,h", GEOMS)
def test_plane_to_tiles_roundtrip(rng, w, h):
    for name, plane in _planes(rng, w, h):
        ext = np.pad(plane, [(0, 0)] * (plane.ndim - 2) + [(PAD, PAD), (PAD, PAD)])
        if ext.shape[-1] % 8 or ext.shape[-2] % 8:
            continue  # chroma not 8-aligned: swept through split_covered instead
        t = tt.plane_to_tiles(torch.from_numpy(ext))
        assert np.array_equal(t.numpy(), jt.plane_to_tiles(ext)), name
        assert np.array_equal(tt.tiles_to_plane(t.contiguous()).numpy(), ext), name
    with pytest.raises(ValueError):
        tt.plane_to_tiles(torch.zeros((12, 16), dtype=torch.uint8))


@pytest.mark.parametrize("w,h", GEOMS)
def test_split_and_join_covered(rng, w, h):
    for name, plane in _planes(rng, w, h):
        ext = np.pad(plane, [(0, 0)] * (plane.ndim - 2) + [(PAD, PAD), (PAD, PAD)])
        core, paste = tt.split_covered(torch.from_numpy(ext))
        jcore, jpaste = jt.split_covered(ext)
        assert np.array_equal(core.numpy(), jcore), name
        filtered = (core.to(torch.int32) * 7 % 251).to(torch.uint8)
        assert np.array_equal(paste(filtered).numpy(), jpaste(filtered.numpy(), np)), name
        c2, rem = tt.split_covered_data(torch.from_numpy(ext))
        jc2, jrem = jt.split_covered_data(ext)
        assert np.array_equal(c2.numpy(), jc2) and np.array_equal(rem.numpy(), jrem), name
        back = tt.join_covered(filtered, rem, ext.shape[-2], ext.shape[-1])
        jback = jt.join_covered(filtered.numpy(), jrem, ext.shape[-2], ext.shape[-1], np)
        assert np.array_equal(back.numpy(), jback), name


@pytest.mark.parametrize("w,h", GEOMS)
def test_interior_to_tiles_and_back(rng, w, h):
    for name, plane in _planes(rng, w, h):
        if (plane.shape[-1] + 2 * PAD) % 8:
            with pytest.raises(ValueError):
                tt.interior_to_tiles(torch.from_numpy(plane), PAD)
            continue
        t = tt.interior_to_tiles(torch.from_numpy(plane), PAD)
        ref = jt.interior_to_tiles(plane, PAD)
        assert np.array_equal(t.numpy(), ref), name
        hh, ww = plane.shape[-2:]
        back = tt.tiles_to_interior(t.contiguous(), PAD, hh, ww)
        assert np.array_equal(back.numpy(), plane), name
        assert np.array_equal(back.numpy(), jt.tiles_to_interior(ref, PAD, hh, ww)), name


@pytest.mark.parametrize("w,h", [(352, 288), (64, 72)])
def test_interior_to_tiles_grid_padding(rng, w, h):
    """by_grid/bx_grid pad the grid with zero (no-op) tiles, as the JAX
    transpose engine does, and tiles_to_interior ignores them."""
    plane = rng.integers(0, 256, (h, w), dtype=np.uint8)
    by, bx = (h + 2 * PAD) // 8, (w + 2 * PAD) // 8
    t = tt.interior_to_tiles(torch.from_numpy(plane), PAD, by_grid=by + 3, bx_grid=bx + 5)
    ref = jt.interior_to_tiles(plane, PAD, by_grid=by + 3, bx_grid=bx + 5)
    assert t.shape == (8, 8, by + 3, bx + 5)
    assert np.array_equal(t.numpy(), ref)
    assert int(t[..., by:, :].sum()) == 0 and int(t[..., bx:].sum()) == 0
    assert np.array_equal(tt.tiles_to_interior(t, PAD, h, w).numpy(), plane)
    with pytest.raises(ValueError):
        tt.interior_to_tiles(torch.from_numpy(plane), PAD, by_grid=by - 1)


def test_interior_to_tiles_1080p_chroma_rows():
    # chroma height 540: only 544 of the 548 extended rows are covered, so
    # the bottom Q6 padding is clipped (bot == 0) and the grid has 68 rows
    plane = torch.arange(540 * 960, dtype=torch.int64).remainder(251).to(torch.uint8)
    t = tt.interior_to_tiles(plane.reshape(540, 960), PAD)
    assert t.shape == (8, 8, 68, 121)
    assert np.array_equal(t.numpy(), jt.interior_to_tiles(plane.reshape(540, 960).numpy(), PAD))
