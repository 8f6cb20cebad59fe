"""Torch int32 filter math and whole-frame deblock of the PyTorch port
against gpu_video_codec_tpu.ops (filters, deblock_tiles, deblock_frame).
Inputs come from a seeded numpy generator; every comparison is byte-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpu_video_codec_tpu.ops.deblock as jdeblock
import gpu_video_codec_tpu.ops.filters as jfilters
import gpu_video_codec_tpu.utils.bs as jbs
import gpu_video_codec_tpu.utils.tiles as jtiles
import gpu_video_codec_tpu_torch.ops.deblock as tdeblock
import gpu_video_codec_tpu_torch.ops.filters as tfilters
from gpu_video_codec_tpu_torch.ops.tables import get_beta, get_tc
from gpu_video_codec_tpu_torch.utils.yuv import extend_plane

QPS = range(0, 61)


def _segments(rng, kind, nj, shape=(6, 7)):
    """p, q (4, nj, *shape) int pixels.  'uniform': any bytes (mostly no
    filtering); 'smooth': flat sides with a small step across the edge, so
    the strong and the normal filter both fire; 'extreme': 0/255 steps."""
    full = (4, nj, *shape)
    if kind == "uniform":
        return rng.integers(0, 256, full), rng.integers(0, 256, full)
    if kind == "extreme":
        return rng.choice([0, 1, 254, 255], full), rng.choice([0, 1, 254, 255], full)
    base = rng.integers(20, 236, (1, 1, *shape))
    step = rng.integers(-24, 25, (1, 1, *shape))
    p = base + rng.integers(-2, 3, full)
    q = base + step + rng.integers(-2, 3, full)
    return np.clip(p, 0, 255), np.clip(q, 0, 255)


@pytest.mark.parametrize("kind", ["uniform", "smooth", "extreme"])
def test_luma_filter_matches_jax(rng, kind):
    fired = {"strong": 0, "normal": 0}
    for qp in QPS:
        p, q = _segments(rng, kind, 4)
        bs = rng.integers(0, 3, p.shape[2:]) > 0
        beta, tc = get_beta(qp), get_tc(qp)
        tp, tq = tfilters.luma_edge_filter(torch.from_numpy(p), torch.from_numpy(q),
                                           torch.from_numpy(bs), beta, tc)
        jp, jq = jfilters.luma_edge_filter(jnp.asarray(p), jnp.asarray(q),
                                           jnp.asarray(bs), beta, tc)
        assert tp.dtype == torch.int32
        assert np.array_equal(tp.numpy(), np.asarray(jp)), qp
        assert np.array_equal(tq.numpy(), np.asarray(jq)), qp
        c1, strong = tfilters.luma_segment_decisions(torch.from_numpy(p), torch.from_numpy(q),
                                                     beta, tc)
        jc1, jstrong = jfilters.luma_segment_decisions(jnp.asarray(p), jnp.asarray(q), beta, tc)
        assert np.array_equal(c1.numpy(), np.asarray(jc1))
        assert np.array_equal(strong.numpy(), np.asarray(jstrong))
        fired["strong"] += int((c1 & strong & torch.from_numpy(bs)).sum())
        fired["normal"] += int((c1 & ~strong & torch.from_numpy(bs)).sum())
    if kind == "smooth":
        assert fired["strong"] > 0 and fired["normal"] > 0, fired


@pytest.mark.parametrize("kind", ["uniform", "smooth", "extreme"])
def test_chroma_filter_matches_jax(rng, kind):
    for qp in QPS:
        p, q = _segments(rng, kind, 2)
        bs = rng.integers(0, 3, p.shape[2:]) == 2
        tc = get_tc(qp)
        tp, tq = tfilters.chroma_edge_filter(torch.from_numpy(p), torch.from_numpy(q),
                                             torch.from_numpy(bs), tc)
        jp, jq = jfilters.chroma_edge_filter(jnp.asarray(p), jnp.asarray(q), jnp.asarray(bs), tc)
        assert np.array_equal(tp.numpy(), np.asarray(jp)), qp
        assert np.array_equal(tq.numpy(), np.asarray(jq)), qp


def test_chroma_pq_asymmetry():
    # dq uses swapped operands and is subtracted: with p0 - q0 = -1 and
    # p1 == q1, dp = (-4 + 4) >> 3 = 0 but dq = (4 + 4) >> 3 = 1, so q0
    # moves and p0 does not (q0 + dp would leave both alone)
    p = torch.tensor([[[[100]], [[100]]]] * 4, dtype=torch.int32)
    q = torch.tensor([[[[101]], [[100]]]] * 4, dtype=torch.int32)
    mask = torch.ones((1, 1), dtype=torch.bool)
    tp, tq = tfilters.chroma_edge_filter(p, q, mask, 5)
    jp, jq = jfilters.chroma_edge_filter(jnp.asarray(p.numpy()), jnp.asarray(q.numpy()),
                                         jnp.asarray(mask.numpy()), 5)
    assert int(tp[0, 0, 0, 0]) == 100 and int(tq[0, 0, 0, 0]) == 100
    assert np.array_equal(tp.numpy(), np.asarray(jp)) and np.array_equal(tq.numpy(), np.asarray(jq))


def _blocky_tiles(rng, by, bx, lead=()):
    """(*lead, 8, 8, by, bx) uint8 tile-planes of a piecewise-flat plane with
    block edges at tile-local 3|4, where the filters look."""
    h, w = 8 * by, 8 * bx
    n = int(np.prod(lead)) if lead else 1
    steps = rng.integers(-16, 17, (n, by + 1, bx + 1))
    means = 128 + np.cumsum(steps, axis=2) // 2 + np.cumsum(steps, axis=1) // 3
    img = np.kron(means, np.ones((1, 8, 8), np.int64))[:, 4 : 4 + h, 4 : 4 + w]
    img = np.clip(img + rng.integers(-2, 3, img.shape), 0, 255).astype(np.uint8)
    t = img.reshape(n, by, 8, bx, 8).transpose(0, 2, 4, 1, 3)
    return np.ascontiguousarray(t.reshape(*lead, 8, 8, by, bx))


@pytest.mark.parametrize("chroma", [False, True])
@pytest.mark.parametrize("qp", [0, 17, 27, 35, 43, 51])
def test_deblock_tiles_matches_jax(rng, chroma, qp):
    by, bx = 5, 9
    tiles = _blocky_tiles(rng, by, bx)
    maps = [rng.integers(0, 3, (by, bx), dtype=np.uint8) for _ in range(4)]
    beta, tc = get_beta(qp), get_tc(qp)
    out = tdeblock.deblock_tiles(torch.from_numpy(tiles), *map(torch.from_numpy, maps),
                                 beta, tc, chroma=chroma)
    ref = jdeblock.deblock_tiles(jnp.asarray(tiles), *map(jnp.asarray, maps), beta, tc,
                                 chroma=chroma)
    assert out.dtype == torch.uint8
    assert np.array_equal(out.numpy(), np.asarray(ref))
    if qp >= 35:
        assert not np.array_equal(out.numpy(), tiles)


@pytest.mark.parametrize("chroma", [False, True])
def test_deblock_tiles_plain_batched_forms(rng, chroma):
    """The kernel's batched forms (per-frame and shared maps) equal a loop
    of 2-D calls."""
    nb, by, bx = 3, 4, 6
    tiles = torch.from_numpy(_blocky_tiles(rng, by, bx, lead=(nb,)))
    per = [torch.from_numpy(rng.integers(0, 3, (nb, by, bx), dtype=np.uint8)) for _ in range(4)]
    shared = [m[:1].contiguous() for m in per]
    for maps, pick in ((per, lambda m, i: m[i]), (shared, lambda m, i: m[0])):
        out = tdeblock.deblock_tiles_plain(tiles, *maps, 64, 20, chroma=chroma)
        assert out.shape == tiles.shape and out.is_contiguous()
        for i in range(nb):
            ref = tdeblock.deblock_tiles(tiles[i], *(pick(m, i) for m in maps), 64, 20,
                                         chroma=chroma)
            assert torch.equal(out[i], ref)


@pytest.mark.parametrize("w,h", [(64, 72), (88, 72), (352, 288)])
@pytest.mark.parametrize("luma_only", [False, True])
def test_deblock_frame_matches_jax(rng, w, h, luma_only):
    qp = 37
    y = extend_plane(rng.integers(0, 256, (h, w), dtype=np.uint8))
    u = extend_plane(rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
    v = extend_plane(rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
    bs = jbs.BoundaryStrength.intra_default(w, h)
    lm, cm = jbs.luma_segment_maps(bs), jbs.chroma_segment_maps(bs)
    beta, tc = get_beta(qp), get_tc(qp)
    out = tdeblock.deblock_frame(*(torch.from_numpy(a) for a in (y, u, v)),
                                 [torch.from_numpy(m) for m in lm],
                                 [torch.from_numpy(m) for m in cm], beta, tc,
                                 luma_only=luma_only)
    ref = jdeblock.deblock_frame(*(jnp.asarray(a) for a in (y, u, v)),
                                 [jnp.asarray(m) for m in lm], [jnp.asarray(m) for m in cm],
                                 beta, tc, luma_only=luma_only)
    for a, b in zip(out, ref):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_deblock_plane_sheared_remainder_untouched(rng):
    # w % 16 == 8: the chroma sweep is the sheared flat view, and the flat
    # remainder past 8*ncby x 8*ncbx bytes passes through (Q9)
    ext = rng.integers(0, 256, (44, 52), dtype=np.uint8)  # chroma of 88x72 (+8 each)
    maps = [np.full((5, 6), 2, np.uint8)] * 4
    out = tdeblock.deblock_plane(torch.from_numpy(ext), [torch.from_numpy(m) for m in maps],
                                 64, 20, chroma=True)
    core, _ = jtiles.split_covered(ext)
    n = core.size
    assert np.array_equal(out.numpy().ravel()[n:], ext.ravel()[n:])
    ref = jdeblock.deblock_plane(jnp.asarray(ext), [jnp.asarray(m) for m in maps], 64, 20,
                                 chroma=True)
    assert np.array_equal(out.numpy(), np.asarray(ref))
