"""Host layer of the PyTorch port against the JAX package: tables, YV12
I/O, boundary strength (Q4 strides, the Q2 out-of-bounds -> 0 rule, the
torch twin of segment_bs_maps_device, from_arrays), config, the golden
oracle, and a jax-free import of the whole port.  Every comparison is
byte-equal (all the math is integer)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import gpu_video_codec_tpu.models.golden as jgolden
import gpu_video_codec_tpu.ops.tables as jtables
import gpu_video_codec_tpu.utils.bs as jbs
import gpu_video_codec_tpu.utils.yuv as jyuv
import gpu_video_codec_tpu_torch.models.golden as tgolden
import gpu_video_codec_tpu_torch.ops.tables as ttables
import gpu_video_codec_tpu_torch.utils.bs as tbs
import gpu_video_codec_tpu_torch.utils.yuv as tyuv
from gpu_video_codec_tpu_torch.utils.config import BACKENDS, DeblockConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOMS = [(352, 288), (1920, 1080), (64, 72), (88, 72), (8, 8)]


def test_tables_identical():
    assert ttables.BETA_TABLE == jtables.BETA_TABLE
    assert ttables.TC_TABLE == jtables.TC_TABLE
    for qp in range(0, 70):
        assert ttables.get_beta(qp) == jtables.get_beta(qp)
        assert ttables.get_tc(qp) == jtables.get_tc(qp)
    with pytest.raises(ValueError):
        ttables.get_beta(-1)


@pytest.mark.parametrize("name", ["image1_352x288_yv12.yuv",
                                  "mother-daughter_352x288_yv12.yuv",
                                  "image2_768x576.yuv"])
def test_read_yv12_matches(testdata_dir, name):
    w, h = (768, 576) if "768" in name else (352, 288)
    path = os.path.join(testdata_dir, name)
    a, b = tyuv.read_yv12(path, w, h), jyuv.read_yv12(path, w, h)
    for k in ("y", "u", "v"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    assert tyuv.yv12_bytes_from_planes(a) == jyuv.yv12_bytes_from_planes(b)


def test_yuv_roundtrip_and_errors(rng, tmp_path):
    w, h = 64, 72
    raw = rng.integers(0, 256, 3 * w * h // 2, dtype=np.uint8)
    f = tyuv.planes_from_yv12_bytes(raw.tobytes(), w, h)
    assert f.y.shape == (h + 8, w + 8) and f.u.shape == (h // 2 + 8, w // 2 + 8)
    assert np.array_equal(tyuv.interior(f.y, h, w), raw[: w * h].reshape(h, w))
    path = tmp_path / "two.yuv"
    path.write_bytes(raw.tobytes() * 2)
    frames = tyuv.read_yv12_stream(path, w, h)
    assert len(frames) == 2
    tyuv.write_yv12(tmp_path / "out.yuv", frames[1])
    assert (tmp_path / "out.yuv").read_bytes() == raw.tobytes()
    with pytest.raises(ValueError):
        tyuv.planes_from_yv12_bytes(raw[:-1].tobytes(), w, h)
    with pytest.raises(ValueError):
        tyuv.check_dims(100, 50)


@pytest.mark.parametrize("w,h", GEOMS)
def test_intra_default_q4_strides(w, h):
    a, b = tbs.BoundaryStrength.intra_default(w, h), jbs.BoundaryStrength.intra_default(w, h)
    for k in ("vert", "hor", "chroma_vert", "chroma_hor"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    # Q4: the horizontal zero stripe strides by H/8 + 1, not by the W/8 lookup stride
    assert np.array_equal(np.flatnonzero(a.hor == 0), np.arange(0, a.hor.size, h // 8 + 1))
    assert np.array_equal(np.flatnonzero(a.vert == 0), np.arange(0, a.vert.size, w // 8 + 1))


@pytest.mark.parametrize("w,h", GEOMS)
def test_segment_maps_match_and_q2(rng, w, h):
    a = tbs.BoundaryStrength.intra_default(w, h)
    a.set_luma(rng.integers(0, 3, a.vert.size, dtype=np.uint8),
               rng.integers(0, 3, a.hor.size, dtype=np.uint8))
    a.set_chroma(rng.integers(0, 3, a.chroma_vert.size, dtype=np.uint8),
                 rng.integers(0, 3, a.chroma_hor.size, dtype=np.uint8))
    b = jbs.BoundaryStrength.intra_default(w, h)
    b.set_luma(a.vert, a.hor)
    b.set_chroma(a.chroma_vert, a.chroma_hor)
    for fn in ("luma_segment_maps", "chroma_segment_maps"):
        for x, y in zip(getattr(tbs, fn)(a), getattr(jbs, fn)(b)):
            assert x.dtype == np.uint8 and np.array_equal(x, y), fn


def test_q2_out_of_bounds_reads_zero():
    # chroma gates use the luma tile counts (Q2), so reads past the chroma
    # arrays happen; every one of them must read 0
    flat = np.full(5, 2, np.uint8)
    maps = tbs.segment_bs_maps(flat, flat, 8, 4, 4, 4, 4)
    v1 = maps[0]
    assert v1[0].sum() == 0  # by == 0: gated off
    # ver1 index (by-1)*2 + bx: by=3, bx=3 -> 7 >= 5 -> OOB -> 0
    assert v1[3, 3] == 0 and v1[1, 0] == 2
    empty = np.zeros(0, np.uint8)
    assert all(m.sum() == 0 for m in tbs.segment_bs_maps(empty, empty, 0, 2, 2, 2, 2))


@pytest.mark.parametrize("w,h", [(352, 288), (64, 72), (88, 72), (8, 8)])
def test_segment_maps_device_twin(rng, w, h):
    a = tbs.BoundaryStrength.intra_default(w, h)
    a.set_luma(rng.integers(0, 3, a.vert.size, dtype=np.uint8),
               rng.integers(0, 3, a.hor.size, dtype=np.uint8))
    a.set_chroma(rng.integers(0, 3, a.chroma_vert.size, dtype=np.uint8),
                 rng.integers(0, 3, a.chroma_hor.size, dtype=np.uint8))
    ny, nx = h // 8 + 1, w // 8 + 1
    cny, cnx = (h // 2) // 8 + 1, (w // 2) // 8 + 1
    for args in ((a.vert, a.hor, w, ny, nx, ny, nx),
                 (a.chroma_vert, a.chroma_hor, w // 2, cny, cnx, ny, nx)):
        mine = tbs.segment_bs_maps_device(*args, device="cpu")
        ref = jbs.segment_bs_maps_device(*args)
        host = tbs.segment_bs_maps(*args)
        for m, r, s in zip(mine, ref, host):
            assert m.dtype == torch.uint8 and m.is_contiguous()
            assert np.array_equal(m.numpy(), np.asarray(r))
            assert np.array_equal(m.numpy(), s)


def test_from_arrays(rng):
    w, h = 64, 72
    j = jbs.BoundaryStrength.intra_default(w, h)
    j.set_luma(rng.integers(0, 3, j.vert.size, dtype=np.uint8),
               rng.integers(0, 3, j.hor.size, dtype=np.uint8))
    # from another package's object (duck-typed) and from the six values
    a = tbs.BoundaryStrength.from_arrays(j)
    b = tbs.BoundaryStrength.from_arrays(w, h, j.vert, j.hor, j.chroma_vert, j.chroma_hor)
    for bs in (a, b):
        assert isinstance(bs, tbs.BoundaryStrength) and (bs.width, bs.height) == (w, h)
        for k in ("vert", "hor", "chroma_vert", "chroma_hor"):
            assert np.array_equal(getattr(bs, k), getattr(j, k))
            assert getattr(bs, k) is not getattr(j, k)
    with pytest.raises(ValueError):
        tbs.BoundaryStrength.from_arrays(w, h, j.vert[:-1], j.hor, j.chroma_vert, j.chroma_hor)
    with pytest.raises(ValueError):
        tbs.BoundaryStrength.from_arrays(w, h, j.vert, j.hor, j.chroma_vert, j.chroma_hor[1:])


def test_config_backends():
    assert BACKENDS == ("cuda", "torch", "golden", "native")
    assert DeblockConfig("x", 64, 48).validate().backend == "cuda"
    assert DeblockConfig("x", 64, 48).validate().num_threads == 0
    for bad in (dict(backend="pallas"), dict(width=50), dict(qp=-1), dict(depth=0),
                dict(frames=0), dict(num_threads=-1)):
        kw = dict(input="x", width=64, height=48) | bad
        with pytest.raises(ValueError):
            DeblockConfig(**kw).validate()


def _blocky_frame(rng, w, h, mod):
    """Piecewise-flat 8x8 blocks plus small noise: steps at block edges that
    the strong and normal filters both act on."""
    def plane(hh, ww):
        steps = rng.integers(-14, 15, (hh // 8 + 1, ww // 8 + 1))
        means = 128 + np.cumsum(steps, axis=1) // 2 + np.cumsum(steps, axis=0) // 3
        img = np.kron(means, np.ones((8, 8), np.int64))[:hh, :ww]
        img = img + rng.integers(-2, 3, img.shape)
        return np.clip(img, 0, 255).astype(np.uint8)
    return mod.FramePlanes(mod.extend_plane(plane(h, w)), mod.extend_plane(plane(h // 2, w // 2)),
                           mod.extend_plane(plane(h // 2, w // 2)), w, h)


@pytest.mark.parametrize("w,h,qp,luma_only", [
    (352, 288, 35, False), (64, 72, 30, False), (88, 72, 45, False),
    (56, 72, 51, False), (64, 48, 37, True), (8, 8, 40, False),
])
def test_golden_matches_jax_golden(rng, w, h, qp, luma_only):
    tf = _blocky_frame(rng, w, h, tyuv)
    jf = jyuv.FramePlanes(tf.y, tf.u, tf.v, w, h)
    bs = tbs.BoundaryStrength.intra_default(w, h)
    bs.set_luma(rng.integers(0, 3, bs.vert.size, dtype=np.uint8),
                rng.integers(0, 3, bs.hor.size, dtype=np.uint8))
    a = tgolden.deblock_frame_golden(tf, bs, qp, luma_only=luma_only)
    jb = jbs.BoundaryStrength(w, h, bs.vert, bs.hor, bs.chroma_vert, bs.chroma_hor)
    b = jgolden.deblock_frame_golden(jf, jb, qp, luma_only=luma_only)
    for k in ("y", "u", "v"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    assert not np.array_equal(a.y, tf.y)


def test_golden_on_bundled_frame(testdata_dir):
    path = os.path.join(testdata_dir, "mother-daughter_352x288_yv12.yuv")
    a = tgolden.deblock_frame_golden(tyuv.read_yv12(path, 352, 288),
                                     tbs.BoundaryStrength.intra_default(352, 288), 35)
    b = jgolden.deblock_frame_golden(jyuv.read_yv12(path, 352, 288),
                                     jbs.BoundaryStrength.intra_default(352, 288), 35)
    assert tyuv.yv12_bytes_from_planes(a) == jyuv.yv12_bytes_from_planes(b)
    with pytest.raises(ValueError):
        tgolden.deblock_frame_golden(tyuv.read_yv12(path, 352, 288),
                                     tbs.BoundaryStrength.intra_default(64, 48), 35)


def test_port_imports_without_jax():
    """The port must import, whole, where jax cannot be imported."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import gpu_video_codec_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'gpu_video_codec_tpu' "
        "or m.startswith('gpu_video_codec_tpu.')]\n"
        "assert not bad, bad\n"
        "assert len(names) >= 14, names\n"
        "assert {pkg.__name__ + '.parallel.' + m for m in ('mesh', 'multistream', "
        "'resident_mesh')} <= set(names), names\n"
        "print('ok', len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
