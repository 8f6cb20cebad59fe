"""The port's DeblockPipeline (gpu_video_codec_tpu_torch/models/pipeline.py)
against the JAX package's, byte for byte, on the CPU: every port backend
(cuda -- the kernels' plain versions on a CPU device --, torch, golden,
native) against the JAX "jnp" pipeline, and "pallas" as the JAX tests run
it here; batch() against the JAX batch(); the errors.  The launch counts
on the card are in tests/test_torch_drivers.py (no JAX there)."""

import os

import numpy as np
import pytest

import gpu_video_codec_tpu.utils.bs as jbs
import gpu_video_codec_tpu.utils.yuv as jyuv
from gpu_video_codec_tpu.models.pipeline import DeblockPipeline as JaxPipeline
from gpu_video_codec_tpu_torch.models.pipeline import DeblockPipeline
from gpu_video_codec_tpu_torch.utils.bs import BoundaryStrength
from gpu_video_codec_tpu_torch.utils.yuv import FramePlanes, extend_plane, read_yv12

BACKENDS = ("cuda", "torch", "golden", "native")
GEOMS = [(40, 24), (48, 40), (64, 72), (88, 72)]
GEOM_IDS = ["sheared-40x24", "48x40", "64x72", "sheared-88x72"]


def _frame(rng, w, h):
    return FramePlanes(*(extend_plane(rng.integers(0, 256, s, dtype=np.uint8))
                         for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))), w, h)


def _jframe(f):
    return jyuv.FramePlanes(f.y, f.u, f.v, f.width, f.height)


def _jbs(bs):
    return jbs.BoundaryStrength(bs.width, bs.height, bs.vert, bs.hor, bs.chroma_vert,
                                bs.chroma_hor)


def _random_bs(rng, w, h):
    bs = BoundaryStrength.intra_default(w, h)
    bs.set_luma(rng.integers(0, 3, bs.vert.size, dtype=np.uint8),
                rng.integers(0, 3, bs.hor.size, dtype=np.uint8))
    bs.set_chroma(rng.integers(0, 3, bs.chroma_vert.size, dtype=np.uint8),
                  rng.integers(0, 3, bs.chroma_hor.size, dtype=np.uint8))
    return bs


def _same(a, b, what=""):
    for k in "yuv":
        assert np.array_equal(np.asarray(getattr(a, k)), np.asarray(getattr(b, k))), (what, k)


@pytest.mark.parametrize("luma_only", [False, True], ids=["full", "luma_only"])
@pytest.mark.parametrize("w,h", GEOMS, ids=GEOM_IDS)
def test_backends_match_jax_jnp(rng, w, h, luma_only):
    frame = _frame(rng, w, h)
    ref = JaxPipeline(w, h, 37, luma_only=luma_only, backend="jnp")(_jframe(frame))
    for backend in BACKENDS:
        out = DeblockPipeline(w, h, 37, luma_only=luma_only, backend=backend,
                              device="cpu")(frame)
        _same(out, ref, backend)
        assert out.y is not frame.y and out.u is not frame.u  # new planes, input intact


@pytest.mark.parametrize("w,h", [(64, 48), (88, 72)], ids=["64x48", "sheared-88x72"])
def test_cuda_backend_matches_jax_pallas(rng, w, h):
    """The JAX pallas pipeline as its tests run it on the CPU (the Pallas
    kernel in interpret mode)."""
    frame = _frame(rng, w, h)
    ref = JaxPipeline(w, h, 35, backend="pallas")(_jframe(frame))
    _same(DeblockPipeline(w, h, 35, device="cpu")(frame), ref)


@pytest.mark.parametrize("backend", BACKENDS)
def test_bundled_frame_matches_jax(testdata_dir, backend):
    path = os.path.join(testdata_dir, "mother-daughter_352x288_yv12.yuv")
    frame = read_yv12(path, 352, 288)
    ref = JaxPipeline(352, 288, 35, backend="golden")(jyuv.read_yv12(path, 352, 288))
    _same(DeblockPipeline(352, 288, 35, backend=backend, device="cpu")(frame), ref)


@pytest.mark.parametrize("backend", BACKENDS)
def test_set_boundary_strength_random(rng, backend):
    """Random luma and chroma BS (0-2), installed at construction and
    swapped with set_boundary_strength, as the JAX pipeline filters."""
    w, h = 88, 72
    frame = _frame(rng, w, h)
    bs1, bs2 = _random_bs(rng, w, h), _random_bs(rng, w, h)
    pipe = DeblockPipeline(w, h, 40, backend=backend, bs=bs1, num_threads=2, device="cpu")
    jpipe = JaxPipeline(w, h, 40, backend="jnp", bs=_jbs(bs1))
    _same(pipe(frame), jpipe(_jframe(frame)), "bs1")
    pipe.set_boundary_strength(bs2)
    jpipe.set_boundary_strength(_jbs(bs2))
    _same(pipe(frame), jpipe(_jframe(frame)), "bs2")


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("w,h", GEOMS, ids=GEOM_IDS)
def test_batch_matches_jax_batch(rng, w, h, backend):
    frames = [_frame(rng, w, h) for _ in range(3)]
    bs = _random_bs(rng, w, h)
    outs = DeblockPipeline(w, h, 35, backend=backend, bs=bs, device="cpu").batch(frames)
    refs = JaxPipeline(w, h, 35, backend="jnp", bs=_jbs(bs)).batch([_jframe(f) for f in frames])
    assert len(outs) == 3
    for o, r in zip(outs, refs):
        _same(o, r)


def test_batch_equals_single_calls_and_luma_only(rng):
    w, h = 40, 24
    frames = [_frame(rng, w, h) for _ in range(4)]
    pipe = DeblockPipeline(w, h, 35, device="cpu")
    for o, f in zip(pipe.batch(frames), frames):
        _same(o, pipe(f))
    lo = DeblockPipeline(w, h, 35, luma_only=True, device="cpu")
    jlo = JaxPipeline(w, h, 35, luma_only=True, backend="jnp").batch([_jframe(f) for f in frames])
    for o, r, f in zip(lo.batch(frames), jlo, frames):
        _same(o, r)
        assert np.array_equal(o.u, f.u) and o.u is not f.u


def test_batch_empty_and_host_backends(rng):
    assert DeblockPipeline(64, 48, 35, device="cpu").batch([]) == []
    assert JaxPipeline(64, 48, 35).batch([]) == []
    for backend in ("golden", "native"):
        with pytest.raises(ValueError, match="device backend"):
            DeblockPipeline(64, 48, 35, backend=backend).batch([_frame(rng, 64, 48)])
        with pytest.raises(ValueError):
            JaxPipeline(64, 48, 35, backend=backend if backend != "native" else "golden").batch([])


def test_errors(rng):
    pipe = DeblockPipeline(64, 48, 35, device="cpu")
    with pytest.raises(ValueError, match="frame geometry mismatch"):
        pipe(_frame(rng, 48, 40))
    with pytest.raises(ValueError, match="frame geometry mismatch in batch"):
        pipe.batch([_frame(rng, 64, 48), _frame(rng, 48, 40)])
    with pytest.raises(ValueError, match="BoundaryStrength geometry mismatch"):
        pipe.set_boundary_strength(BoundaryStrength.intra_default(48, 40))
    with pytest.raises(ValueError, match="BoundaryStrength geometry mismatch"):
        DeblockPipeline(64, 48, 35, bs=BoundaryStrength.intra_default(48, 40), device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        DeblockPipeline(64, 48, 35, backend="pallas", device="cpu")(_frame(rng, 64, 48))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        DeblockPipeline(64, 48, 35, device="meta")
    with pytest.raises(ValueError):
        BoundaryStrength.intra_default(64, 48).set_luma(np.zeros(3, np.uint8),
                                                        np.zeros(3, np.uint8))
