"""StreamingDeblocker of the PyTorch port on a CPU device (the "cuda"
backend's wrapper runs its plain version there) against the JAX
StreamingDeblocker (jnp backend) and the golden oracle: the cases of
tests/test_streaming.py, byte for byte."""

import numpy as np
import pytest
import torch

from gpu_video_codec_tpu.models.streaming import StreamingDeblocker as JaxStreaming
from gpu_video_codec_tpu.utils.bs import BoundaryStrength as JaxBS
from gpu_video_codec_tpu_torch.models.golden import deblock_frame_golden
from gpu_video_codec_tpu_torch.models.streaming import (
    StreamingDeblocker, _deblock_yv12_packed_impl, _pack_out,
)
from gpu_video_codec_tpu_torch.utils.bs import BoundaryStrength
from gpu_video_codec_tpu_torch.utils.yuv import (
    FramePlanes, extend_plane, interior, planes_from_yv12_bytes, yv12_bytes_from_planes,
)

BACKENDS = ["cuda", "torch"]


def _raw_frame(rng, w, h):
    return rng.integers(0, 256, 3 * w * h // 2, dtype=np.uint8)


def _golden(raw, w, h, qp, bs=None, luma_only=False):
    bs = bs or BoundaryStrength.intra_default(w, h)
    gold = deblock_frame_golden(planes_from_yv12_bytes(raw, w, h), bs, qp, luma_only=luma_only)
    return np.frombuffer(yv12_bytes_from_planes(gold), np.uint8)


def _sd(w, h, qp=35, **kw):
    return StreamingDeblocker(w, h, qp, device="cpu", **kw)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_stream_order_and_exactness(rng, depth):
    w, h, qp = 64, 48, 35
    raws = [_raw_frame(rng, w, h) for _ in range(6)]
    outs = list(_sd(w, h, qp, depth=depth).run(raws))
    ref = list(JaxStreaming(w, h, qp, backend="jnp", depth=depth).run(raws))
    assert len(outs) == len(raws)
    for raw, out, r in zip(raws, outs, ref):
        assert out.dtype == np.uint8 and out.shape == raw.shape
        assert np.array_equal(out, _golden(raw, w, h, qp))
        assert np.array_equal(out, r)
    # no two yielded frames share memory
    assert not any(np.shares_memory(a, b) for i, a in enumerate(outs) for b in outs[i + 1:])


@pytest.mark.parametrize("backend", BACKENDS)
def test_stream_luma_only(rng, backend):
    w, h = 64, 48
    raw = _raw_frame(rng, w, h)
    (out,) = list(_sd(w, h, backend=backend, luma_only=True).run([raw]))
    assert np.array_equal(out[w * h :], raw[w * h :])  # chroma untouched
    assert not np.array_equal(out[: w * h], raw[: w * h])
    assert np.array_equal(out, _golden(raw, w, h, 35, luma_only=True))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("w,h", [(64, 72), (88, 72)], ids=["h16-8", "sheared-w16-8"])
def test_stream_odd_chroma_geometry(rng, backend, w, h):
    """64x72: chroma height % 8 == 4, like 1080p (non-sheared);
    88x72: extended chroma width not 8-aligned (Q9 sheared)."""
    qp = 35
    raw = _raw_frame(rng, w, h)
    (out,) = list(_sd(w, h, qp, backend=backend).run([raw]))
    (ref,) = list(JaxStreaming(w, h, qp, backend="jnp").run([raw]))
    assert np.array_equal(out, ref)
    assert np.array_equal(out, _golden(raw, w, h, qp))


def test_stream_rejects_wrong_size():
    s = _sd(64, 48)
    with pytest.raises(ValueError):
        next(s.run([np.zeros(10, np.uint8)]))


def test_streaming_rejects_bad_args():
    with pytest.raises(ValueError):
        _sd(100, 50)
    with pytest.raises(ValueError):
        _sd(64, 48, backend="pallas")
    with pytest.raises(ValueError):
        StreamingDeblocker(64, 48, 35, device="meta")


def test_default_device_needs_cuda():
    """backend="cuda" on the default device never falls back to the CPU."""
    if torch.cuda.is_available():
        assert StreamingDeblocker(64, 48, 35).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingDeblocker(64, 48, 35)


def test_measurement_needs_cuda(rng):
    s = _sd(64, 48)
    raw = bytes(_raw_frame(rng, 64, 48))
    with pytest.raises(RuntimeError, match="CUDA"):
        s.time_breakdown(raw, n=2)


def test_update_boundary_strength_midstream(rng):
    w, h, qp = 64, 48, 35
    raw = _raw_frame(rng, w, h)
    s = _sd(w, h, qp)
    (filtered,) = list(s.run([raw]))
    assert not np.array_equal(filtered, raw)
    # all-zero BS -> no-op
    bs0 = BoundaryStrength.intra_default(w, h)
    bs0.set_luma(np.zeros(bs0.vert.size, np.uint8), np.zeros(bs0.hor.size, np.uint8))
    bs0.set_chroma(np.zeros(bs0.chroma_vert.size, np.uint8),
                   np.zeros(bs0.chroma_hor.size, np.uint8))
    s.update_boundary_strength(bs0)
    (out0,) = list(s.run([raw]))
    assert np.array_equal(out0, raw)
    with pytest.raises(ValueError):
        s.update_boundary_strength(BoundaryStrength.intra_default(32, 32))


@pytest.mark.parametrize("backend", BACKENDS)
def test_random_bs_matches_jax(rng, backend):
    """The same numpy BS arrays reach both packages through from_arrays."""
    w, h, qp = 64, 72, 40
    jbs = JaxBS.intra_default(w, h)
    jbs.set_luma(rng.integers(0, 3, jbs.vert.size, dtype=np.uint8),
                 rng.integers(0, 3, jbs.hor.size, dtype=np.uint8))
    jbs.set_chroma(rng.integers(0, 3, jbs.chroma_vert.size, dtype=np.uint8),
                   rng.integers(0, 3, jbs.chroma_hor.size, dtype=np.uint8))
    bs = BoundaryStrength.from_arrays(jbs)
    raws = [_raw_frame(rng, w, h) for _ in range(2)]
    s = _sd(w, h, qp, backend=backend)
    s.update_boundary_strength(bs)
    outs = list(s.run(raws))
    ref = list(JaxStreaming(w, h, qp, backend="jnp", bs=jbs).run(raws))
    for raw, o, r in zip(raws, outs, ref):
        assert np.array_equal(o, r)
        assert np.array_equal(o, _golden(raw, w, h, qp, bs=bs))


def test_run_frames_wrapper(rng):
    w, h = 64, 48
    frames = [
        FramePlanes(
            extend_plane(rng.integers(0, 256, (h, w), dtype=np.uint8)),
            extend_plane(rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)),
            extend_plane(rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)),
            w, h,
        )
        for _ in range(2)
    ]
    outs = list(_sd(w, h).run_frames(frames))
    bs = BoundaryStrength.intra_default(w, h)
    for f, o in zip(frames, outs):
        gold = deblock_frame_golden(f, bs, 35)
        for name in ("y", "u", "v"):
            ga, oa = getattr(gold, name), getattr(o, name)
            hh, ww = ga.shape[0] - 8, ga.shape[1] - 8
            assert np.array_equal(interior(ga, hh, ww), interior(oa, hh, ww)), name


def test_step_in_place_and_borrow(rng):
    w, h = 64, 72
    raw = _raw_frame(rng, w, h)
    s = _sd(w, h)
    buf = s._put(raw)
    keep = buf.clone()
    out_b = s._step_borrow(buf)
    assert torch.equal(buf, keep)  # the borrow form leaves its input intact
    out = s._step(buf)
    assert out is buf  # in place into the buffer the step was handed
    assert torch.equal(out, out_b)
    assert np.array_equal(out.numpy().ravel(), _golden(raw, w, h, 35))


@pytest.mark.parametrize("w,h", [(64, 48), (88, 72)], ids=["64x48", "sheared-88x72"])
def test_chain_matches_jax_chain(rng, w, h):
    """_chain(buf, 3) == the JAX _chain (three steps in one dispatch) and
    three golden passes, byte for byte; the port's works in place."""
    raw = _raw_frame(rng, w, h)
    s = _sd(w, h)
    buf = s._put(raw)
    assert s._chain(buf, 3) is buf
    js = JaxStreaming(w, h, 35, backend="jnp")
    ref = np.asarray(js._chain(js._put(raw), 3)).ravel()
    assert np.array_equal(buf.numpy().ravel(), ref)
    want = raw
    for _ in range(3):
        want = _golden(want, w, h, 35)
    assert np.array_equal(ref, want)


def test_pack_out_semantics():
    buf = torch.zeros((6, 4), dtype=torch.uint8)
    parts = [(0, torch.ones((2, 4), dtype=torch.uint8)),
             (4, torch.full((1, 4), 7, dtype=torch.uint8))]
    fresh = _pack_out(buf, parts, inplace=False)
    assert int(buf.sum()) == 0 and fresh.data_ptr() != buf.data_ptr()
    same = _pack_out(buf, parts, inplace=True)
    assert same is buf and torch.equal(buf, fresh)
    assert buf[:, 0].tolist() == [1, 1, 0, 0, 7, 0]


class TestPlanesContract:
    """step_planes/put_planes must equal the packed YV12 path."""

    @pytest.mark.parametrize("backend", BACKENDS)
    @pytest.mark.parametrize("w,h", [(64, 48), (88, 72)])
    def test_matches_golden_and_packed(self, rng, backend, w, h):
        qp = 35
        raw = _raw_frame(rng, w, h)
        s = _sd(w, h, qp, backend=backend)
        y, uv = s.step_planes(*s.put_planes(raw))
        packed = _golden(raw, w, h, qp)
        assert np.array_equal(y.numpy().ravel(), packed[: w * h])
        assert np.array_equal(uv.numpy().ravel(), packed[w * h :])

    def test_luma_only_passthrough(self, rng):
        w, h = 64, 48
        raw = _raw_frame(rng, w, h)
        s = _sd(w, h, luma_only=True)
        y, uv = s.step_planes(*s.put_planes(raw))
        assert np.array_equal(uv.numpy().ravel(), raw[w * h :])
        assert not np.array_equal(y.numpy().ravel(), raw[: w * h])

    def test_chained_steps_match_packed_chain(self, rng):
        w, h = 64, 48
        raw = _raw_frame(rng, w, h)
        s = _sd(w, h)
        y, uv = s.put_planes(raw)
        for _ in range(3):
            y, uv = s.step_planes(y, uv)
        buf = s._put(raw)
        for _ in range(3):
            buf = s._step(buf)
        ref = buf.numpy().ravel()
        assert np.array_equal(y.numpy().ravel(), ref[: w * h])
        assert np.array_equal(uv.numpy().ravel(), ref[w * h :])


def test_packed_impl_backends_agree(rng):
    """The kernel path and the plain path of the packed step, sheared and
    not, luma_only or not."""
    for w, h in ((64, 72), (88, 72), (56, 48)):
        raw = _raw_frame(rng, w, h)
        s = _sd(w, h, 45)
        buf = torch.from_numpy(raw.reshape(3 * h // 2, w))
        for luma_only in (False, True):
            a, b = (_deblock_yv12_packed_impl(buf, s._lm, s._cm, s._beta, s._tc, w, h,
                                              luma_only, backend) for backend in BACKENDS)
            assert torch.equal(a, b), (w, h, luma_only)


@pytest.mark.parametrize("luma_only", [False, True], ids=["full", "luma_only"])
@pytest.mark.parametrize("w,h", [(64, 48), (40, 24), (360, 288)],
                         ids=["64x48", "sheared-40x24", "sheared-360x288"])
def test_cuda_backend_goes_through_t2_t3(rng, monkeypatch, w, h, luma_only):
    """The cuda backend's packed and planes steps call K2
    (deblock_packed_cuda) once where its guard takes the geometry (64x48),
    and elsewhere (the sheared widths) T2 and T3 (plane_to_tiles_cuda,
    tiles_to_plane_cuda, as ops/chain.KERNELS holds them) -- once each for
    luma, once more for U+V -- and never the plain relayout
    (interior_to_tiles, tiles_to_interior) or the extended planes' frame
    path (deblock_frame_cuda), in place or not; the bytes equal the JAX
    StreamingDeblocker's and golden."""
    import gpu_video_codec_tpu_torch.models.streaming as st
    import gpu_video_codec_tpu_torch.ops.chain as chain
    import gpu_video_codec_tpu_torch.ops.cuda_kernel as ck
    import gpu_video_codec_tpu_torch.utils.tiles as tl

    calls = {"T2": 0, "T3": 0, "K2": 0}

    def spy(name, fn):
        def counted(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return counted

    def banned(*args, **kwargs):
        raise AssertionError("the cuda backend took the plain relayout")

    t2, t3, t4, k1 = chain.KERNELS["cuda"]
    monkeypatch.setitem(chain.KERNELS, "cuda", (spy("T2", t2), spy("T3", t3), t4, k1))
    monkeypatch.setattr(st, "deblock_packed_cuda", spy("K2", st.deblock_packed_cuda))
    for mod, name in ((tl, "interior_to_tiles"), (tl, "tiles_to_interior"),
                      (chain, "deblock_frame_cuda"), (st, "interior_to_tiles"),
                      (st, "tiles_to_interior"), (st, "deblock_frame_cuda")):
        monkeypatch.setattr(mod, name, banned, raising=False)
    raw = _raw_frame(rng, w, h)
    want = _golden(raw, w, h, 35, luma_only=luma_only)
    (ref,) = list(JaxStreaming(w, h, 35, backend="jnp", luma_only=luma_only).run([raw]))
    assert np.array_equal(want, ref)
    s = _sd(w, h, luma_only=luma_only)
    for inplace in (False, True):
        buf = torch.from_numpy(raw.reshape(3 * h // 2, w).copy())
        out = s._packed(buf, inplace)
        assert (out is buf) == inplace
        if not inplace:
            assert np.array_equal(buf.numpy().ravel(), raw)  # the input stays as it was
        assert np.array_equal(out.numpy().ravel(), want)
    y, uv = s.step_planes(*s.put_planes(raw))
    assert np.array_equal(np.concatenate([y.numpy().ravel(), uv.numpy().ravel()]), want)
    if ck.packed_fits(w):  # the geometry K2 takes; the buffers here are fresh, so aligned
        assert calls == {"T2": 0, "T3": 0, "K2": 3}
    else:
        per_step = 1 if luma_only else 2
        assert calls == {"T2": 3 * per_step, "T3": 3 * per_step, "K2": 0}
