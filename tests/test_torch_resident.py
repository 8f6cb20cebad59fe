"""The PyTorch port's device-resident path (models/resident.py) on a CPU
device, against the JAX package's ResidentDeblocker (Pallas in interpret
mode) and the golden oracle, byte for byte.  One regular and one Q9-sheared
geometry (w % 16 == 8), as in tests/test_resident.py's default suite: each
JAX geometry costs an interpret-mode compile."""

import numpy as np
import pytest
import torch

import gpu_video_codec_tpu.models.resident as jres
from gpu_video_codec_tpu.models.golden import deblock_frame_golden
from gpu_video_codec_tpu.utils.bs import BoundaryStrength as JaxBoundaryStrength
from gpu_video_codec_tpu_torch.models import ResidentDeblocker
from gpu_video_codec_tpu_torch.models.resident import StepOperands, TileFrame
from gpu_video_codec_tpu_torch.utils.bs import BoundaryStrength
from gpu_video_codec_tpu_torch.utils.yuv import planes_from_yv12_bytes, yv12_bytes_from_planes

GEOMS = [(64, 48), (40, 24)]
CPU = torch.device("cpu")


def _raw(rng, w, h):
    return rng.integers(0, 256, 3 * w * h // 2, dtype=np.uint8)


def _golden_packed(raw, w, h, qp, bs=None, passes=1, luma_only=False):
    """`passes` golden passes over the EXTENDED planes (what chained
    resident steps compute: state keeps the padding pixels border tiles
    wrote), then the interior."""
    frame = planes_from_yv12_bytes(raw.tobytes(), w, h)
    bs = bs or BoundaryStrength.intra_default(w, h)
    for _ in range(passes):
        frame = deblock_frame_golden(frame, bs, qp, luma_only=luma_only)
    return np.frombuffer(yv12_bytes_from_planes(frame), np.uint8)


def _random_bs(rng, w, h):
    bs = BoundaryStrength.intra_default(w, h)
    bs.set_luma(rng.integers(0, 3, bs.vert.size, dtype=np.uint8),
                rng.integers(0, 3, bs.hor.size, dtype=np.uint8))
    bs.set_chroma(rng.integers(0, 3, bs.chroma_vert.size, dtype=np.uint8),
                  rng.integers(0, 3, bs.chroma_hor.size, dtype=np.uint8))
    return bs


def _jax_bs(bs):
    jbs = JaxBoundaryStrength.intra_default(bs.width, bs.height)
    jbs.set_luma(bs.vert, bs.hor)
    jbs.set_chroma(bs.chroma_vert, bs.chroma_hor)
    return jbs


def _assert_state_matches_jax(tf, jtf):
    """The port's exact grid == the JAX state's covered region (the JAX
    grid is padded to Pallas block multiples with no-op tiles)."""
    by, bx = tf.y.shape[-2:]
    assert np.array_equal(tf.y.numpy(), np.asarray(jtf.y)[..., :by, :bx])
    cby2, cbx = tf.uv.shape[-2:]
    assert np.array_equal(tf.uv.numpy(), np.asarray(jtf.uv)[..., :cby2, :cbx])
    assert np.array_equal(tf.u_rem.numpy(), np.asarray(jtf.u_rem))
    assert np.array_equal(tf.v_rem.numpy(), np.asarray(jtf.v_rem))


@pytest.mark.parametrize("w,h", GEOMS)
def test_resident_matches_jax_and_golden(rng, w, h):
    """ingest, step and readback agree with the JAX resident path at every
    boundary, and the frame with golden."""
    raw = _raw(rng, w, h)
    rd = ResidentDeblocker(w, h, 35, device=CPU)
    jrd = jres.ResidentDeblocker(w, h, 35)
    tf, jtf = rd.ingest(raw), jrd.ingest(raw)
    assert isinstance(tf, TileFrame) and tf.y.dtype == torch.uint8
    _assert_state_matches_jax(tf, jtf)
    tf, jtf = rd.step(tf), jrd.step(jtf)
    _assert_state_matches_jax(tf, jtf)
    out = rd.readback(tf)
    assert np.array_equal(out, jrd.readback(jtf))
    assert np.array_equal(out, _golden_packed(raw, w, h, 35))
    assert not np.array_equal(out, raw)
    assert np.array_equal(rd(raw), out)


@pytest.mark.parametrize("w,h", GEOMS)
def test_resident_chained_steps(rng, w, h):
    """N chained kernel-only steps on resident state == N golden passes over
    the extended planes (not N YV12 round trips: re-ingesting re-zeroes the
    Q6 padding) == N chained JAX steps."""
    raw = _raw(rng, w, h)
    rd = ResidentDeblocker(w, h, 35, device=CPU)
    jrd = jres.ResidentDeblocker(w, h, 35)
    tf, jtf = rd.ingest(raw), jrd.ingest(raw)
    for _ in range(3):
        tf, jtf = rd.step(tf), jrd.step(jtf)
    _assert_state_matches_jax(tf, jtf)
    assert np.array_equal(rd.readback(tf), _golden_packed(raw, w, h, 35, passes=3))


def test_resident_run_steps_matches_step_loop(rng):
    w, h = 64, 48
    rd = ResidentDeblocker(w, h, 35, device=CPU)
    state = rd.ingest(_raw(rng, w, h))
    looped = state
    for _ in range(3):
        looped = rd.step(looped)
    chained = rd.run_steps(state, 3)
    for a, b in zip(chained, looped):
        assert torch.equal(a, b)
    assert rd.run_steps(state, 0) is state


@pytest.mark.parametrize("w,h", [(64, 48), (88, 72)], ids=["64x48", "sheared-88x72"])
def test_resident_run_steps_matches_jax(rng, w, h):
    """run_steps(tf, 3) == the JAX run_steps (one dispatch of three steps) at
    every boundary, byte for byte, and leaves the input state as it was."""
    raw = _raw(rng, w, h)
    rd = ResidentDeblocker(w, h, 35, device=CPU)
    jrd = jres.ResidentDeblocker(w, h, 35)
    tf, jtf = rd.ingest(raw), jrd.ingest(raw)
    keep = [t.clone() for t in tf]
    out, jout = rd.run_steps(tf, 3), jrd.run_steps(jtf, 3)
    _assert_state_matches_jax(out, jout)
    assert all(torch.equal(t, k) for t, k in zip(tf, keep))
    assert np.array_equal(rd.readback(out), jrd.readback(jout))
    assert np.array_equal(rd.readback(out), _golden_packed(raw, w, h, 35, passes=3))


@pytest.mark.parametrize("w,h", GEOMS)
def test_resident_luma_only(rng, w, h):
    raw = _raw(rng, w, h)
    rd = ResidentDeblocker(w, h, 35, luma_only=True, device=CPU)
    assert rd.luma_only is True
    out = rd(raw)
    assert np.array_equal(out, _golden_packed(raw, w, h, 35, luma_only=True))
    assert np.array_equal(out[w * h:], raw[w * h:])  # chroma untouched


@pytest.mark.parametrize("w,h", GEOMS)
def test_resident_injected_bs(rng, w, h):
    """Custom BS arrays flow through the segment maps unchanged, as in the
    JAX resident path."""
    raw = _raw(rng, w, h)
    bs = _random_bs(rng, w, h)
    out = ResidentDeblocker(w, h, 35, bs=bs, device=CPU)(raw)
    assert np.array_equal(out, _golden_packed(raw, w, h, 35, bs=bs))
    assert np.array_equal(out, jres.ResidentDeblocker(w, h, 35, bs=_jax_bs(bs))(raw))


def test_resident_update_boundary_strength(rng):
    """update_boundary_strength swaps BS between frames and matches a fresh
    instance built with the same BS (SetBoundaryStrenght parity)."""
    w, h, qp = 64, 48, 35
    raw = _raw(rng, w, h)
    bs = _random_bs(rng, w, h)
    rd = ResidentDeblocker(w, h, qp, device=CPU)
    assert np.array_equal(rd(raw), _golden_packed(raw, w, h, qp))
    rd.update_boundary_strength(bs)
    assert np.array_equal(rd(raw), _golden_packed(raw, w, h, qp, bs=bs))
    with pytest.raises(ValueError, match="geometry"):
        rd.update_boundary_strength(BoundaryStrength.intra_default(w, h + 8))


@pytest.mark.parametrize("w,h", GEOMS)
def test_resident_batched_frames(rng, w, h):
    """A frame batch runs through every kernel as one launch with one
    shared BS map and equals per-frame golden and the JAX batch."""
    raws = [_raw(rng, w, h) for _ in range(3)]
    rd = ResidentDeblocker(w, h, 35, device=CPU)
    tf = rd.ingest(raws)
    assert tf.y.shape[0] == 3 and tf.y.dim() == 5
    out = rd.readback(rd.step(tf))
    assert out.shape == (3, 3 * w * h // 2)
    for i, raw in enumerate(raws):
        assert np.array_equal(out[i], _golden_packed(raw, w, h, 35)), i
    assert np.array_equal(out, jres.ResidentDeblocker(w, h, 35)(raws))


def test_resident_batched_array_input(rng):
    """(n, 3wh/2) ndarray input batches identically to a list of frames,
    and a batch of one keeps its batch axis."""
    w, h = 64, 48
    raws = np.stack([_raw(rng, w, h) for _ in range(2)])
    rd = ResidentDeblocker(w, h, 35, device=CPU)
    assert np.array_equal(rd(raws), rd(list(raws)))
    one = rd(raws[:1])
    assert one.shape == (1, 3 * w * h // 2) and np.array_equal(one[0], rd(raws[0]))


def test_resident_batched_chained_steps(rng):
    """Chained steps on a batched TileFrame == chained steps per frame."""
    w, h = 40, 24
    raws = [_raw(rng, w, h) for _ in range(2)]
    rd = ResidentDeblocker(w, h, 35, device=CPU)
    batched = rd.readback(rd.run_steps(rd.ingest(raws), 2))
    for i, raw in enumerate(raws):
        assert np.array_equal(batched[i], rd.readback(rd.run_steps(rd.ingest(raw), 2))), i


def test_resident_ingest_device_tensor(rng):
    """ingest() takes a packed tensor already on the deblocker's device,
    flat, as rows, or as a batch, and rejects other dtypes and devices."""
    w, h = 64, 48
    raw = _raw(rng, w, h)
    rd = ResidentDeblocker(w, h, 35, device=CPU)
    ref = rd(raw)
    dev = torch.from_numpy(raw.copy())
    assert np.array_equal(rd.readback(rd.step(rd.ingest(dev))), ref)
    assert np.array_equal(rd.readback(rd.step(rd.ingest(dev.reshape(3 * h // 2, w)))), ref)
    both = rd.readback(rd.step(rd.ingest(torch.stack([dev, dev]))))
    assert both.shape == (2, raw.size) and np.array_equal(both[1], ref)
    with pytest.raises(ValueError, match="uint8"):
        rd.ingest(dev.to(torch.int32))
    with pytest.raises(ValueError):
        rd.ingest(dev.to("meta"))


def test_resident_rejects_bad_size():
    rd = ResidentDeblocker(64, 48, 35, device=CPU)
    with pytest.raises(ValueError):
        rd.ingest(np.zeros(10, np.uint8))
    with pytest.raises(ValueError):
        rd.ingest(torch.zeros(10, dtype=torch.uint8))


def _host_buf_shapes(w, h):
    fb = 3 * w * h // 2
    return [(fb,), (3 * h // 2, w), (1, 3 * h // 2, w), (2, 3 * h // 2, w), (3, fb),
            (2, fb // 2, 2), (2 * 3 * h // 2, w), (fb, 2), (10,), (2, fb + 1), (fb * 2,)]


@pytest.mark.parametrize("i", range(11))
def test_resident_host_buf_matches_jax(rng, i):
    """host_buf accepts and rejects the shapes the JAX host_buf does, with
    the same normalized shape; batches of one keep their batch axis and a
    transposed (frame_bytes, n) array is refused."""
    w, h = 64, 48
    shape = _host_buf_shapes(w, h)[i]
    arr = rng.integers(0, 256, shape, dtype=np.uint8)
    rd = ResidentDeblocker(w, h, 35, device=CPU)
    jrd = jres.ResidentDeblocker(w, h, 35)
    try:
        want = jrd.host_buf(arr)
    except ValueError:
        with pytest.raises(ValueError, match="batch"):
            rd.host_buf(arr)
        return
    got = rd.host_buf(arr)
    assert got.shape == want.shape and np.array_equal(got, want)


def test_resident_operands_contract(rng):
    """operands -> install_operands keeps the pipeline byte-identical, and
    block_shapes/luma_only expose the step's settings."""
    w, h = 64, 48
    rd = ResidentDeblocker(w, h, 35, device=CPU)
    raw = _raw(rng, w, h)
    ref = rd(raw)
    ops = rd.operands
    assert isinstance(ops, StepOperands) and len(ops.lm) == 4 and len(ops.cm) == 4
    assert ops.lm[0].shape == (7, 9)  # (48 + 8) / 8 by (64 + 8) / 8 tiles
    assert ops.cm[0].shape == (8, 5)  # U over V: 2 x (24 + 8) / 8 by (32 + 8) / 8
    rd.install_operands(StepOperands(tuple(m.clone() for m in ops.lm),
                                     tuple(m.clone() for m in ops.cm), ops.beta, ops.tc))
    assert np.array_equal(rd(raw), ref)
    lb, cb = rd.block_shapes
    assert lb > 0 and cb > 0
    assert rd.luma_only is False


def test_resident_torch_backend_matches_cuda_backend(rng):
    """The plain backend (what the card compares against) gives the same
    bytes; on a CPU device both run the plain versions."""
    w, h = 40, 24
    raws = np.stack([_raw(rng, w, h) for _ in range(2)])
    a = ResidentDeblocker(w, h, 30, device=CPU)
    b = ResidentDeblocker(w, h, 30, backend="torch", device=CPU)
    assert np.array_equal(a.readback(a.run_steps(a.ingest(raws), 2)),
                          b.readback(b.run_steps(b.ingest(raws), 2)))


def test_resident_constructor_and_timing_checks():
    with pytest.raises(ValueError, match="backend"):
        ResidentDeblocker(64, 48, 35, backend="pallas", device=CPU)
    with pytest.raises(ValueError):
        ResidentDeblocker(60, 48, 35, device=CPU)
    with pytest.raises(ValueError, match="device"):
        ResidentDeblocker(64, 48, 35, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ResidentDeblocker(64, 48, 35)  # the default device is cuda; nothing falls back
    with pytest.raises(RuntimeError, match="CUDA device"):
        ResidentDeblocker(64, 48, 35, device=CPU).step_time(np.zeros(4608, np.uint8))
