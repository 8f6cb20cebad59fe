"""The port's device-mesh layer (gpu_video_codec_tpu_torch/parallel) on a
mesh of repeated "cpu" slots, against the JAX package's parallel/ on its
eight forced host devices (tests/conftest.py) and the golden oracle, byte
for byte: make_mesh / default_mesh_shape, deblock_batch_sharded (frames
over "data", tile-row slabs over "spatial"), the packed batch step,
MultiStreamDeblocker and MeshResidentDeblocker, at 64x48 and at the
Q9-sheared 56x72 (w % 16 == 8).

The JAX package is imported inside the tests that use it, so the `cuda`
cases (two slots on one card, graphs keyed by slot) also run where JAX is
not installed: `python -m pytest tests/test_torch_parallel.py -m cuda`."""

import numpy as np
import pytest
import torch

from gpu_video_codec_tpu_torch.models.golden import deblock_frame_golden
from gpu_video_codec_tpu_torch.models.resident import ResidentDeblocker
from gpu_video_codec_tpu_torch.models.streaming import StreamingDeblocker
from gpu_video_codec_tpu_torch.ops import cuda_kernel as ck
from gpu_video_codec_tpu_torch.ops import relayout_kernel as rk
from gpu_video_codec_tpu_torch.ops.tables import get_beta, get_tc
from gpu_video_codec_tpu_torch.parallel import (
    MeshResidentDeblocker, MultiStreamDeblocker, default_mesh_shape, deblock_batch_sharded,
    deblock_batch_sharded_jit, make_mesh,
)
from gpu_video_codec_tpu_torch.parallel import mesh as pmesh
from gpu_video_codec_tpu_torch.utils.bs import (
    BoundaryStrength, chroma_segment_maps, luma_segment_maps,
)
from gpu_video_codec_tpu_torch.utils.yuv import (
    FramePlanes, extend_plane, planes_from_yv12_bytes, yv12_bytes_from_planes,
)

GEOMS = [(64, 48), (56, 72)]  # 56x72: sheared chroma (Q9)
GEOM_IDS = ["64x48", "56x72-sheared"]
QP = 35


def cpu_mesh(n_data: int, n_spatial: int):
    return make_mesh(n_data, n_spatial, ["cpu"] * (n_data * n_spatial))


def jax_mesh(n_data: int, n_spatial: int):
    from gpu_video_codec_tpu.parallel import make_mesh as jax_make_mesh

    return jax_make_mesh(n_data, n_spatial)


def jax_bs(bs):
    from gpu_video_codec_tpu.utils.bs import BoundaryStrength as JaxBoundaryStrength

    return JaxBoundaryStrength(bs.width, bs.height, bs.vert, bs.hor, bs.chroma_vert,
                               bs.chroma_hor)


def _raw(rng, w, h):
    return rng.integers(0, 256, 3 * w * h // 2, dtype=np.uint8)


def _smooth(rng, w, h):
    """Frames whose vertical edges really filter (cond1 passes), so a BS
    change shows in the bytes."""
    return (np.arange(3 * w * h // 2, dtype=np.int64) // w % 256
            + rng.integers(-3, 4, 3 * w * h // 2)).astype(np.uint8)


def _gold(raw, w, h, bs=None, luma_only=False, passes=1):
    """`passes` golden passes over the extended planes, packed."""
    frame = planes_from_yv12_bytes(bytes(raw), w, h)
    bs = bs or BoundaryStrength.intra_default(w, h)
    for _ in range(passes):
        frame = deblock_frame_golden(frame, bs, QP, luma_only=luma_only)
    return np.frombuffer(yv12_bytes_from_planes(frame), np.uint8)


def _ext_batch(rng, n, w, h):
    def planes(hh, ww):
        return np.stack([extend_plane(rng.integers(0, 256, (hh, ww), dtype=np.uint8))
                         for _ in range(n)])
    return planes(h, w), planes(h // 2, w // 2), planes(h // 2, w // 2)


# -- make_mesh / default_mesh_shape ------------------------------------------------

@pytest.mark.parametrize("n", range(1, 17))
def test_default_mesh_shape_matches_jax(n):
    from gpu_video_codec_tpu.parallel.mesh import default_mesh_shape as jax_shape

    assert default_mesh_shape(n) == jax_shape(n)
    d, s = default_mesh_shape(n)
    assert d * s == max(n, 1)


def test_make_mesh_shape_and_errors():
    from gpu_video_codec_tpu.parallel import make_mesh as jax_make_mesh

    mesh = cpu_mesh(2, 4)
    assert mesh.shape == {"data": 2, "spatial": 4} and mesh.size == 8
    assert mesh.devices.shape == (2, 4)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert make_mesh(1, 3, ["cpu"] * 5).size == 3  # the first n_data * n_spatial
    with pytest.raises(ValueError) as mine:
        make_mesh(2, 8, ["cpu"] * 8)
    with pytest.raises(ValueError) as ref:
        jax_make_mesh(2, 8)
    assert str(mine.value) == str(ref.value) == "need 16 devices, have 8"
    with pytest.raises(ValueError, match="axes"):
        make_mesh(0, 1, ["cpu"])
    with pytest.raises(ValueError, match="CUDA or CPU"):
        make_mesh(1, 1, ["meta"])


def test_make_mesh_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(1, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(1, 1, ["cuda"])


@pytest.mark.parametrize("n,slots,want", [
    (8, 8, [(i, i + 1) for i in range(8)]),
    (3, 2, [(0, 2), (2, 3)]),
    (5, 4, [(0, 2), (2, 4), (4, 5), (5, 5)]),
    (2, 4, [(0, 1), (1, 2), (2, 2), (2, 2)]),
    (4, 1, [(0, 4)]),
])
def test_packed_batch_sharding(n, slots, want):
    assert pmesh.packed_batch_sharding(cpu_mesh(1, slots), n) == want


# -- deblock_batch_sharded: extended planes, slabs ----------------------------------

@pytest.mark.parametrize("luma_only", [False, True], ids=["full", "luma_only"])
@pytest.mark.parametrize("mesh_shape", [(2, 4), (1, 3), (4, 2)], ids=str)
@pytest.mark.parametrize("w,h", GEOMS, ids=GEOM_IDS)
def test_batch_sharded_matches_jax_and_golden(rng, w, h, mesh_shape, luma_only):
    """Uneven slabs (luma By 7 and 10, chroma 5 and 6 over 3 or 4 slots),
    the cuda backend (plain versions on the CPU), the plain backend and the
    _jit wrapper, all == the JAX package's deblock_batch_sharded_jit == golden."""
    import jax.numpy as jnp

    from gpu_video_codec_tpu.parallel.mesh import deblock_batch_sharded_jit as jax_sharded

    n = 4
    ys, us, vs = _ext_batch(rng, n, w, h)
    bs = BoundaryStrength.intra_default(w, h)
    lm, cm = luma_segment_maps(bs), chroma_segment_maps(bs)
    beta, tc = get_beta(QP), get_tc(QP)
    ref = jax_sharded(jax_mesh(*mesh_shape), jnp.asarray(ys), jnp.asarray(us), jnp.asarray(vs),
                      lm, cm, beta, tc, luma_only=luma_only)
    ref = [np.asarray(r) for r in ref]
    for i in range(n):
        gold = deblock_frame_golden(FramePlanes(ys[i], us[i], vs[i], w, h), bs, QP,
                                    luma_only=luma_only)
        assert all(np.array_equal(r[i], getattr(gold, k)) for r, k in zip(ref, "yuv")), i
    mesh = cpu_mesh(*mesh_shape)
    for fn, backend in ((deblock_batch_sharded, "cuda"), (deblock_batch_sharded, "torch"),
                        (deblock_batch_sharded_jit, "cuda")):
        planes = [torch.from_numpy(a.copy()) for a in (ys, us, vs)]
        out = fn(mesh, *planes, lm, cm, beta, tc, luma_only=luma_only, backend=backend)
        assert all(o is p for o, p in zip(out, planes))  # in place
        for o, r in zip(out, ref):
            assert np.array_equal(o.numpy(), r), (fn.__name__, backend)


def test_batch_sharded_errors(rng):
    ys, us, vs = _ext_batch(rng, 3, 64, 48)
    bs = BoundaryStrength.intra_default(64, 48)
    lm, cm = luma_segment_maps(bs), chroma_segment_maps(bs)
    planes = [torch.from_numpy(a) for a in (ys, us, vs)]
    with pytest.raises(ValueError, match="not divisible by data axis 2"):
        deblock_batch_sharded(cpu_mesh(2, 4), *planes, lm, cm, 32, 4)
    with pytest.raises(ValueError, match="contiguous"):
        deblock_batch_sharded(cpu_mesh(1, 2), planes[0], planes[1][:, :, :-8],
                              planes[2][:, :, :-8], lm, cm, 32, 4)
    with pytest.raises(ValueError, match="backend"):
        deblock_batch_sharded(cpu_mesh(1, 2), *planes, lm, cm, 32, 4, backend="pallas")


# -- the packed batch step --------------------------------------------------------

@pytest.mark.parametrize("w,h", GEOMS, ids=GEOM_IDS)
def test_packed_batch_matches_jax_and_golden(rng, w, h):
    """deblock_packed_batch_sharded on (2, 4) cpu slots, one frame each and
    uneven chunks (5 frames: 2, 2, 1, 0, ...), in place == the JAX package's
    packed sharded graph (jnp) == golden."""
    import jax.numpy as jnp

    from gpu_video_codec_tpu.parallel.mesh import deblock_packed_batch_sharded_jit as jax_packed
    from gpu_video_codec_tpu.utils.bs import chroma_segment_maps as jcm
    from gpu_video_codec_tpu.utils.bs import luma_segment_maps as jlm

    raws = np.stack([_raw(rng, w, h) for _ in range(8)])
    packed = raws.reshape(8, 3 * h // 2, w)
    jbs = jax_bs(BoundaryStrength.intra_default(w, h))
    ref = np.asarray(jax_packed(jax_mesh(2, 4), jnp.asarray(packed),
                                tuple(jnp.asarray(m) for m in jlm(jbs)),
                                tuple(jnp.asarray(m) for m in jcm(jbs)),
                                jnp.int32(get_beta(QP)), jnp.int32(get_tc(QP)), w=w, h=h))
    sd = StreamingDeblocker(w, h, QP, device="cpu")  # the segment maps the packed step takes
    for n in (8, 5):
        for fn in (pmesh.deblock_packed_batch_sharded, pmesh.deblock_packed_batch_sharded_jit):
            buf = torch.from_numpy(packed[:n].copy())
            assert fn(cpu_mesh(2, 4), buf, sd._lm, sd._cm, get_beta(QP), get_tc(QP),
                      w=w, h=h) is buf
            assert np.array_equal(buf.numpy(), ref[:n]), (n, fn.__name__)
    assert all(np.array_equal(ref[i].ravel(), _gold(raws[i], w, h)) for i in range(8))


def test_packed_batch_rejects_bad_buffers():
    sd = StreamingDeblocker(64, 48, QP, device="cpu")
    with pytest.raises(ValueError, match="packed batch"):
        pmesh.deblock_packed_batch_sharded(cpu_mesh(1, 2), torch.zeros((2, 72, 63), dtype=torch.uint8),
                                           sd._lm, sd._cm, 32, 4, w=64, h=48)


@pytest.mark.parametrize("w,h", GEOMS, ids=GEOM_IDS)
def test_slot_step_goes_through_the_kernels_only(rng, monkeypatch, w, h):
    """A slot's batched packed step runs K2 once (64x48), or T2 2, K1 1, K1c
    1 and T3 2 (the sheared 56x72), for its whole chunk and no F.pad,
    torch.stack, torch.cat, .contiguous() or copy_ outside the kernels'
    wrappers; 3 frames on (1, 2) slots are chunks of 2 and 1: K2 2, or T2
    4, deblock 4, T3 4, in all; == golden.  The same through
    MultiStreamDeblocker.step."""
    from test_torch_sheared import _Spy

    raws = np.stack([_raw(rng, w, h) for _ in range(3)])
    sd = StreamingDeblocker(w, h, QP, device="cpu")
    mesh = cpu_mesh(1, 2)
    ms = MultiStreamDeblocker(mesh, 3, w, h, QP)
    buf = torch.from_numpy(raws.reshape(3, 3 * h // 2, w).copy())
    spy = _Spy(monkeypatch)
    pmesh.deblock_packed_batch_sharded(mesh, buf, sd._lm, sd._cm, get_beta(QP), get_tc(QP),
                                       w=w, h=h)

    def steps(n):  # n slot steps
        if ck.packed_fits(w):
            return {"T2": 0, "T3": 0, "T4": 0, "deblock": 0, "K2": n}
        return {"T2": 2 * n, "T3": 2 * n, "T4": 0, "deblock": 2 * n, "K2": 0}

    assert spy.calls == steps(2)
    outs = ms.step(list(raws))
    assert spy.calls == steps(4)
    monkeypatch.undo()
    for i, raw in enumerate(raws):
        assert np.array_equal(buf[i].numpy().ravel(), _gold(raw, w, h)), i
        assert np.array_equal(outs[i], _gold(raw, w, h)), i


# -- MultiStreamDeblocker (tests/test_multistream.py's cases) ------------------------

@pytest.mark.parametrize("w,h", GEOMS, ids=GEOM_IDS)
def test_multistream_matches_jax_and_golden(rng, w, h):
    from gpu_video_codec_tpu.parallel import MultiStreamDeblocker as JaxMultiStream

    streams = [[_raw(rng, w, h) for _ in range(3)] for _ in range(4)]
    steps = list(MultiStreamDeblocker(cpu_mesh(2, 4), 4, w, h, QP).run(streams))
    ref = list(JaxMultiStream(jax_mesh(2, 4), 4, w, h, QP).run(streams))
    assert len(steps) == len(ref) == 3 and all(len(s) == 4 for s in steps)
    for t, (outs, refs) in enumerate(zip(steps, ref)):
        for i, (out, r) in enumerate(zip(outs, refs)):
            assert np.array_equal(out, r), (t, i)
            assert np.array_equal(out, _gold(streams[i][t], w, h)), (t, i)


def test_multistream_overlap_depth(rng):
    """depth 3, 5 steps: the steady state and the tail drain, in order."""
    w, h = 64, 48
    ms = MultiStreamDeblocker(cpu_mesh(2, 4), 2, w, h, QP, depth=3)
    streams = [[_raw(rng, w, h) for _ in range(5)] for _ in range(2)]
    steps = list(ms.run(streams))
    assert len(steps) == 5
    for t, outs in enumerate(steps):
        for i, out in enumerate(outs):
            assert np.array_equal(out, _gold(streams[i][t], w, h)), (t, i)


def test_multistream_validation(rng):
    mesh = cpu_mesh(2, 4)
    with pytest.raises(ValueError, match="divide by the data axis 2"):
        MultiStreamDeblocker(mesh, 3, 64, 48, QP)
    with pytest.raises(ValueError):
        MultiStreamDeblocker(mesh, 2, 60, 48, QP)  # width not a multiple of 8
    with pytest.raises(ValueError, match="backend"):
        MultiStreamDeblocker(mesh, 2, 64, 48, QP, backend="pallas")
    ms = MultiStreamDeblocker(mesh, 2, 64, 48, QP)
    with pytest.raises(ValueError, match="expected 2 frames"):
        ms.step([_raw(rng, 64, 48)])
    with pytest.raises(ValueError, match="frame must be"):
        ms.step([np.zeros(5, np.uint8)] * 2)
    with pytest.raises(ValueError, match="expected 2 streams"):
        ms.run([[]])


@pytest.mark.parametrize("mesh_shape", [(2, 4), (1, 1)], ids=str)
def test_multistream_update_boundary_strength(rng, mesh_shape):
    """A mid-stream BS swap: steps after it == golden under the new maps,
    and the default maps bring the first outputs back; (1, 1) with 4
    streams is a local batch of 4 on one slot."""
    w, h = 64, 48
    n = 4 if mesh_shape == (1, 1) else 2
    ms = MultiStreamDeblocker(cpu_mesh(*mesh_shape), n, w, h, QP)
    raws = [_smooth(rng, w, h) for _ in range(n)]
    out_default = ms.step(raws)
    custom = BoundaryStrength.intra_default(w, h)
    custom.vert[:] = 0  # every vertical luma edge off
    ms.update_boundary_strength(custom)
    out_custom = ms.step(raws)
    assert not np.array_equal(out_default[0], out_custom[0])
    for raw, out in zip(raws, out_custom):
        assert np.array_equal(out, _gold(raw, w, h, custom))
    with pytest.raises(ValueError, match="geometry"):
        ms.update_boundary_strength(BoundaryStrength.intra_default(w, h * 2))
    ms.update_boundary_strength(BoundaryStrength.intra_default(w, h))
    assert all(np.array_equal(a, b) for a, b in zip(ms.step(raws), out_default))


def test_multistream_local_batch_matches_jax(rng):
    """4 streams on one slot (the JAX test's 1x1 local batch > 1), == the
    JAX package's fast path (pallas, interpret mode) and golden."""
    from gpu_video_codec_tpu.parallel import MultiStreamDeblocker as JaxMultiStream

    w, h = 64, 48
    raws = [_smooth(rng, w, h) for _ in range(4)]
    ref = JaxMultiStream(jax_mesh(1, 1), 4, w, h, QP, backend="pallas").step(raws)
    for raw, out, r in zip(raws, MultiStreamDeblocker(cpu_mesh(1, 1), 4, w, h, QP).step(raws),
                           ref):
        assert np.array_equal(out, r) and np.array_equal(out, _gold(raw, w, h))


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_multistream_luma_only(rng, backend):
    w, h = 64, 48
    ms = MultiStreamDeblocker(cpu_mesh(1, 1), 2, w, h, QP, backend=backend, luma_only=True)
    raws = [_raw(rng, w, h) for _ in range(2)]
    for raw, out in zip(raws, ms.step(raws)):
        assert np.array_equal(out, _gold(raw, w, h, luma_only=True))
        assert np.array_equal(out[w * h :], raw[w * h :])  # chroma untouched


@pytest.mark.parametrize("w,h", GEOMS, ids=GEOM_IDS)
def test_multistream_uneven_chunks(rng, w, h):
    """3 streams on (1, 2) slots: chunks of 2 and 1 frames; the plain
    backend gives the same bytes; == golden."""
    streams = [[_raw(rng, w, h) for _ in range(2)] for _ in range(3)]
    outs = list(MultiStreamDeblocker(cpu_mesh(1, 2), 3, w, h, QP).run(streams))
    plain = list(MultiStreamDeblocker(cpu_mesh(1, 2), 3, w, h, QP, backend="torch").run(streams))
    for t, (batch, ref) in enumerate(zip(outs, plain)):
        for i, (out, r) in enumerate(zip(batch, ref)):
            assert np.array_equal(out, r) and np.array_equal(out, _gold(streams[i][t], w, h))


# -- MeshResidentDeblocker (tests/test_mesh.py's TestMeshResident) ------------------

@pytest.mark.parametrize("w,h", GEOMS, ids=GEOM_IDS)
def test_mesh_resident_matches_jax_and_golden(rng, w, h):
    """(4, 2) slots, 8 frames == golden; at 64x48 also == the JAX package's
    MeshResidentDeblocker (Pallas in interpret mode; its 56x72 case is in
    the JAX package's slow tier)."""
    from gpu_video_codec_tpu.parallel import MeshResidentDeblocker as JaxMeshResident

    raws = [_raw(rng, w, h) for _ in range(8)]
    out = MeshResidentDeblocker(cpu_mesh(4, 2), w, h, QP)(raws)
    assert out.shape == (8, 3 * w * h // 2)
    if (w, h) == (64, 48):
        assert np.array_equal(out, np.asarray(JaxMeshResident(jax_mesh(4, 2), w, h, QP)(raws)))
    for i, raw in enumerate(raws):
        assert np.array_equal(out[i], _gold(raw, w, h)), i


def test_mesh_resident_chained_steps_match_single_slot(rng):
    """(8, 1) slots, 3 chained steps == the port's ResidentDeblocker frame
    by frame; a tensor batch ingests the same."""
    w, h = 64, 48
    raws = [_raw(rng, w, h) for _ in range(8)]
    mrd = MeshResidentDeblocker(cpu_mesh(8, 1), w, h, QP)
    state = mrd.ingest(raws)
    assert len(state.parts) == 8 and all(p.y.shape[0] == 1 for p in state.parts)
    out = mrd.readback(mrd.step(state, n_steps=3))
    rd = ResidentDeblocker(w, h, QP, device="cpu")
    for i, raw in enumerate(raws):
        assert np.array_equal(out[i], rd.readback(rd.run_steps(rd.ingest(raw), 3))), i
        assert np.array_equal(out[i], _gold(raw, w, h, passes=3)), i
    tensor = mrd.readback(mrd.step(mrd.ingest(torch.from_numpy(np.stack(raws))), n_steps=3))
    assert np.array_equal(tensor, out)


def test_mesh_resident_errors_and_bs_update(rng):
    w, h = 64, 48
    mrd = MeshResidentDeblocker(cpu_mesh(8, 1), w, h, QP)
    with pytest.raises(ValueError, match="not divisible by data axis 8"):
        mrd.ingest([_raw(rng, w, h) for _ in range(5)])
    with pytest.raises(ValueError, match="needs a BATCH"):
        mrd.ingest(_raw(rng, w, h))
    mrd = MeshResidentDeblocker(cpu_mesh(2, 1), w, h, QP, luma_block=32, chroma_block=16)
    raws = [_smooth(rng, w, h) for _ in range(2)]
    before = mrd(raws)
    custom = BoundaryStrength.intra_default(w, h)
    custom.vert[:] = 0
    mrd.update_boundary_strength(custom)
    after = mrd(raws)
    assert not np.array_equal(before, after)
    for raw, out in zip(raws, after):
        assert np.array_equal(out, _gold(raw, w, h, custom))


# -- on the card ----------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _counts() -> dict:
    return {"T2": rk.LAUNCHES["fwd"], "T3": rk.LAUNCHES["inv"], "T4": rk.LAUNCHES["pack"],
            "K1": ck.LAUNCHES["luma"], "K1c": ck.LAUNCHES["chroma"], "K2": ck.LAUNCHES["packed"]}


def _batch_steps(w, n) -> dict:
    """The launches of n batched packed steps: K2 once each where its guard
    takes the width (the slots' buffers are fresh, so aligned), else T2 2,
    K1, K1c, T3 2."""
    if ck.packed_fits(w):
        return {"T2": 0, "T3": 0, "T4": 0, "K1": 0, "K1c": 0, "K2": n}
    return {"T2": 2 * n, "T3": 2 * n, "T4": 0, "K1": n, "K1c": n, "K2": 0}


def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _counts().items()}


@pytest.mark.cuda
@pytest.mark.parametrize("w,h", [(64, 48), (360, 288)], ids=["64x48", "360x288-sheared"])
def test_multistream_two_slots_on_one_card(rng, cuda_device, w, h):
    """3 streams on [cuda:0] * 2 as (1, 2): chunks of 2 and 1, each slot its
    own ring and stream; per batch one packed step a slot (K2, or T2 2, K1,
    K1c, T3 2 on the sheared width; one replay a slot); == the plain
    backend == golden, across a BS swap."""
    mesh = make_mesh(1, 2, [cuda_device] * 2)
    streams = [[_smooth(rng, w, h) for _ in range(4)] for _ in range(3)]
    ms = MultiStreamDeblocker(mesh, 3, w, h, QP)
    plain = MultiStreamDeblocker(mesh, 3, w, h, QP, backend="torch")
    custom = BoundaryStrength.intra_default(w, h)
    custom.vert[:] = 0
    before = _counts()
    outs = list(ms.run([s[:2] for s in streams]))
    ms.update_boundary_strength(custom)
    outs += list(ms.run([s[2:] for s in streams]))
    assert _delta(before) == _batch_steps(w, 8)
    assert ms._slots[0].ring is not ms._slots[1].ring
    refs = list(plain.run([s[:2] for s in streams]))
    plain.update_boundary_strength(custom)
    refs += list(plain.run([s[2:] for s in streams]))
    for t, (batch, ref) in enumerate(zip(outs, refs)):
        for i, (out, r) in enumerate(zip(batch, ref)):
            assert np.array_equal(out, r), (t, i)
            assert np.array_equal(out, _gold(streams[i][t], w, h, custom if t >= 2 else None))


@pytest.mark.cuda
def test_packed_jit_graphs_keyed_by_slot(rng, cuda_device):
    """deblock_packed_batch_sharded_jit on [cuda:0] * 2: one graph per slot
    (the slot index in the key), captured at the first call and replayed
    after; launches per call K2 2 (one a slot); == the plain step."""
    w, h = 64, 48
    mesh = make_mesh(1, 2, [cuda_device] * 2)
    sd = StreamingDeblocker(w, h, QP, device=cuda_device)
    raws = torch.from_numpy(np.stack([_raw(rng, w, h) for _ in range(3)]).reshape(3, -1, w))
    ref = raws.to(cuda_device)
    pmesh.deblock_packed_batch_sharded(mesh, ref, sd._lm, sd._cm, get_beta(QP), get_tc(QP),
                                       w=w, h=h, backend="torch")
    buf = torch.empty_like(ref)
    keys_before = set(pmesh._GRAPHS._graphs)
    for _ in range(2):
        buf.copy_(raws)
        before = _counts()
        pmesh.deblock_packed_batch_sharded_jit(mesh, buf, sd._lm, sd._cm, get_beta(QP),
                                               get_tc(QP), w=w, h=h)
        assert _delta(before) == _batch_steps(w, 2)
        torch.cuda.synchronize()
        assert torch.equal(buf, ref)
    new = set(pmesh._GRAPHS._graphs) - keys_before
    assert sorted(k[0] for k in new) == [0, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_shape", [(1, 2), (1, 3), (2, 3)], ids=str)
def test_batch_sharded_slabs_on_card(rng, cuda_device, mesh_shape):
    """Uneven slabs of 360x288 extended planes on slots of cuda:0, eager and
    as graph replays, == one slot == golden."""
    w, h, n = 360, 288, 2
    ys, us, vs = _ext_batch(rng, n, w, h)
    bs = BoundaryStrength.intra_default(w, h)
    lm = [torch.from_numpy(m).to(cuda_device) for m in luma_segment_maps(bs)]
    cm = [torch.from_numpy(m).to(cuda_device) for m in chroma_segment_maps(bs)]
    one = [torch.from_numpy(a.copy()).to(cuda_device) for a in (ys, us, vs)]
    deblock_batch_sharded(make_mesh(1, 1, [cuda_device]), *one, lm, cm, get_beta(QP),
                          get_tc(QP))
    mesh = make_mesh(*mesh_shape, [cuda_device] * (mesh_shape[0] * mesh_shape[1]))
    for fn in (deblock_batch_sharded, deblock_batch_sharded_jit, deblock_batch_sharded_jit):
        planes = [torch.from_numpy(a.copy()).to(cuda_device) for a in (ys, us, vs)]
        fn(mesh, *planes, lm, cm, get_beta(QP), get_tc(QP))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(planes, one)), fn.__name__
    gold = deblock_frame_golden(FramePlanes(ys[0], us[0], vs[0], w, h), bs, QP)
    assert all(np.array_equal(p[0].cpu().numpy(), getattr(gold, k)) for p, k in zip(one, "yuv"))


@pytest.mark.cuda
def test_mesh_resident_two_slots_on_one_card(rng, cuda_device):
    """A batch of 4 x 3 steps on [cuda:0] * 2 as (2, 1) == the port's
    ResidentDeblocker on the whole batch; K1 3 and K1c 3 per slot."""
    w, h = 360, 288
    raws = np.stack([_raw(rng, w, h) for _ in range(4)])
    mrd = MeshResidentDeblocker(make_mesh(2, 1, [cuda_device] * 2), w, h, QP)
    state = mrd.ingest(raws)
    before = _counts()
    state = mrd.step(state, 3)
    assert _delta(before) == {"T2": 0, "T3": 0, "T4": 0, "K1": 6, "K1c": 6, "K2": 0}
    out = mrd.readback(state)
    rd = ResidentDeblocker(w, h, QP, device=cuda_device)
    assert np.array_equal(out, rd.readback(rd.run_steps(rd.ingest(raws), 3)))
    assert np.array_equal(out[0], _gold(raws[0], w, h, passes=3))


@pytest.mark.cuda
def test_mesh_across_cards(rng):
    """Every card of the machine a slot (skips with fewer than two): the
    default make_mesh, MultiStreamDeblocker (a ring and graphs per card),
    the packed step and the slabs with the batch on cuda:0 (each other
    card's part copied there and back), MeshResidentDeblocker (graph
    replays per card); each == golden or one slot, and the caller's current
    device is cuda:0 after every call."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    n = torch.cuda.device_count()
    w, h = 360, 288
    torch.cuda.set_device(0)
    mesh = make_mesh(1, n)
    assert [d.index for d in mesh.devices.flat] == list(range(n))
    streams = [[_smooth(rng, w, h) for _ in range(3)] for _ in range(2 * n)]
    outs = list(MultiStreamDeblocker(mesh, 2 * n, w, h, QP).run(streams))
    assert torch.cuda.current_device() == 0
    for t, batch in enumerate(outs):
        for i, out in enumerate(batch):
            assert np.array_equal(out, _gold(streams[i][t], w, h)), (t, i)
    sd = StreamingDeblocker(w, h, QP, device="cuda:0")
    raws = np.stack([streams[i][0] for i in range(2 * n)])
    buf = torch.from_numpy(raws.reshape(2 * n, 3 * h // 2, w).copy()).to("cuda:0")
    for _ in range(2):
        pmesh.deblock_packed_batch_sharded_jit(mesh, buf, sd._lm, sd._cm, get_beta(QP),
                                               get_tc(QP), w=w, h=h)
        assert torch.cuda.current_device() == 0
    out = buf.cpu().numpy().reshape(2 * n, -1)  # two packed steps: padding zero at each
    assert all(np.array_equal(out[i], _gold(_gold(raws[i], w, h), w, h)) for i in range(2 * n))
    ys, us, vs = _ext_batch(rng, 2, w, h)
    bs = BoundaryStrength.intra_default(w, h)
    planes = [torch.from_numpy(a.copy()).to("cuda:0") for a in (ys, us, vs)]
    deblock_batch_sharded(mesh, *planes, luma_segment_maps(bs), chroma_segment_maps(bs),
                          get_beta(QP), get_tc(QP))
    gold = deblock_frame_golden(FramePlanes(ys[1], us[1], vs[1], w, h), bs, QP)
    assert all(np.array_equal(p[1].cpu().numpy(), getattr(gold, k)) for p, k in zip(planes, "yuv"))
    mrd = MeshResidentDeblocker(make_mesh(n, 1), w, h, QP)
    res = mrd.readback(mrd.step(mrd.ingest(raws), 2))
    assert torch.cuda.current_device() == 0
    assert all(np.array_equal(res[i], _gold(raws[i], w, h, passes=2)) for i in range(2 * n))
