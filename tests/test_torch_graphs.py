"""The one-dispatch paths of the PyTorch port: StreamingDeblocker._chain /
_deblock_yv12_packed_n, _step, the ring of run(), and
ResidentDeblocker.run_steps / _step_n.

On a CPU device they are loops of eager steps, held here against n eager
steps and the golden oracle.  On a CUDA device they replay CUDA graphs
(utils/graphs.py); the `cuda`-marked tests hold the replays against n eager
steps of the plain backend, byte for byte, with the launch counts that the
replays add.  This file imports nothing of JAX, so it also runs where JAX
is not installed (`python -m pytest tests/test_torch_graphs.py -m cuda`)."""

import contextlib
import sys

import numpy as np
import pytest
import torch

import gpu_video_codec_tpu_torch.models.streaming as st
from gpu_video_codec_tpu_torch.models.golden import deblock_frame_golden
from gpu_video_codec_tpu_torch.models.resident import ResidentDeblocker
from gpu_video_codec_tpu_torch.models.streaming import StreamingDeblocker, _deblock_yv12_packed_n
from gpu_video_codec_tpu_torch.ops import cuda_kernel as ck
from gpu_video_codec_tpu_torch.ops import relayout_kernel as rk
from gpu_video_codec_tpu_torch.ops.tables import get_beta, get_tc
from gpu_video_codec_tpu_torch.parallel import mesh as pm
from gpu_video_codec_tpu_torch.utils.bs import BoundaryStrength
from gpu_video_codec_tpu_torch.utils.graphs import GraphCache
from gpu_video_codec_tpu_torch.utils.tracing import RECORDER
from gpu_video_codec_tpu_torch.utils.yuv import planes_from_yv12_bytes, yv12_bytes_from_planes

GEOMS = [(64, 48), (40, 24)]  # regular, Q9-sheared (w % 16 == 8)
CPU = torch.device("cpu")


def _raw(rng, w, h):
    return rng.integers(0, 256, 3 * w * h // 2, dtype=np.uint8)


def _random_bs(rng, w, h):
    bs = BoundaryStrength.intra_default(w, h)
    bs.set_luma(rng.integers(0, 3, bs.vert.size, dtype=np.uint8),
                rng.integers(0, 3, bs.hor.size, dtype=np.uint8))
    bs.set_chroma(rng.integers(0, 3, bs.chroma_vert.size, dtype=np.uint8),
                  rng.integers(0, 3, bs.chroma_hor.size, dtype=np.uint8))
    return bs


def _golden(raw, w, h, qp=35, bs=None):
    bs = bs or BoundaryStrength.intra_default(w, h)
    gold = deblock_frame_golden(planes_from_yv12_bytes(raw, w, h), bs, qp)
    return np.frombuffer(yv12_bytes_from_planes(gold), np.uint8)


def _launches():
    return {"T2": rk.LAUNCHES["fwd"], "K1": ck.LAUNCHES["luma"], "K1c": ck.LAUNCHES["chroma"],
            "T3": rk.LAUNCHES["inv"], "T4": rk.LAUNCHES["pack"], "K2": ck.LAUNCHES["packed"]}


def _step_launches(w, n):
    """The launches of n packed steps: K2 once each where its guard takes
    the width (the buffers are fresh, so aligned), else T2 2, K1, K1c, T3 2."""
    if ck.packed_fits(w):
        return {"T2": 0, "K1": 0, "K1c": 0, "T3": 0, "T4": 0, "K2": n}
    return {"T2": 2 * n, "K1": n, "K1c": n, "T3": 2 * n, "T4": 0, "K2": 0}


def _reset():
    for d in (ck.LAUNCHES, rk.LAUNCHES):
        d.update(dict.fromkeys(d, 0))


# -- CPU: loops of eager steps --------------------------------------------------

@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("w,h", GEOMS)
def test_chain_is_n_steps_in_place(rng, w, h, n):
    s = StreamingDeblocker(w, h, 35, device=CPU)
    raw = _raw(rng, w, h)
    buf = s._put(raw)
    looped = buf.clone()
    for _ in range(n):
        s._step(looped)
    out = s._chain(buf, n)
    assert out is buf and torch.equal(buf, looped)
    direct = s._put(raw)
    assert _deblock_yv12_packed_n(direct, s._lm, s._cm, s._beta, s._tc, n, w, h, False,
                                  "cuda") is direct
    assert torch.equal(direct, looped)
    if n == 1:
        assert np.array_equal(buf.numpy().ravel(), _golden(raw, w, h))


def test_chain_zero_steps(rng):
    s = StreamingDeblocker(64, 48, 35, device=CPU)
    raw = _raw(rng, 64, 48)
    buf = s._put(raw)
    assert s._chain(buf, 0) is buf and np.array_equal(buf.numpy().ravel(), raw)


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("w,h", GEOMS)
def test_run_steps_is_n_steps(rng, w, h, batch):
    """run_steps(tf, 3) == three step()s; the input state is untouched and
    two results share no memory."""
    rd = ResidentDeblocker(w, h, 35, device=CPU)
    raws = np.stack([_raw(rng, w, h) for _ in range(batch)])
    tf = rd.ingest(raws)
    keep = [t.clone() for t in tf]
    looped = tf
    for _ in range(3):
        looped = rd.step(looped)
    a, b = rd.run_steps(tf, 3), rd.run_steps(tf, 3)
    for x, y, z in zip(a, b, looped):
        assert torch.equal(x, z) and torch.equal(y, z)
    assert all(torch.equal(t, k) for t, k in zip(tf, keep))
    assert not np.shares_memory(a.y.numpy(), b.y.numpy())
    assert not np.shares_memory(a.uv.numpy(), b.uv.numpy())


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_run_order_and_midstream_bs_swap(rng, depth):
    """Frames come out in order, each a fresh array; a BS swap after the
    third yielded frame reaches the frames submitted after it (up to depth
    frames are submitted ahead of the one yielded)."""
    w, h, n = 64, 48, 6
    raws = [_raw(rng, w, h) for _ in range(n)]
    bs = _random_bs(rng, w, h)
    s = StreamingDeblocker(w, h, 35, depth=depth, device=CPU)
    outs = []
    for out in s.run(raws):
        outs.append(out)
        if len(outs) == 3:
            s.update_boundary_strength(bs)
    swapped_from = min(n, 2 + depth)
    assert len(outs) == n
    for i, (raw, out) in enumerate(zip(raws, outs)):
        assert out.dtype == np.uint8 and out.shape == raw.shape
        want = _golden(raw, w, h, bs=bs if i >= swapped_from else None)
        assert np.array_equal(out, want), i
    assert not any(np.shares_memory(a, b) for i, a in enumerate(outs) for b in outs[i + 1:])


@pytest.mark.parametrize("path", ["streaming", "resident"])
def test_update_boundary_strength_in_place(rng, path):
    """A BS update rewrites the maps where they are (a captured graph reads
    their addresses) and leaves earlier operands() copies as they were."""
    w, h = 64, 48
    bs = _random_bs(rng, w, h)
    d = (StreamingDeblocker if path == "streaming" else ResidentDeblocker)(w, h, 35, device=CPU)
    maps = d._lm + d._cm
    before = [m.clone() for m in maps]
    ptrs = [m.data_ptr() for m in maps]
    ops = d.operands if path == "resident" else None
    d.update_boundary_strength(bs)
    assert [m.data_ptr() for m in d._lm + d._cm] == ptrs
    assert any(not torch.equal(m, b) for m, b in zip(maps, before))
    fresh = type(d)(w, h, 35, bs=bs, device=CPU)
    for m, f in zip(d._lm + d._cm, fresh._lm + fresh._cm):
        assert torch.equal(m, f)
    if ops is not None:  # operands() are copies: they keep the old maps
        assert all(torch.equal(o, b) for o, b in zip(ops.lm + ops.cm, before))


def test_time_breakdown_keys(rng, monkeypatch):
    """time_breakdown's keys, with its CUDA timing and profiler stubbed."""
    w, h = 64, 48
    s = StreamingDeblocker(w, h, 35, device=CPU)
    monkeypatch.setattr(StreamingDeblocker, "_require_cuda", lambda self, what: None)
    monkeypatch.setattr(StreamingDeblocker, "_stream_s", lambda self, fn, n, stream: 2e-6)
    cats = {"deblock_kernels": 7.8123, "layout_and_copies": 12.4, "total": 20.2123}
    monkeypatch.setattr(st, "profiled_device_us", lambda thunk, iters: (20.2123, cats, {}))
    raw = _raw(rng, w, h)
    res = s.time_breakdown(raw, n=2, measure_d2h=True)
    assert set(res) == {"h2d_s", "kernel_s", "dispatch_s", "device_split_us", "e2e_sync_s"}
    assert res["h2d_s"] == res["kernel_s"] == 2e-6
    assert res["device_split_us"] == {"deblock_kernels": 7.81, "layout_and_copies": 12.4,
                                      "other": 0.0}
    assert res["dispatch_s"] > 0 and res["e2e_sync_s"] > 0
    monkeypatch.setattr(st, "profiled_device_us", lambda thunk, iters: None)
    assert set(s.time_breakdown(raw, n=2)) == {"h2d_s", "kernel_s", "dispatch_s"}


def test_graph_cache_is_bounded_lru():
    built = []

    def build(k):
        return lambda: built.append(k) or f"graph {k}"

    cache = GraphCache(maxsize=2)
    assert cache.get("a", build("a")) == "graph a"
    assert cache.get("b", build("b")) == "graph b"
    assert cache.get("a", build("a")) == "graph a"  # a hit: nothing built
    cache.get("c", build("c"))  # evicts b, the least recently used
    assert len(cache) == 2
    cache.get("a", build("a"))
    cache.get("b", build("b"))
    assert built == ["a", "b", "c", "b"]


# -- the program's spans and counters on these paths (utils/tracing.RECORDER) ---------

def _packed_call(rng, mesh, w=64, h=48, n=2, backend="cuda"):
    sd = StreamingDeblocker(w, h, 35, device="cpu")  # the segment maps as tensors
    buf = torch.from_numpy(np.stack([_raw(rng, w, h) for _ in range(n)]).reshape(n, -1, w))
    return lambda: pm.deblock_packed_batch_sharded_jit(mesh, buf, sd._lm, sd._cm, get_beta(35),
                                                       get_tc(35), w=w, h=h, backend=backend)


def _counted(calls, n=2, w=64, h=48):
    """RECORDER.counters() after `calls` of _packed_call's calls: mesh.calls
    and the tiles of their frames' packed steps."""
    (by, bx), (cby, cbx) = ck.packed_grids(w, h)
    return {"mesh.calls": calls, "packed.luma_tiles": calls * n * by * bx,
            "packed.chroma_tiles": calls * n * 2 * cby * cbx}


def _profiled():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture
def every_call(monkeypatch):
    """Every unprofiled packed call recorded, not one in RECORDER.every."""
    monkeypatch.setattr(RECORDER, "every", 1)


@pytest.mark.parametrize("slots", [1, 2])
def test_packed_call_on_cpu_slots_records_packed_and_place(rng, slots, every_call):
    """One deblock_packed_batch_sharded_jit call on CPU slots runs eagerly:
    the span mesh.packed, all its own time, and one mesh.calls; under the
    profiler mesh.place inside it, the two of the call's id."""
    call = _packed_call(rng, pm.make_mesh(1, slots, devices=["cpu"] * slots))
    RECORDER.reset()
    call()
    tot = RECORDER.totals()
    assert set(tot) == {"mesh.packed"}
    assert tot["mesh.packed"].count == 1 and tot["mesh.packed"].self_ns == tot["mesh.packed"].ns > 0
    assert RECORDER.counters() == _counted(1)
    with _profiled():
        call()
    spans = RECORDER.timeline()
    root, place = sorted(spans, key=lambda s: s.name)
    assert (root.name, root.parent, place.name, place.parent) == (
        "mesh.packed", None, "mesh.place", root.id)
    assert root.call == place.call == 2 and RECORDER.counters() == _counted(2)
    assert root.start_ns == place.start_ns < place.end_ns == root.end_ns
    assert RECORDER.totals() == tot


class _FakeStream:
    def wait_stream(self, other):
        pass


class _FakeGraph:
    def replay(self):
        pass

    def pool(self):
        return None


@pytest.fixture
def graph_path(monkeypatch):
    """The mesh's graph path on CPU slots: CUDA's device, stream and graph
    calls stubbed, so that _run enters the slot's device, looks up, captures (CapturedStep's
    warm-up and capture run fn eagerly) and replays as on a card."""
    null = lambda *a, **k: contextlib.nullcontext()  # noqa: E731
    for name, value in (("current_stream", lambda *a: _FakeStream()),
                        ("Stream", lambda *a, **k: _FakeStream()), ("stream", null),
                        ("device", null), ("graph", null), ("CUDAGraph", _FakeGraph)):
        monkeypatch.setattr(torch.cuda, name, value)
    monkeypatch.setattr(pm, "graphed", lambda backend, device: True)
    monkeypatch.setattr(pm, "_GRAPHS", GraphCache(maxsize=16))


def test_graph_path_span_order(rng, graph_path):
    """A packed call on the graph path: place, fork, lookup, launch and
    join, one after another inside mesh.packed, all of the call's id; the
    first call's capture inside its lookup; one capture in two calls."""
    call = _packed_call(rng, pm.make_mesh(1, 1, devices=["cpu"]))
    RECORDER.reset()
    with _profiled():
        call()
        call()
    spans = sorted(RECORDER.timeline(), key=lambda s: (s.start_ns, -s.end_ns))
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["mesh.packed"] * 2
    phases = ["mesh.place", "mesh.fork", "graphs.lookup", "graphs.launch", "mesh.join"]
    for root in roots:
        inner = [s for s in spans if s.parent == root.id]
        assert {s.call for s in inner} == {root.call}
        assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns for s in inner)
        hot = [s for s in inner if s.name in phases]
        assert [s.name for s in hot] == phases
        assert all(a.end_ns == b.start_ns for a, b in zip(hot, hot[1:]))
    captures = [s for s in spans if s.name == "graphs.capture"]
    assert len(captures) == 1 and captures[0].parent == roots[0].id
    lookup = next(s for s in spans if s.name == "graphs.lookup" and s.call == 1)
    assert lookup.start_ns <= captures[0].start_ns <= captures[0].end_ns <= lookup.end_ns
    assert [r.call for r in roots] == [1, 2]
    assert RECORDER.counters() == _counted(2)
    assert RECORDER.totals() == {}


@pytest.mark.parametrize("slots", [1, 2], ids=["one-slot", "two-slots"])
def test_graph_path_replays_on_the_callers_stream(rng, graph_path, monkeypatch, slots):
    """Every slot's replay goes on the caller's current stream: no slot
    stream is made and no stream waits on another; == the plain step."""
    waited = []
    monkeypatch.setattr(_FakeStream, "wait_stream", lambda self, other: waited.append(other))
    w, h, n = 64, 48, 2
    sd = StreamingDeblocker(w, h, 35, device="cpu")
    raw = torch.from_numpy(np.stack([_raw(rng, w, h) for _ in range(n)]).reshape(n, -1, w))
    buf, ref = raw.clone(), raw.clone()
    mesh = pm.make_mesh(1, slots, devices=["cpu"] * slots)
    pm.deblock_packed_batch_sharded_jit(mesh, buf, sd._lm, sd._cm, get_beta(35), get_tc(35),
                                        w=w, h=h)
    for frame in ref:
        sd._step(frame)
    assert torch.equal(buf, ref)
    assert waited == [] and mesh._streams == {}


def test_graph_path_totals(rng, graph_path, every_call):
    """Unprofiled, the same calls add to the totals: one of each span a
    call but the first, whose capture is set-up and counted apart, and the
    phases inside mesh.packed, the rest its self time."""
    call = _packed_call(rng, pm.make_mesh(1, 1, devices=["cpu"]))
    RECORDER.reset()
    for _ in range(3):
        call()
    tot = RECORDER.totals()
    for name in ("mesh.packed", "mesh.fork", "graphs.launch", "mesh.join"):
        assert tot[name].count == 2, name
    assert tot["graphs.capture"].count == 1
    parts = sum(tot[k].ns for k in ("mesh.fork", "graphs.launch", "mesh.join"))
    assert 0 < tot["mesh.packed"].self_ns == tot["mesh.packed"].ns - parts
    assert RECORDER.counters() == _counted(3)
    assert RECORDER.timeline() == []


def test_mesh_calls_counts_every_call(rng):
    call = _packed_call(rng, pm.make_mesh(1, 2, devices=["cpu"] * 2), n=3)
    RECORDER.reset()
    for i in range(1, 4):
        call()
        assert RECORDER.counters()["mesh.calls"] == i


def test_kernel_builds_counted_when_the_compiler_runs(tmp_path, monkeypatch):
    """kernels.build counts and times compiler runs; a library already
    built runs no compiler."""
    monkeypatch.setattr(ck, "BUILD_DIR", tmp_path)
    touch = [sys.executable, "-c",
             "import sys; open(sys.argv[sys.argv.index('-o') + 1], 'w').close()"]
    RECORDER.reset()
    path, _ = ck._build(touch, ck._HOST_SOURCES, "libgvct_test")
    assert path.is_file()
    assert RECORDER.totals()["kernels.build"].count == 1
    assert ck._build(touch, ck._HOST_SOURCES, "libgvct_test")[0] == path
    assert RECORDER.totals()["kernels.build"].count == 1
    assert RECORDER.counters() == {}


def test_kernel_load_span_on_first_load_only(monkeypatch):
    """kernels.load spans a library's first load, its build inside, which its
    self time leaves out."""
    import ctypes.util

    libc = ctypes.util.find_library("c")
    monkeypatch.setattr(ck, "_libs", {})
    RECORDER.reset()

    def build():
        with RECORDER.span("kernels.build"):
            return libc, ""

    with _profiled():
        lib = ck._load("test", build, lambda lib: None)
        assert ck._load("test", build, lambda lib: None) is lib
    load, built = sorted(RECORDER.timeline(), key=lambda s: s.start_ns)
    assert (load.name, built.name, built.parent, load.parent) == (
        "kernels.load", "kernels.build", load.id, None)
    monkeypatch.setattr(ck, "_libs", {})
    ck._load("test", build, lambda lib: None)  # unprofiled: the load's self time
    tot = RECORDER.totals()
    assert tot["kernels.load"].count == tot["kernels.build"].count == 1
    assert tot["kernels.load"].self_ns == tot["kernels.load"].ns - tot["kernels.build"].ns


# -- the card: graph replays against eager plain steps ------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("w,h", GEOMS)
def test_cuda_chain_replays_match_eager(rng, cuda_device, w, h, n):
    s = StreamingDeblocker(w, h, 35, device=cuda_device)
    plain = StreamingDeblocker(w, h, 35, backend="torch", device=cuda_device)
    raw = torch.from_numpy(_raw(rng, w, h).reshape(3 * h // 2, w)).to(cuda_device)
    ref = raw.clone()
    for _ in range(n):
        plain._step(ref)
    buf = raw.clone()
    for _ in range(2):  # the call that captures the graph, then a replay alone
        buf.copy_(raw)
        _reset()
        assert s._chain(buf, n) is buf
        assert _launches() == _step_launches(w, n)
        assert torch.equal(buf, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("w,h", GEOMS)
def test_cuda_run_steps_replays_match_eager(rng, cuda_device, w, h):
    """Batch 2, three steps: == the plain backend's loop; the input is
    untouched; a second call neither overwrites nor aliases the first."""
    rd = ResidentDeblocker(w, h, 35, device=cuda_device)
    plain = ResidentDeblocker(w, h, 35, backend="torch", device=cuda_device)
    raws = np.stack([_raw(rng, w, h) for _ in range(2)])
    tf = rd.ingest(raws)
    keep = [t.clone() for t in tf]
    ref = plain.run_steps(plain.ingest(raws), 3)
    _reset()
    a = rd.run_steps(tf, 3)
    assert _launches() == {"T2": 0, "K1": 3, "K1c": 3, "T3": 0, "T4": 0, "K2": 0}
    b = rd.run_steps(tf, 3)
    for x, y, r in zip(a, b, ref):
        assert torch.equal(x, r) and torch.equal(y, r)
    assert a.y.data_ptr() != b.y.data_ptr() and a.uv.data_ptr() != b.uv.data_ptr()
    assert all(torch.equal(t, k) for t, k in zip(tf, keep))
    assert np.array_equal(rd.readback(a), plain.readback(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("w,h", GEOMS)
def test_cuda_ring_run_with_bs_swap(rng, cuda_device, w, h):
    """run() through the graph ring == the plain backend, across a BS swap
    after the ring's graphs were captured; one packed step per frame (K2, or
    a T2/K1/K1c/T3 round on the sheared width)."""
    raws = [_raw(rng, w, h) for _ in range(5)]
    bs = _random_bs(rng, w, h)

    def swapped(backend):
        sd = StreamingDeblocker(w, h, 35, backend=backend, depth=2, device=cuda_device)
        _reset()
        got = list(sd.run(raws[:3]))
        sd.update_boundary_strength(bs)
        return got + list(sd.run(raws[3:])), _launches()

    outs, launches = swapped("cuda")
    refs, _ = swapped("torch")
    assert launches == _step_launches(w, 5)
    assert all(np.array_equal(o, r) for o, r in zip(outs, refs))
    assert np.array_equal(outs[4], _golden(raws[4], w, h, bs=bs))


@pytest.mark.cuda
def test_cuda_step_graph_cache_stays_bounded(rng, cuda_device):
    w, h = 64, 48
    s = StreamingDeblocker(w, h, 35, device=cuda_device)
    bufs = [s._put(_raw(rng, w, h)) for _ in range(st._GRAPHS.maxsize + 3)]
    refs = [b.clone() for b in bufs]
    plain = StreamingDeblocker(w, h, 35, backend="torch", device=cuda_device)
    for b, r in zip(bufs, refs):
        s._step(b)
        plain._step(r)
    assert len(st._GRAPHS) <= st._GRAPHS.maxsize
    assert all(torch.equal(b, r) for b, r in zip(bufs, refs))
