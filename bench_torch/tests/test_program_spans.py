"""The readers of the program's spans and counters (lib/program_spans.py
and the seven metrics that use it) on synthetic records: the map of the
program's root spans onto the trace's clock, the idle time put down to the
program's calls, the per-call means of the totals, and None wherever there
is nothing to read (no trace, no recorder, counts that differ, no map).

    python -m pytest bench_torch/tests -q
"""

from __future__ import annotations

import pytest

from bench_torch.lib import program_spans as ps
from bench_torch.lib import spec
from bench_torch.lib.feeds import Record
from gpu_video_codec_tpu_torch.utils.tracing import Span


class FakeRecorder:
    """What the readers read of the program's Recorder."""

    def __init__(self, totals=None, counters=None, timeline=(), dropped=0):
        self._totals, self._counters = totals or {}, counters or {}
        self._timeline, self.dropped = list(timeline), dropped

    def totals(self):
        return dict(self._totals)

    def counters(self):
        return dict(self._counters)

    def timeline(self):
        return list(self._timeline)


def _record(trace=None, feed="device"):
    rec = Record(feed, 64, 48, 2, "cpu")
    rec.trace = trace
    return rec


def _use(monkeypatch, recorder):
    monkeypatch.setattr(ps, "recorder", lambda: recorder)


# -- the map onto the trace's clock ---------------------------------------------------

NS0 = 15_000_000_000_000  # a perf_counter_ns reading


def _pairs(n=200, rate=1.0 + 2e-5, offset=1.3e12, slack=(0.4, 0.6)):
    """n root spans 40 us long every 120 us (perf_counter ns) and their
    step_call spans on a trace clock running at `rate` from `offset`, each
    `slack` us wider before and after."""
    roots = [(NS0 + i * 120_000, NS0 + i * 120_000 + 40_000) for i in range(n)]
    true = lambda t: offset + rate * (t - NS0) / 1e3  # noqa: E731
    calls = [(true(a) - slack[0], true(b) + slack[1]) for a, b in roots]
    return roots, calls, true


@pytest.mark.parametrize("rate", [1.0, 1.0 + 5e-5, 1.0 - 5e-5])
def test_map_puts_each_root_inside_its_call(rate):
    roots, calls, true = _pairs(rate=rate)
    f = ps.trace_map(roots, calls)
    assert f is not None
    for (a, b), (c0, c1) in zip(roots, calls):
        assert c0 <= f(a) and f(b) <= c1
        assert abs(f(a) - true(a)) <= 0.7
    if rate != 1.0:  # 5e-5 over the 24 ms: 1.2 us, more than the 1 us of slack
        lo = max(c0 - (a - roots[0][0]) / 1e3 for (a, _), (c0, _) in zip(roots, calls))
        hi = min(c1 - (b - roots[0][0]) / 1e3 for (_, b), (_, c1) in zip(roots, calls))
        assert hi < lo  # so no map at rate 1 would do


def test_map_recovers_the_offset_from_nested_pairs():
    """Pairs at rate 1 with the slack of each call on one side only: the
    bounds close in on the true offset from both sides."""
    roots = [(NS0 + i * 100_000, NS0 + i * 100_000 + 30_000) for i in range(50)]
    calls = [((a - NS0) / 1e3 + 500.0 - (0.5 if i % 2 else 0.0),
              (b - NS0) / 1e3 + 500.0 + (0.0 if i % 2 else 0.5)) for i, (a, b) in enumerate(roots)]
    f = ps.trace_map(roots, calls)
    assert f(NS0) == pytest.approx(500.0, abs=1e-3)


def test_map_none_on_count_mismatch():
    roots, calls, _ = _pairs()
    assert ps.trace_map(roots, calls[:-1]) is None
    assert ps.trace_map([], []) is None


def test_map_none_on_empty_intersection():
    """A root longer than its call fits no map."""
    roots, calls, _ = _pairs(n=20)
    a, b = roots[7]
    roots[7] = (a, b + 5_000)
    assert ps.trace_map(roots, calls) is None


# -- idle time inside the program's calls ----------------------------------------------

def _traced(monkeypatch, dropped=0, extra_root=False):
    """A stretch [0, 1000] us on the trace's clock; the program's two calls
    at trace 100-300 and 600-700 us (perf_counter at trace - 50 us), inside
    step_call spans 90-310 and 590-710; the card busy 0-200, 400-650 and
    900-1000: idle 200-400, 650-900 (450 us), of it 200-300 and 650-700
    inside a call (150 us): 33.3%."""
    ns = lambda us: NS0 + int(us * 1e3)  # noqa: E731
    roots = [Span("mesh.packed", ns(50), ns(250), 1, None, 1),
             Span("mesh.place", ns(50), ns(60), 2, 1, 1),
             Span("mesh.packed", ns(550), ns(650), 3, None, 2)]
    if extra_root:
        roots.append(Span("mesh.packed", ns(800), ns(810), 4, None, 3))
    _use(monkeypatch, FakeRecorder(timeline=roots, dropped=dropped))
    base = NS0 / 1e3 - 50.0
    leaves = [(base + a, b - a, "k", None) for a, b in ((0, 200), (400, 650), (900, 1000))]
    spans = [(base + 90, base + 310, "step_call"), (base + 80, base + 90, "refresh"),
             (base + 590, base + 710, "step_call")]
    return {"lo": base, "hi": base + 1000, "spans": spans, "cards": {0: leaves},
            "launch_span": {}, "batches": 2}


def test_idle_put_down_to_the_call(monkeypatch):
    read = spec.reader("idle_in_call_pct.devfed")
    assert read(_record(_traced(monkeypatch))) == pytest.approx(100.0 * 150 / 450)


def test_idle_in_call_none_without_a_map(monkeypatch):
    read = spec.reader("idle_in_call_pct.devfed")
    assert read(_record(_traced(monkeypatch, extra_root=True))) is None  # 3 roots, 2 calls
    assert read(_record(_traced(monkeypatch, dropped=1))) is None  # a truncated timeline


def test_idle_in_call_none_without_a_trace_or_a_recorder(monkeypatch):
    read = spec.reader("idle_in_call_pct.devfed")
    trace = _traced(monkeypatch)
    assert read(_record(None)) is None
    assert read(_record(trace, feed="host")) is None
    _use(monkeypatch, None)
    assert read(_record(trace)) is None


def test_overlap_and_idle_intervals():
    assert ps.overlap([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert ps.overlap([(0, 10)], []) == 0
    leaves = [(10.0, 5.0, "a", None), (12.0, 10.0, "b", None), (40.0, 5.0, "c", None)]
    assert ps.idle_intervals(leaves, 0.0, 50.0) == [(0.0, 10.0), (22.0, 40.0), (45.0, 50.0)]


# -- means of the totals, counters -------------------------------------------------------

TOTALS = {"mesh.packed": (100, 100 * 90_000, 100 * (90_000 - 12_000 - 20_000 - 13_000)),
          "mesh.fork": (100, 100 * 12_000, 100 * 12_000),
          "graphs.launch": (100, 100 * 20_000, 100 * 20_000),
          "mesh.join": (100, 100 * 13_000, 100 * 13_000),
          "graphs.capture": (1, 2_000_000_000, 500_000_000),
          "kernels.load": (3, 1_500_000_000, 100_000_000),
          "kernels.build": (3, 1_400_000_000, 1_400_000_000)}


@pytest.mark.parametrize("name,want", [
    ("prepare_us.devfed", 90.0 - 12.0 - 20.0 - 13.0),
    ("streams_us.devfed", 25.0),
    ("launch_us.devfed", 20.0),
    ("kernel_load_s", 0.1),
    ("graph_capture_s", 0.5),
])
def test_span_totals_readers(monkeypatch, name, want):
    """The dispatch parts are means per recorded call; the set-up spans are
    self times, so the load holds no build and the capture no load."""
    _use(monkeypatch, FakeRecorder(totals=TOTALS))
    assert spec.reader(name)(_record()) == pytest.approx(want)


def test_dispatch_split_adds_up_to_the_call(monkeypatch):
    """prepare + streams + launch = the mean recorded call."""
    _use(monkeypatch, FakeRecorder(totals=TOTALS))
    parts = sum(spec.reader(f"{k}_us.devfed")(_record()) for k in ("prepare", "streams", "launch"))
    assert parts == pytest.approx(90.0)


def test_dispatch_split_of_the_program_adds_up(monkeypatch):
    """The same on the program's own Recorder, from one call's stamps."""
    from gpu_video_codec_tpu_torch.utils import tracing

    rec = tracing.Recorder(every=1)
    stamps = rec.start_call()
    t0 = stamps[0]
    stamps += (t0 + 1_000, t0 + 4_000, t0 + 6_000, t0 + 9_000, t0 + 10_000)
    rec.end_call(stamps)
    _use(monkeypatch, rec)
    parts = [spec.reader(f"{k}_us.devfed")(_record()) for k in ("prepare", "streams", "launch")]
    assert parts[1:] == pytest.approx([3.0 + 1.0, 3.0])
    assert sum(parts) == pytest.approx(rec.totals()["mesh.packed"].ns / 1e3)


def test_launches_per_call(monkeypatch):
    from gpu_video_codec_tpu_torch.utils import graphs

    _use(monkeypatch, FakeRecorder(counters={"mesh.calls": 50}))
    monkeypatch.setattr(graphs, "COUNTERS", ({"luma": 50, "chroma": 50}, {"fwd": 100, "inv": 100}))
    assert spec.reader("launches_per_call.devfed")(_record()) == 6.0
    _use(monkeypatch, FakeRecorder())
    assert spec.reader("launches_per_call.devfed")(_record()) is None


NEW = ("prepare_us.devfed", "streams_us.devfed", "launch_us.devfed", "kernel_load_s",
       "graph_capture_s", "launches_per_call.devfed", "idle_in_call_pct.devfed")


@pytest.mark.parametrize("name", NEW)
def test_none_from_a_program_without_the_recorder(monkeypatch, name):
    """A program older than the recorder: every reader returns None and
    raises nothing."""
    _use(monkeypatch, None)
    assert spec.reader(name)(_record({"lo": 0.0, "hi": 1.0, "spans": [], "cards": {0: []},
                                      "launch_span": {}, "batches": 0})) is None


@pytest.mark.parametrize("name", NEW[:5])
def test_none_where_nothing_was_recorded(monkeypatch, name):
    _use(monkeypatch, FakeRecorder())
    assert spec.reader(name)(_record()) is None


def test_recorder_is_the_programs():
    from gpu_video_codec_tpu_torch.utils import tracing

    assert ps.recorder() is tracing.RECORDER
