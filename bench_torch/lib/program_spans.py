"""The program's own spans and counters, for the metric readers.

The port keeps them in memory (gpu_video_codec_tpu_torch.utils.tracing
.RECORDER): totals per span name of the work done outside any profiler
session (of the packed batch calls, one in RECORDER.every), a timeline of
the spans closed inside one (every call), and counters.  A
program without the recorder reads as None everywhere, so its readers
return None.

Program spans are stamped with time.perf_counter_ns, the clock of the
harness's own spans before lib/feeds.Tracer moves those onto the trace's
clock.  trace_map moves the program's root spans there too, through the
harness's step_call spans of the traced stretch: each call of the program
lies inside its step_call, one to one and in order, so each pair bounds the
map, and any map inside every bound will do.
"""

from __future__ import annotations

import numpy as np

from .trace import busy_intervals

ROOT = "mesh.packed"    # the program's span of one packed batch call
CALL = "step_call"      # the harness's span around that call
MAX_RATE_ERROR = 1e-3   # how far the Tracer's clock map may run from 1 us per us


def recorder():
    """The program's Recorder, or None where the program has none."""
    try:
        from gpu_video_codec_tpu_torch.utils import tracing
    except ImportError:
        return None
    return getattr(tracing, "RECORDER", None)


def totals() -> dict[str, tuple[int, int, int]] | None:
    """{span name: (count, ns, self ns)} of the program's unprofiled spans."""
    r = recorder()
    return None if r is None else r.totals()


def self_s(name: str) -> float | None:
    """Seconds of every unprofiled span `name`, less the spans inside them;
    None where there is none."""
    t = totals()
    if not t or name not in t:
        return None
    return t[name][2] / 1e9


def per_call_us(*names: str, own: bool = False) -> float | None:
    """The totals of the spans `names` (with own, their self times) per
    recorded unprofiled packed batch call, in us; None where no such call
    was recorded."""
    t = totals()
    if not t or ROOT not in t:
        return None
    return sum(t[k][2 if own else 1] for k in names if k in t) / t[ROOT][0] / 1e3


def trace_map(roots: list[tuple[int, int]], calls: list[tuple[float, float]]):
    """f(perf_counter ns) -> trace us, linear, that puts the i-th root span
    (start_ns, end_ns) inside the i-th call span (start_us, end_us) on the
    trace's clock, for every i; None where the counts differ or no such map
    exists.

    For a rate r, each pair bounds the offset from both sides, and the
    width of the intersection of the bounds is concave in r, so its
    largest width is found by ternary search over 1 +- MAX_RATE_ERROR (the
    Tracer's own map has a rate, from its marks).  The map is the middle
    of the intersection at that rate."""
    if not roots or len(roots) != len(calls):
        return None
    ns0 = roots[0][0]
    q = np.array([(a - ns0, b - ns0) for a, b in roots], dtype=np.float64) / 1e3
    c = np.asarray(calls, dtype=np.float64)

    def bounds(rate):
        return np.max(c[:, 0] - rate * q[:, 0]), np.min(c[:, 1] - rate * q[:, 1])

    def width(rate):
        lo, hi = bounds(rate)
        return hi - lo

    r0, r1 = 1.0 - MAX_RATE_ERROR, 1.0 + MAX_RATE_ERROR
    for _ in range(100):
        m0, m1 = r0 + (r1 - r0) / 3, r1 - (r1 - r0) / 3
        if width(m0) < width(m1):
            r0 = m0
        else:
            r1 = m1
    rate = (r0 + r1) / 2
    lo, hi = bounds(rate)
    if hi < lo:
        return None
    offset = (lo + hi) / 2
    return lambda t_ns: offset + rate * (t_ns - ns0) / 1e3


def roots_on_trace(trace: dict) -> list[tuple[float, float]] | None:
    """The program's root spans of the traced stretch on the trace's clock
    (us), in order; None where the program kept none, dropped some, or no
    map puts each inside its step_call."""
    r = recorder()
    if r is None or r.dropped:
        return None
    roots = sorted((s.start_ns, s.end_ns) for s in r.timeline()
                   if s.name == ROOT and s.parent is None)
    calls = sorted((a, b) for a, b, name in trace["spans"] if name == CALL)
    f = trace_map(roots, calls)
    return None if f is None else [(f(a), f(b)) for a, b in roots]


def idle_intervals(leaves: list, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] in which a card ran none of `leaves`."""
    out, at = [], lo
    for a, b in busy_intervals(leaves):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def overlap(xs: list[tuple[float, float]], ys: list[tuple[float, float]]) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total
