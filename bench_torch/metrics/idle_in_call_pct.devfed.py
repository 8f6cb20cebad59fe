"""idle_in_call_pct.devfed: the share of the traced stretch's device idle
time during which the host was inside the program's packed batch call:
the idle stretches of each card (as idle_pct.devfed reads them) against
the program's mesh.packed spans of the stretch, moved onto the trace's
clock through the harness's step_call spans (lib/program_spans); the mean
over the cell's cards.  The rest of the idle time falls in the harness's
refresh, its waits and the gaps between calls."""

from bench_torch.lib import program_spans as ps


def read(rec):
    t = rec.trace
    if rec.feed != "device" or t is None:
        return None
    calls = ps.roots_on_trace(t)
    if calls is None:
        return None
    shares = []
    for leaves in t["cards"].values():
        idle = ps.idle_intervals(leaves, t["lo"], t["hi"])
        total = sum(b - a for a, b in idle)
        if total > 0:
            shares.append(100.0 * ps.overlap(idle, calls) / total)
    return sum(shares) / len(shares) if shares else None
