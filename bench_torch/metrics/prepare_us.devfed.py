"""prepare_us.devfed: the program's own Python in one packed batch call
(checks, frame sharding, views, BS maps, the graph's key and lookup, the
launch counters), in us: the self time of the program's span mesh.packed
(the call less its mesh.fork, graphs.launch and mesh.join), the mean over
the recorded unprofiled calls.  A call that captured a graph or loaded a
library is set-up, and not recorded.  prepare_us, streams_us and
launch_us add up to the mean recorded call."""

from bench_torch.lib import program_spans as ps


def read(rec):
    if rec.feed != "device":
        return None
    return ps.per_call_us("mesh.packed", own=True)
