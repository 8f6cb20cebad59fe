"""launches_per_call.devfed: kernel launches per packed batch call: the
program's launch counters (utils/graphs.COUNTERS, which count each graph
replay's captured launches) over its counter mesh.calls.  Both are
process totals, warm-up included.  Where K2 takes the width (both
configurations' widths), the packed step is one K2 launch: 1; the chain
it replaces launched T2 and T3 twice, K1 and K1c once: 6."""

from bench_torch.lib import program_spans as ps


def read(rec):
    r = ps.recorder()
    if rec.feed != "device" or r is None:
        return None
    calls = r.counters().get("mesh.calls", 0)
    if not calls:
        return None
    from gpu_video_codec_tpu_torch.utils.graphs import COUNTERS

    return sum(sum(c.values()) for c in COUNTERS) / calls
