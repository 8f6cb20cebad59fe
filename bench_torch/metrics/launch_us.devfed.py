"""launch_us.devfed: the CUDA graph launch of one packed batch call, in
us: the program's span graphs.launch (the graph's replay() alone), the
mean per recorded unprofiled call."""

from bench_torch.lib import program_spans as ps


def read(rec):
    if rec.feed != "device":
        return None
    return ps.per_call_us("graphs.launch")
