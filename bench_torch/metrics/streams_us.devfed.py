"""streams_us.devfed: the slot's device and stream switches of one packed
batch call, in us: the program's spans mesh.fork (the slot's device made
current, its stream ordered after the caller's) and mesh.join (the
caller's stream ordered after the slot's, both restored), the mean per
recorded unprofiled call."""

from bench_torch.lib import program_spans as ps


def read(rec):
    if rec.feed != "device":
        return None
    return ps.per_call_us("mesh.fork", "mesh.join")
