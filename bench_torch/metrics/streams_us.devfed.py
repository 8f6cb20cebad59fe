"""streams_us.devfed: the slot's device switch of one packed batch call,
in us: the program's spans mesh.fork (the slot's device made current) and
mesh.join (the caller's device restored), the mean per recorded
unprofiled call.  The replay runs on the caller's current stream of the
slot's device, so neither span orders one stream after another."""

from bench_torch.lib import program_spans as ps


def read(rec):
    if rec.feed != "device":
        return None
    return ps.per_call_us("mesh.fork", "mesh.join")
