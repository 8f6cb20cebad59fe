"""idle_pct.devfed: share of the traced stretch in which the device ran
nothing (device-fed cells; the mean over the cell's cards): 100 x (1 -
busy / stretch), where busy is the union of the card's kernels, memcpys
and memsets inside the stretch, so it lies in [0, 100].  It is the
result line's device.busy_s over device.window_s, as a share.

The profiler slows the host's calls, so where host and device are near
parity the stretch idles more than the untraced window does."""

from bench_torch.lib.trace import busy_us


def read(rec):
    t = rec.trace
    if rec.feed != "device" or t is None or not t["hi"] > t["lo"]:
        return None
    shares = [100.0 * (1.0 - busy_us(c) / (t["hi"] - t["lo"])) for c in t["cards"].values()]
    return sum(shares) / len(shares)
