"""step_roofline_pct.devfed: the packed batch step's share of the card's
bandwidth bound.  Bytes: each frame of the batch read once and written
once at its bytes a sample (lib/roofline.deblock_bytes; 1 at 8 bits, 2 at
10) and its chroma format's samples (3wh/2 at 4:2:0, 2wh at 4:2:2, 3wh at
4:4:4), whatever kernels do the work.  Time:
the device time per batch of everything the traced window ran except what
the harness launched itself (the refresh and the sample copies)."""

from bench_torch.lib import roofline

_HARNESS = ("refresh", "capture")


def read(rec):
    t = rec.trace
    if rec.feed != "device" or t is None or not t["batches"]:
        return None
    spans = t["launch_span"]
    us = sum(e[1] for c in t["cards"].values() for e in c if spans.get(e[3]) not in _HARNESS)
    if us <= 0:
        return None
    seconds = us / 1e6 / t["batches"]
    moved = roofline.deblock_bytes(rec.width, rec.height, rec.per_batch, rec.sample_bytes,
                                   rec.chroma_format)
    return roofline.roofline_pct(moved, seconds, rec.kind)
