"""tiles_per_us.devfed: the packed step's kernel's work rate, in tiles (the
quad's shifted 8x8 tiles, luma, U and V) per device us.  Tiles: the
program's counters packed.luma_tiles and packed.chroma_tiles (every tile
of every frame that its packed batch calls handed to the step) over its
counter mesh.calls, so a batch's tiles; all three are process totals,
warm-up included, and every call of a cell has the same frames.  Time: the
device time per batch of the traced window's events whose name holds
deblock_packed_kernel (K2, K2-10).  Comparable across bit depths and
chroma formats, where a bytes roofline is not: it says whether a change
moved the quad or only the bytes.  None where the program keeps no such
counters or the trace holds no such kernel."""

from bench_torch.lib import program_spans as ps

KERNEL = "deblock_packed_kernel"


def read(rec):
    t, r = rec.trace, ps.recorder()
    if rec.feed != "device" or t is None or not t["batches"] or r is None:
        return None
    counted = r.counters()
    calls = counted.get("mesh.calls", 0)
    tiles = counted.get("packed.luma_tiles", 0) + counted.get("packed.chroma_tiles", 0)
    us = sum(e[1] for c in t["cards"].values() for e in c if KERNEL in e[2])
    if not calls or not tiles or us <= 0:
        return None
    return tiles / calls / (us / t["batches"])
