"""Roofline arithmetic: the least bytes the work needs, and the card's peak.

Deblocking a packed 8-bit YV12 frame reads each of its 3wh/2 bytes once
and writes each once, whatever kernels implement it (a fused kernel, a
relayout on either side, several launches): 2 x 3wh/2 bytes a frame.
There is no operation bound (no integer rate in the data sheet's table),
so the bound is bytes over the memory bandwidth.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, at the full power limit of 700 W
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def frame_bytes(width: int, height: int) -> int:
    """Bytes of one packed 8-bit 4:2:0 frame."""
    return 3 * width * height // 2


def deblock_bytes(width: int, height: int, frames: int = 1) -> int:
    """Bytes the deblocking of `frames` frames must move: each read once
    and written once."""
    return 2 * frame_bytes(width, height) * frames


def hbm_bytes_per_s(kind: str) -> float | None:
    """The card's peak memory bandwidth, or None for a card not in PEAKS."""
    peak = PEAKS.get(kind)
    return peak["hbm_bytes_per_s"] if peak else None


def roofline_pct(bytes_moved: float, seconds: float, kind: str) -> float | None:
    """Share of the card's bandwidth bound, (bytes / peak) / time, in %;
    None where the card's peak or the time is unknown."""
    peak = hbm_bytes_per_s(kind)
    if peak is None or not seconds > 0:
        return None
    return 100.0 * bytes_moved / peak / seconds
