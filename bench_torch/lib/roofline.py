"""Roofline arithmetic: the least bytes the work needs, and the card's peak.

Deblocking a packed frame reads each of its samples once and writes each
once, whatever kernels implement it (a fused kernel, a relayout on either
side, several launches): 2 x (wh + 2 ch cw) samples a frame (wh + 2 ch cw
is 3wh/2 at 4:2:0, 2wh at 4:2:2 and 3wh at 4:4:4; lib/frames.chroma_plane),
of 1 byte at 8 bits and 2 (an int16) at 10.
There is no operation bound (no integer rate in the data sheet's table),
so the bound is bytes over the memory bandwidth.
"""

from __future__ import annotations

from .frames import chroma_plane

# NVIDIA H100 SXM data sheet, at the full power limit of 700 W
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def frame_bytes(width: int, height: int, sample_bytes: int = 1,
                chroma_format: str = "4:2:0") -> int:
    """Bytes of one packed frame of `sample_bytes` a sample: luma and two
    chroma planes of the format's (ch, cw)."""
    ch, cw = chroma_plane(width, height, chroma_format)
    return (width * height + 2 * ch * cw) * sample_bytes


def deblock_bytes(width: int, height: int, frames: int = 1, sample_bytes: int = 1,
                  chroma_format: str = "4:2:0") -> int:
    """Bytes the deblocking of `frames` frames must move: each read once
    and written once."""
    return 2 * frame_bytes(width, height, sample_bytes, chroma_format) * frames


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
