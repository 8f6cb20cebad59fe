"""Seeded inputs: blocky packed YUV frames and flat boundary-strength arrays.

Everything is drawn from the run's seed with torch.Generator objects on
the device that holds the frames, in a few large calls, so that the same
seed gives the same inputs and set-up does not depend on the host.

Frames are packed planar YUV, (packed_rows, w): luma, then the two chroma
planes (ch, cw) one after the other, their size set by the configuration's
chroma_format (chroma_plane): (h/2, w/2) at 4:2:0, packed YV12, 3h/2 rows;
(h, w/2) at 4:2:2 and (h, w) at 4:4:4 (HEVC's format range extensions),
2h and 3h rows.  At a bit depth of 8 (HEVC Main, Main 4:4:4) a sample is
one uint8; at 10 (Main 10, Main 4:2:2 10, Main 4:4:4 10) one int16 in
[0, 1023], each row the little-endian 16-bit words of a yuv420p10le
(yuv422p10le, yuv444p10le) plane.  Chroma is drawn by the same generator
calls in the same order at every format, so a pool's luma is the same
whatever its chroma_format.  Each plane is a
gradient with a per-frame phase, a DC offset per 8x8 block and, per
block, noise: steps between blocks of a few levels take the strong luma
filter, larger ones the normal filter, the largest skip it.  The gradient
and the phase scale by 2^(bit_depth - 8); the DC offsets reach up to the
configuration's luma_dc (chroma_dc) in its own sample scale.  Noise is an
amplitude A a block, 0, 1 or 2 levels at 8 bits and 0, 4 or 8 at 10, times
a draw of -2..2 a sample; at 10 bits a noisy block's samples also draw
-2..2 levels each, so noise is not a multiple of 4 and the two low bits
carry content of their own (the filter's on, strong and normal shares
stay near the 8-bit ones).

BS arrays have the reference's flat sizes and index order (cpu.h:86-117),
the chroma arrays taken at the chroma plane's (ch, cw).
"ai" is the reference's own all-intra default: every entry 2 except the
zero stripes of its initialisation.  "ra" draws every other entry from
the mix's shares of BS 0, 1 and 2.
"""

from __future__ import annotations

import numpy as np
import torch

B = 8
_MASK63 = (1 << 63) - 1
# chroma_format -> (SubWidthC, SubHeightC), H.265 Table 6-1
CHROMA_SUBSAMPLING = {"4:2:0": (2, 2), "4:2:2": (2, 1), "4:4:4": (1, 1)}


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one named use (`stream`) of a seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + 7919 * int(stream)) & _MASK63)
    return g


def sample_dtype(bit_depth: int) -> torch.dtype:
    """A sample's dtype: uint8 at 8 bits, int16 at 10 (Main and Main 10)."""
    if bit_depth == 8:
        return torch.uint8
    if bit_depth == 10:
        return torch.int16
    raise ValueError(f"bit_depth must be 8 or 10 (HEVC Main, Main 10), got {bit_depth!r}")


def chroma_plane(width: int, height: int, chroma_format: str = "4:2:0") -> tuple[int, int]:
    """(ch, cw), one chroma plane's rows and columns: (h/2, w/2) at 4:2:0,
    (h, w/2) at 4:2:2, (h, w) at 4:4:4; ValueError at any other format."""
    if chroma_format not in CHROMA_SUBSAMPLING:
        raise ValueError(f"chroma_format must be one of {sorted(CHROMA_SUBSAMPLING)}, "
                         f"got {chroma_format!r}")
    sub_w, sub_h = CHROMA_SUBSAMPLING[chroma_format]
    return height // sub_h, width // sub_w


def packed_rows(width: int, height: int, chroma_format: str = "4:2:0") -> int:
    """Rows of w samples a packed frame holds: h + 2 ch cw / w (3h/2 at
    4:2:0, 2h at 4:2:2, 3h at 4:4:4)."""
    ch, cw = chroma_plane(width, height, chroma_format)
    return height + 2 * ch * cw // width


def _plane(n, h, w, dc, g, device, out, bit_depth):
    """Fill out (n, h, w) with blocky content at `bit_depth`."""
    s = 1 << (bit_depth - 8)
    y = torch.arange(h, device=device, dtype=torch.int32)[:, None]
    x = torch.arange(w, device=device, dtype=torch.int32)[None, :]
    span = 128 * s
    phase = torch.randint(0, 64 * s, (n, 1, 1), generator=g, device=device, dtype=torch.int32)
    offs = torch.randint(-dc, dc + 1, (n, h // B + 1, w // B + 1), generator=g, device=device,
                         dtype=torch.int32)
    amp = torch.randint(0, 3, (n, h // B + 1, w // B + 1), generator=g, device=device,
                        dtype=torch.int32)
    grad = 64 * s + ((x + 2 * y) * span) // (w + 2 * h)
    for f in range(n):
        blocks = (offs[f], amp[f])
        dcf, ampf = (t.repeat_interleave(B, 0)[:h].repeat_interleave(B, 1)[:, :w] for t in blocks)
        noise = torch.randint(-2, 3, (h, w), generator=g, device=device, dtype=torch.int32)
        noise = noise * (s * ampf)
        if bit_depth > 8:
            low = torch.randint(-2, 3, (h, w), generator=g, device=device, dtype=torch.int32)
            noise += low * (ampf > 0)
        out[f] = (grad + phase[f] + dcf + noise).clamp(0, (1 << bit_depth) - 1).to(out.dtype)


def frame_pool(n: int, width: int, height: int, seed: int, content: dict, device,
               bit_depth: int = 8, chroma_format: str = "4:2:0") -> torch.Tensor:
    """n packed frames (n, packed_rows, w) on `device`, from the seed: uint8
    at bit_depth 8, int16 at 10; chroma planes (ch, cw) by chroma_format;
    ValueError at any other bit depth or format."""
    w, h = width, height
    dtype = sample_dtype(bit_depth)
    ch, cw = chroma_plane(w, h, chroma_format)
    g = generator(seed, 0, device)
    pool = torch.empty((n, packed_rows(w, h, chroma_format), w), dtype=dtype, device=device)
    _plane(n, h, w, int(content["luma_dc"]), g, device, pool[:, :h], bit_depth)
    chroma = pool[:, h:].view(n, 2, ch, cw)
    for i in range(2):
        tmp = torch.empty((n, ch, cw), dtype=dtype, device=device)
        _plane(n, ch, cw, int(content["chroma_dc"]), g, device, tmp, bit_depth)
        chroma[:, i] = tmp
    return pool


def bs_sizes(width: int, height: int,
             chroma_format: str = "4:2:0") -> dict[str, tuple[int, int]]:
    """(size, zero stripe) of each flat BS array; sizes by the reference's
    left-to-right integer arithmetic, ((d/8 + 1) * other) / 8, the chroma
    arrays' at the chroma plane's (ch, cw)."""
    ch, cw = chroma_plane(width, height, chroma_format)
    return {
        "vert": ((width // B + 1) * height // B, width // B + 1),
        "hor": ((height // B + 1) * width // B, height // B + 1),
        "chroma_vert": ((cw // B + 1) * ch // B, cw // B + 1),
        "chroma_hor": ((ch // B + 1) * cw // B, ch // B + 1),
    }


def bs_arrays(width: int, height: int, mix: dict, seed: int, device,
              chroma_format: str = "4:2:0") -> dict[str, np.ndarray]:
    """The four flat uint8 BS arrays of a run: mix["bs"] is "ai" or "ra"
    (with mix["bs_shares"], the shares of BS 0, 1, 2)."""
    kind = mix["bs"]
    if kind not in ("ai", "ra"):
        raise ValueError(f"bs must be 'ai' or 'ra', got {kind!r}")
    g = generator(seed, 1, device)
    out = {}
    for name, (size, stripe) in bs_sizes(width, height, chroma_format).items():
        if kind == "ai":
            a = torch.full((size,), 2, dtype=torch.uint8, device=device)
        else:
            p0, p1, _ = (float(s) for s in mix["bs_shares"])
            u = torch.rand(size, generator=g, device=device)
            a = ((u >= p0).to(torch.uint8) + (u >= p0 + p1).to(torch.uint8))
        a[::stripe] = 0
        out[name] = a.cpu().numpy()
    return out
