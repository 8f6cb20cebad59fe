"""Seeded inputs: blocky YV12 frames and flat boundary-strength arrays.

Everything is drawn from the run's seed with torch.Generator objects on
the device that holds the frames, in a few large calls, so that the same
seed gives the same inputs and set-up does not depend on the host.

Frames are packed 8-bit YV12, (3h/2, w) rows: luma, then the two chroma
planes (h/2, w/2) one after the other.  Each plane is a gradient with a
per-frame phase, a DC offset per 8x8 block and, per block, noise of
amplitude 0, 1 or 2: steps between blocks of a few levels take the strong
luma filter, larger ones the normal filter, the largest skip it.

BS arrays have the reference's flat sizes and index order (cpu.h:86-117).
"ai" is the reference's own all-intra default: every entry 2 except the
zero stripes of its initialisation.  "ra" draws every other entry from
the mix's shares of BS 0, 1 and 2.
"""

from __future__ import annotations

import numpy as np
import torch

B = 8
_MASK63 = (1 << 63) - 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one named use (`stream`) of a seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + 7919 * int(stream)) & _MASK63)
    return g


def _plane(n, h, w, dc, g, device, out):
    """Fill out (n, h, w) uint8 with blocky content."""
    y = torch.arange(h, device=device, dtype=torch.int32)[:, None]
    x = torch.arange(w, device=device, dtype=torch.int32)[None, :]
    span = 128
    phase = torch.randint(0, 64, (n, 1, 1), generator=g, device=device, dtype=torch.int32)
    offs = torch.randint(-dc, dc + 1, (n, h // B + 1, w // B + 1), generator=g, device=device,
                         dtype=torch.int32)
    amp = torch.randint(0, 3, (n, h // B + 1, w // B + 1), generator=g, device=device,
                        dtype=torch.int32)
    grad = 64 + ((x + 2 * y) * span) // (w + 2 * h)
    for f in range(n):
        blocks = (offs[f], amp[f])
        dcf, ampf = (t.repeat_interleave(B, 0)[:h].repeat_interleave(B, 1)[:, :w] for t in blocks)
        noise = torch.randint(-2, 3, (h, w), generator=g, device=device, dtype=torch.int32)
        out[f] = (grad + phase[f] + dcf + noise * ampf).clamp(0, 255).to(torch.uint8)


def frame_pool(n: int, width: int, height: int, seed: int, content: dict, device) -> torch.Tensor:
    """n packed YV12 frames (n, 3h/2, w) uint8 on `device`, from the seed."""
    w, h = width, height
    g = generator(seed, 0, device)
    pool = torch.empty((n, 3 * h // 2, w), dtype=torch.uint8, device=device)
    _plane(n, h, w, int(content["luma_dc"]), g, device, pool[:, :h])
    chroma = pool[:, h:].view(n, 2, h // 2, w // 2)
    for i in range(2):
        tmp = torch.empty((n, h // 2, w // 2), dtype=torch.uint8, device=device)
        _plane(n, h // 2, w // 2, int(content["chroma_dc"]), g, device, tmp)
        chroma[:, i] = tmp
    return pool


def bs_sizes(width: int, height: int) -> dict[str, tuple[int, int]]:
    """(size, zero stripe) of each flat BS array; sizes by the reference's
    left-to-right integer arithmetic, ((d/8 + 1) * other) / 8."""
    cw, ch = width // 2, height // 2
    return {
        "vert": ((width // B + 1) * height // B, width // B + 1),
        "hor": ((height // B + 1) * width // B, height // B + 1),
        "chroma_vert": ((cw // B + 1) * ch // B, cw // B + 1),
        "chroma_hor": ((ch // B + 1) * cw // B, ch // B + 1),
    }


def bs_arrays(width: int, height: int, mix: dict, seed: int, device) -> dict[str, np.ndarray]:
    """The four flat uint8 BS arrays of a run: mix["bs"] is "ai" or "ra"
    (with mix["bs_shares"], the shares of BS 0, 1, 2)."""
    kind = mix["bs"]
    if kind not in ("ai", "ra"):
        raise ValueError(f"bs must be 'ai' or 'ra', got {kind!r}")
    g = generator(seed, 1, device)
    out = {}
    for name, (size, stripe) in bs_sizes(width, height).items():
        if kind == "ai":
            a = torch.full((size,), 2, dtype=torch.uint8, device=device)
        else:
            p0, p1, _ = (float(s) for s in mix["bs_shares"])
            u = torch.rand(size, generator=g, device=device)
            a = ((u >= p0).to(torch.uint8) + (u >= p0 + p1).to(torch.uint8))
        a[::stripe] = 0
        out[name] = a.cpu().numpy()
    return out
