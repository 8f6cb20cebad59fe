"""The comparison that decides `correct`.

Every sampled output frame is compared byte for byte with the plain
reference run on its input (references/<config's reference>.py) at the
configuration's bit_depth and chroma_format ("4:2:0" where the key is
missing).  The numbers compared, each with its limit:

  wrong_bytes     output bytes of the sampled frames that differ from the
                  reference's, the frames viewed as bytes (a 10-bit
                  sample's int16 counts 1 or 2): limit 0, since the
                  guarantee is byte-exact output (an exact comparison);
  missing_frames  frames handed to the program that never came back, for
                  a feed whose missing() counts them (the device feed's
                  step returns with its batch done in place, so it has
                  none): limit 0.

The reference runs on the card once the window has closed and the peak
memory has been read, in blocks of frames so that it fits.
"""

from __future__ import annotations

import torch

from . import spec
from .frames import packed_rows

LIMITS = {"wrong_bytes": 0, "missing_frames": 0}
_BLOCK_BYTES = 64 << 20  # input bytes the reference takes at once


def reference_of(cfg: dict):
    return spec.reference(cfg["reference"])


def wrong_bytes(samples, cfg: dict, bs: dict, device) -> tuple[int, int, int]:
    """(bytes that differ from the reference, frames compared, frames with
    a wrong byte) over the samples, each (inputs, outputs) of shape
    (n, packed rows, w) (lib/frames.packed_rows) of the bit depth's dtype
    (lib/frames.sample_dtype), numpy arrays or tensors."""
    ref = reference_of(cfg)
    w, h, qp, bd = (int(cfg[k]) for k in ("width", "height", "qp", "bit_depth"))
    cf = cfg.get("chroma_format", "4:2:0")
    rows = packed_rows(w, h, cf)
    wrong = frames = bad = 0
    for inputs, outputs in samples:
        x = torch.as_tensor(inputs).to(device).reshape(-1, rows, w)
        y = torch.as_tensor(outputs).to(device).reshape(-1, rows, w)
        per = max(1, _BLOCK_BYTES // x[0].nbytes)
        for a in range(0, x.shape[0], per):
            expect = ref.deblock_packed(x[a : a + per], w, h, qp, bs, bit_depth=bd,
                                        chroma_format=cf)
            diff = (_bytes(expect) != _bytes(y[a : a + per])).flatten(1).sum(1)
            wrong += int(diff.sum())
            bad += int((diff > 0).sum())
        frames += x.shape[0]
    return wrong, frames, bad


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """t's bytes as uint8, the last axis times the sample's size."""
    return t.contiguous().view(torch.uint8)


def decide(values: dict) -> bool:
    """True when every number compared is within its limit."""
    return all(v <= LIMITS[k] for k, v in values.items())
