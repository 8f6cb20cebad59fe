"""The JAX package's tools/, as entry points of the port (same module names).

The kernel-variant experiments:

  int16_probe     K1-i16 (int16 compute) against K1, byte for byte
  rowslayout_exp  canonical K1 against T5 (the rows layout), timed
  swar_exp        T1 (tile pairs in 16-bit lanes): --check, --race, and
                  --ops (static SASS counts of K1 and T1, read by sass.py)

Each runs on `--device cuda` (the default) or `cpu`, prints one JSON line
and exits non-zero if a comparison fails.  Times are CUDA-event device
times; on the CPU they are null (not measured).

The host tools:

  psnr                   PSNR / max-abs-diff of two YV12 files, per frame
  validate_vs_reference  a backend (--backend cuda|torch|golden|native)
                         against the reference's C++, compiled from its
                         checkout: 8 cases, --fuzz, --fullscale

Port-only: kernel_time and step_time (device times of two checkouts) and
sass (ptxas's and cuobjdump's static counts).
"""

from __future__ import annotations

import torch


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def times_us(fns: dict, device: torch.device, iters: int = 200) -> dict:
    """Device µs per call of each named function, in turns
    (utils/timing.in_turns); None for each on the CPU (not measured)."""
    if device.type != "cuda":
        return {name: None for name in fns}
    from ..utils.timing import in_turns

    with torch.cuda.device(device):
        res = in_turns(fns, {name: iters for name in fns})
    return {name: ms * 1e3 for name, (ms, _) in res.items()}
