"""The kernel-variant experiments of the JAX package's tools/, as entry points
of the port (same module names):

  int16_probe     K1-i16 (int16 compute) against K1, byte for byte
  rowslayout_exp  canonical K1 against T5 (the rows layout), timed
  swar_exp        T1 (tile pairs in 16-bit lanes): --check, --race

Each runs on `--device cuda` (the default) or `cpu`, prints one JSON line
and exits non-zero if a comparison fails.  Times are CUDA-event device
times; on the CPU they are null (not measured).
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
