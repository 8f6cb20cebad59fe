"""Device time of queued work on a CUDA device, from CUDA events."""

from __future__ import annotations

import time

import torch


def device_ms(fn, iters: int) -> tuple[float, bool]:
    """Device time per call of `fn`, from CUDA events around `iters` calls
    queued behind a spin kernel, so the device runs them back to back.

    Returns (ms per call, whether the host finished queueing before the
    spin ended -- if not, the time includes host gaps).  Runs on the
    current CUDA device and stream; `fn` must only queue device work."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    enqueue_s = time.perf_counter() - t0
    spin0 = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin0.record()
    torch.cuda._sleep(int(enqueue_s * 8e9) + 2_000_000)  # >= 4x the enqueue time
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    queued_s = time.perf_counter() - t0
    end.record()
    end.synchronize()
    spin_s = spin0.elapsed_time(start) / 1e3
    return start.elapsed_time(end) / iters, queued_s < spin_s


def in_turns(fns: dict, iters: dict) -> dict:
    """Device ms per call of each named function, measured in turns
    (first, second, ..., ..., second, first), best of the two runs each,
    with whether every run was queued ahead of the device."""
    order = list(fns) + list(fns)[::-1]
    runs = {name: [] for name in fns}
    for name in order:
        runs[name].append(device_ms(fns[name], iters[name]))
    return {name: (min(ms for ms, _ in r), all(ok for _, ok in r)) for name, r in runs.items()}
