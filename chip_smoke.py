#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one CUDA GPU.

    python3 chip_smoke.py

1. Builds the deblock kernel from gpu_video_codec_tpu_torch/csrc and holds
   each variant against its plain PyTorch version on the card, byte for
   byte, at the main path's grids (1080p luma and U+V chroma), a sheared
   chroma grid, tail grids and a batched luma grid, over QP {0,17,30,35,51}.
2. Runs the CLI on the three bundled frames, and StreamingDeblocker on a
   synthetic 1920x1080 frame and a sheared 360x288 frame, against the
   golden NumPy oracle.
3. Streams 16 distinct 1080p frames through StreamingDeblocker.run (the
   main path), checks each against the plain backend on the card and that
   each frame launched the luma and the chroma kernel once; then again
   with luma_only and across a mid-stream update_boundary_strength.
4. Times the kernels and their plain versions, the packed step, the copy
   and the pipelined rate with CUDA events.

Exits non-zero at the first failure.  Prints the card's name and power
limit, a JSON line of per-kernel results, and last a JSON line with
"ok": true.  Needs one CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
QPS = (0, 17, 30, 35, 51)
KERNEL_SOURCE = "gpu_video_codec_tpu_torch/csrc/deblock_kernel.cu"
TPU_KERNEL = "gpu_video_codec_tpu/ops/pallas_kernel.py:71"


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def blocky_tiles(rng, shape):
    """uint8 tile-planes of flat blocks with small steps at the edges the
    filter looks at (so strong and normal filters fire), a quarter of the
    tiles uniform noise."""
    cell = shape[:-4] + (1, 1) + shape[-2:]
    t = rng.integers(40, 216, cell) + rng.integers(-3, 4, shape)
    t[..., 4:, :, :, :] += rng.integers(-20, 21, cell)
    t = np.where(rng.random(cell) < 0.25, rng.integers(0, 256, shape), t)
    return np.clip(t, 0, 255).astype(np.uint8)


def blocky_frame(rng, w, h):
    """Packed YV12 frame: piecewise-flat 8x8 blocks with noise, so every
    filter branch runs."""
    def plane(hh, ww):
        steps = rng.integers(-14, 15, (hh // 8 + 1, ww // 8 + 1))
        means = 128 + np.cumsum(steps, axis=1) // 2 + np.cumsum(steps, axis=0) // 3
        img = np.kron(means, np.ones((8, 8), np.int64))[:hh, :ww]
        return np.clip(img + rng.integers(-2, 3, img.shape), 0, 255).astype(np.uint8)
    return np.concatenate([plane(h, w).ravel(), plane(h // 2, w // 2).ravel(),
                           plane(h // 2, w // 2).ravel()])


def device_ms(fn, iters: int) -> tuple[float, bool]:
    """Device time per call, from CUDA events around `iters` calls queued
    behind a spin kernel, so the device runs them back to back.  Returns
    (ms per call, whether the host finished queueing before the spin
    ended -- if not, the time includes host gaps)."""
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from gpu_video_codec_tpu_torch.models.golden import deblock_frame_golden
    from gpu_video_codec_tpu_torch.models.streaming import StreamingDeblocker
    from gpu_video_codec_tpu_torch.ops import cuda_kernel as ck
    from gpu_video_codec_tpu_torch.ops.deblock import deblock_tiles_plain
    from gpu_video_codec_tpu_torch.ops.tables import get_beta, get_tc
    from gpu_video_codec_tpu_torch.utils.bs import BoundaryStrength
    from gpu_video_codec_tpu_torch.utils.yuv import planes_from_yv12_bytes, yv12_bytes_from_planes

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    path, log = ck.build_library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s -> {os.path.relpath(path, REPO)}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    rng = np.random.default_rng(2026)

    # -- 1. kernel vs plain on the card ----------------------------------------
    cases = [  # (name, chroma, tiles shape, map shape)
        ("luma 1080p", False, (8, 8, 136, 241), (136, 241)),
        ("chroma U+V 1080p shared map", True, (2, 8, 8, 68, 121), (1, 68, 121)),
        ("chroma sheared 360x288 U|V stacked", True, (8, 8, 38, 23), (38, 23)),
        ("luma tail", False, (8, 8, 3, 5), (3, 5)),
        ("chroma tail", True, (8, 8, 3, 5), (3, 5)),
        ("luma batched per-frame maps", False, (3, 8, 8, 136, 241), (3, 136, 241)),
    ]
    err = {False: 0, True: 0}
    for name, chroma, shape, mshape in cases:
        for qp in QPS:
            tiles = torch.from_numpy(blocky_tiles(rng, shape)).to(dev)
            maps = [torch.from_numpy(rng.integers(0, 3, mshape, dtype=np.uint8)).to(dev)
                    for _ in range(4)]
            beta, tc = get_beta(qp), get_tc(qp)
            out = ck.deblock_tiles_cuda(tiles, *maps, beta, tc, chroma=chroma)
            ref = deblock_tiles_plain(tiles, *maps, beta, tc, chroma=chroma)
            torch.cuda.synchronize()
            diff = int((out.int() - ref.int()).abs().max())
            err[chroma] = max(err[chroma], diff)
            check(diff == 0, f"kernel vs plain: {name} qp {qp} max |diff| {diff}")
        print(f"kernel == plain: {name} {shape}, QP {list(QPS)}")

    # -- 2. golden -----------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        for name, w, h in (("image1_352x288_yv12.yuv", 352, 288),
                           ("mother-daughter_352x288_yv12.yuv", 352, 288),
                           ("image2_768x576.yuv", 768, 576)):
            src = os.path.join(REPO, "testdata", name)
            dst = os.path.join(tmp, name)
            res = subprocess.run(
                [sys.executable, "-m", "gpu_video_codec_tpu_torch.cli", "-i", src,
                 "-W", str(w), "-H", str(h), "--qp", "35", "-o", dst],
                cwd=REPO, capture_output=True, text=True, timeout=300)
            check(res.returncode == 0, f"CLI on {name}: {res.stderr[-2000:]}")
            with open(src, "rb") as f:
                raw = f.read()
            gold = deblock_frame_golden(planes_from_yv12_bytes(raw, w, h),
                                        BoundaryStrength.intra_default(w, h), 35)
            with open(dst, "rb") as f:
                check(f.read() == yv12_bytes_from_planes(gold), f"CLI output of {name} != golden")
            print(f"CLI == golden: {name} ({json.loads(res.stdout)['device']})")
    for w, h in ((1920, 1080), (360, 288)):
        raw = blocky_frame(rng, w, h)
        (out,) = list(StreamingDeblocker(w, h, 35, device=dev).run([raw]))
        t0 = time.perf_counter()
        gold = deblock_frame_golden(planes_from_yv12_bytes(raw, w, h),
                                    BoundaryStrength.intra_default(w, h), 35)
        check(out.tobytes() == yv12_bytes_from_planes(gold), f"StreamingDeblocker {w}x{h} != golden")
        check(not np.array_equal(out, raw), f"{w}x{h}: the filter changed nothing")
        print(f"StreamingDeblocker == golden: {w}x{h} "
              f"({int((out != raw).sum())} bytes changed; golden {time.perf_counter() - t0:.1f} s)")

    # -- 3. the main path: a 1080p stream ----------------------------------------
    w, h, n = 1920, 1080, 16
    frames = [blocky_frame(rng, w, h) if i % 2 else rng.integers(0, 256, 3 * w * h // 2,
                                                                 dtype=np.uint8)
              for i in range(n)]
    s = StreamingDeblocker(w, h, 35, depth=2, device=dev)
    ck.LAUNCHES.update(luma=0, chroma=0)
    outs = list(s.run(frames))
    launches = dict(ck.LAUNCHES)
    check(launches == {"luma": n, "chroma": n}, f"launches {launches}, want {n} each")
    plain = StreamingDeblocker(w, h, 35, backend="torch", depth=2, device=dev)
    refs = list(plain.run(frames))
    check(len(outs) == n and all(np.array_equal(o, r) for o, r in zip(outs, refs)),
          "1080p stream != plain backend")
    check(all(not np.array_equal(o, f) for o, f in zip(outs, frames)), "a frame was unchanged")
    print(f"stream: {n} x 1080p == plain backend; launches {launches}")

    s_luma = StreamingDeblocker(w, h, 35, luma_only=True, device=dev)
    ck.LAUNCHES.update(luma=0, chroma=0)
    outs_l = list(s_luma.run(frames))
    check(dict(ck.LAUNCHES) == {"luma": n, "chroma": 0}, f"luma_only launches {ck.LAUNCHES}")
    refs_l = StreamingDeblocker(w, h, 35, backend="torch", luma_only=True, device=dev).run(frames)
    check(all(np.array_equal(o, r) for o, r in zip(outs_l, refs_l)), "luma_only != plain")
    check(all(np.array_equal(o[w * h:], f[w * h:]) for o, f in zip(outs_l, frames)),
          "luma_only touched chroma")
    print(f"stream luma_only: {n} x 1080p == plain backend, chroma untouched")

    bs = BoundaryStrength.intra_default(w, h)
    bs.set_luma(rng.integers(0, 3, bs.vert.size, dtype=np.uint8),
                rng.integers(0, 3, bs.hor.size, dtype=np.uint8))
    bs.set_chroma(rng.integers(0, 3, bs.chroma_vert.size, dtype=np.uint8),
                  rng.integers(0, 3, bs.chroma_hor.size, dtype=np.uint8))
    half = n // 2

    def swapped(sd):
        got = list(sd.run(frames[:half]))
        sd.update_boundary_strength(bs)
        return got + list(sd.run(frames[half:]))

    outs_b = swapped(StreamingDeblocker(w, h, 35, device=dev))
    refs_b = swapped(StreamingDeblocker(w, h, 35, backend="torch", device=dev))
    check(all(np.array_equal(o, r) for o, r in zip(outs_b, refs_b)), "BS swap != plain")
    check(all(np.array_equal(o, r) for o, r in zip(outs_b[:half], outs[:half])),
          "frames before the BS swap changed")
    check(not any(np.array_equal(o, r) for o, r in zip(outs_b[half:], outs[half:])),
          "the BS swap changed nothing")
    print(f"stream with mid-stream BS swap: {n} x 1080p == plain backend")

    # -- 4. times --------------------------------------------------------------
    kernels = []
    for name, chroma, shape, mshape, variant in (
            ("K1 luma deblock", False, (8, 8, 136, 241), (136, 241), "luma"),
            ("K1c chroma deblock", True, (2, 8, 8, 68, 121), (1, 68, 121), "chroma")):
        tiles = torch.from_numpy(blocky_tiles(rng, shape)).to(dev)
        maps = [torch.from_numpy(rng.integers(0, 3, mshape, dtype=np.uint8)).to(dev)
                for _ in range(4)]
        beta, tc = get_beta(35), get_tc(35)
        # in turns: plain, kernel, kernel, plain
        runs = {"plain": [], "kernel": []}
        for which, iters in (("plain", 5), ("kernel", 200), ("kernel", 200), ("plain", 5)):
            fn = ck.deblock_tiles_cuda if which == "kernel" else deblock_tiles_plain
            runs[which].append(device_ms(lambda: fn(tiles, *maps, beta, tc, chroma=chroma),
                                         iters))
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
            "launches": launches[variant], "max_abs_err": err[chroma],
            "ms": min(ms for ms, _ in runs["kernel"]),
            "plain_ms": min(ms for ms, _ in runs["plain"]),
        })
        print(f"{name} {shape}: " + "; ".join(
            f"{which} " + " / ".join(f"{ms * 1e3:.2f} us (queued ahead: {ok})" for ms, ok in r)
            for which, r in runs.items()) + f" (device time; {smi})")

    raw = frames[1]
    buf = s._put(raw)
    step_ms, bound = device_ms(lambda: s._step(buf), 50)
    print(f"packed _step 1080p: {step_ms * 1e3:.1f} us/frame device time "
          f"(host queued ahead: {bound}; {smi})")
    tb = s.time_breakdown(raw, n=50)
    print("time_breakdown 1080p: " + ", ".join(f"{k[:-2]} {v * 1e6:.1f} us"
                                              for k, v in tb.items()) + f" ({smi})")
    for rb in (False, True):
        tp = s.throughput(raw, n_frames=100, readback=rb, repeats=3)
        print(f"throughput 1080p readback={rb}: {tp['fps']:.1f} fps, "
              f"{tp['per_frame_s'] * 1e6:.1f} us/frame ({smi})")

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
