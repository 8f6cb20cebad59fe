#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one CUDA GPU.

    python3 chip_smoke.py

0. Builds the kernels from gpu_video_codec_tpu_torch/csrc, one nvcc per
   library, both started together.
1. Holds each variant of the deblock kernel against its plain PyTorch
   version on the card, byte for byte, at the main path's grids (1080p luma
   and U+V chroma), a sheared chroma grid, tail grids and a batched luma
   grid, over QP {0,17,30,35,51}.
1b. Holds the relayout kernels T2 (plane -> tile-planes) and T3 (the
   inverse) and the pack kernel T4 against their plain versions, byte for
   byte: 1080p luma and U+V, the sheared 360x288 chroma core, a tail grid,
   a batch of four 1080p frames; T4 at 1080p and 360x288.
2. Runs the CLI on the three bundled frames, and StreamingDeblocker on a
   synthetic 1920x1080 frame and a sheared 360x288 frame, against the
   golden NumPy oracle.
3. Streams 16 distinct 1080p frames through StreamingDeblocker.run (the
   main path), checks each against the plain backend on the card and that
   each frame launched the luma and the chroma kernel once; then again
   with luma_only and across a mid-stream update_boundary_strength.
3b. The device-resident path (ResidentDeblocker): == golden at 1920x1080
   and 360x288; a batch of four distinct 1080p frames through ingest, three
   steps and readback == the plain backend, with exactly 2 T2, 3 K1, 3 K1c,
   2 T3 and 1 T4 launches; luma_only (no K1c, chroma untouched); a BS
   update between steps.
4. Times the kernels and their plain versions, the packed step, the copy
   and the pipelined rate with CUDA events.
4b. Times T2, T3 and T4 at the 1080p shapes beside their plain versions
   and a one-call PyTorch yardstick, and the resident step, ingest and
   readback at 1080p, batch 1 and 4.
4c. Lists the device kernels by name and time (torch.profiler) for the
   resident path and the streaming packed step at 1080p.

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
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
QPS = (0, 17, 30, 35, 51)
KERNEL_SOURCE = "gpu_video_codec_tpu_torch/csrc/deblock_kernel.cu"
TPU_KERNEL = "gpu_video_codec_tpu/ops/pallas_kernel.py:71"
RELAYOUT_SOURCE = "gpu_video_codec_tpu_torch/csrc/relayout_kernel.cu"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak bandwidth


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


def bytes_bound_ms(nbytes: int) -> float:
    """The least time to move `nbytes` (each input read once, each output
    written once) at the card's memory rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def in_turns(fns: dict, iters: dict) -> dict:
    """Device ms per call of each named function, measured in turns
    (first, second, ..., ..., second, first), best of the two runs each,
    with whether every run was queued ahead of the device."""
    from gpu_video_codec_tpu_torch.utils.timing import device_ms

    order = list(fns) + list(fns)[::-1]
    runs = {name: [] for name in fns}
    for name in order:
        runs[name].append(device_ms(fns[name], iters[name]))
    return {name: (min(ms for ms, _ in r), all(ok for _, ok in r)) for name, r in runs.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from gpu_video_codec_tpu_torch.models.golden import deblock_frame_golden
    from gpu_video_codec_tpu_torch.models.resident import ResidentDeblocker, _readback
    from gpu_video_codec_tpu_torch.models.streaming import StreamingDeblocker
    from gpu_video_codec_tpu_torch.ops import cuda_kernel as ck
    from gpu_video_codec_tpu_torch.ops import relayout_kernel as rk
    from gpu_video_codec_tpu_torch.ops.deblock import deblock_tiles_plain
    from gpu_video_codec_tpu_torch.ops.tables import get_beta, get_tc
    from gpu_video_codec_tpu_torch.utils.bs import BoundaryStrength
    from gpu_video_codec_tpu_torch.utils.tiles import split_covered_data
    from gpu_video_codec_tpu_torch.utils.timing import device_ms
    from gpu_video_codec_tpu_torch.utils.yuv import planes_from_yv12_bytes, yv12_bytes_from_planes

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # one nvcc per library, started together
        builds = list(pool.map(lambda build: build(), (ck.build_library, rk.build_library)))
    print(f"kernel build (both libraries): {time.perf_counter() - t0:.1f} s")
    for path, log in builds:
        print(f"  -> {os.path.relpath(path, REPO)}")
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

    # -- 1b. relayout and pack kernels vs plain on the card ------------------------
    rerr = {"fwd": 0, "inv": 0, "pack": 0}

    def same(what: str, kind: str, got, ref) -> None:
        torch.cuda.synchronize()
        check(got.shape == ref.shape, f"{kind}: {what} shape {tuple(got.shape)} != "
                                      f"{tuple(ref.shape)}")
        diff = int((got.int() - ref.int()).abs().max()) if got.numel() else 0
        rerr[kind] = max(rerr[kind], diff)
        check(diff == 0, f"{kind} kernel vs plain: {what} max |diff| {diff}")

    w, h = 1920, 1080
    frames4 = torch.from_numpy(np.stack([blocky_frame(rng, w, h) for _ in range(4)])).to(dev)
    y4 = frames4[:, : w * h].reshape(4, h, w)  # batch stride 3wh/2: the packed buffer's
    uv1 = frames4[0, w * h :].reshape(2, h // 2, w // 2)
    cif = torch.from_numpy(blocky_frame(rng, 360, 288)).to(dev)
    sheared_core, _ = split_covered_data(
        torch.nn.functional.pad(cif[360 * 288 :].reshape(2, 144, 180), (4, 4, 4, 4)))
    tail = torch.from_numpy(rng.integers(0, 256, (16, 32), dtype=np.uint8)).to(dev)
    for what, x, pad, grid in (
            ("1080p luma", y4[0], 4, (None, None)),
            ("1080p U+V", uv1, 4, (None, None)),
            ("sheared 360x288 chroma core U+V", sheared_core, 0, (None, None)),
            ("tail grid 3x5", tail, 4, (None, None)),
            ("tail grid padded to 5x8", tail, 4, (5, 8)),
            ("1080p luma, batch of 4 in packed frames", y4, 4, (None, None))):
        hh, ww = x.shape[-2:]
        t = rk.plane_to_tiles_cuda(x, pad, by_grid=grid[0], bx_grid=grid[1])
        same(what, "fwd", t, rk.plane_to_tiles_plain(x, pad, *grid))
        rnd = torch.randint(0, 256, t.shape, dtype=torch.uint8, device=dev)
        for tiles in (t, rnd):
            same(what, "inv", rk.tiles_to_plane_cuda(tiles, pad, hh, ww),
                 rk.tiles_to_plane_plain(tiles, pad, hh, ww))
        if x.dim() == 3 and x.shape[0] == 2:  # U and V land as (8, 8, 2, cBy, cBx)
            stacked = torch.zeros((8, 8, 2, *t.shape[-2:]), dtype=torch.uint8, device=dev)
            rk.plane_to_tiles_cuda(x, pad, out=stacked.movedim(2, 0))
            same(what + " into the U-over-V stack", "fwd", stacked.movedim(2, 0), t)
            same(what + " from the U-over-V stack", "inv",
                 rk.tiles_to_plane_cuda(stacked.movedim(2, 0), pad, hh, ww), x)
        print(f"T2/T3 == plain: {what} {tuple(x.shape)} -> {tuple(t.shape)}")
    for what, buf, ww, hh in (("1080p", frames4[0], 1920, 1080), ("360x288", cif, 360, 288),
                              ("1080p batch of 4", frames4, 1920, 1080)):
        yn, cn = ww * hh, ww * hh // 4
        planes = (buf[..., :yn], buf[..., yn : yn + cn], buf[..., yn + cn :])
        packed = rk.pack_yv12_cuda(*planes)
        same(what, "pack", packed, rk.pack_yv12_plain(*planes))
        same(what + " (round trip)", "pack", packed, buf)
        print(f"T4 == plain: {what} -> {tuple(packed.shape)}")

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

    # -- 3b. the resident path ------------------------------------------------------
    def counts() -> dict:
        return {"T2": rk.LAUNCHES["fwd"], "K1": ck.LAUNCHES["luma"],
                "K1c": ck.LAUNCHES["chroma"], "T3": rk.LAUNCHES["inv"],
                "T4": rk.LAUNCHES["pack"]}

    def reset() -> None:
        ck.LAUNCHES.update(luma=0, chroma=0)
        rk.LAUNCHES.update(fwd=0, inv=0, pack=0)

    for ww, hh in ((1920, 1080), (360, 288)):
        raw = blocky_frame(rng, ww, hh)
        out = ResidentDeblocker(ww, hh, 35, device=dev)(raw)
        gold = deblock_frame_golden(planes_from_yv12_bytes(raw, ww, hh),
                                    BoundaryStrength.intra_default(ww, hh), 35)
        check(out.tobytes() == yv12_bytes_from_planes(gold), f"ResidentDeblocker {ww}x{hh} != golden")
        check(not np.array_equal(out, raw), f"resident {ww}x{hh}: the filter changed nothing")
        print(f"ResidentDeblocker == golden: {ww}x{hh} ({int((out != raw).sum())} bytes changed)")

    nb, steps = 4, 3
    batch = np.stack(frames[:nb])  # distinct frames: noise and blocky

    def resident(backend: str, luma_only: bool = False, swap=None):
        rd = ResidentDeblocker(w, h, 35, backend=backend, luma_only=luma_only, device=dev)
        st = rd.step(rd.ingest(batch))
        if swap is not None:
            rd.update_boundary_strength(swap)
        return rd.readback(rd.run_steps(st, steps - 1))

    reset()
    outs_r = resident("cuda")
    res_launches = counts()
    want = {"T2": 2, "K1": steps, "K1c": steps, "T3": 2, "T4": 1}
    check(res_launches == want, f"resident launches {res_launches}, want {want}")
    check(np.array_equal(outs_r, resident("torch")), "resident 1080p batch != plain backend")
    check(all(not np.array_equal(o, f) for o, f in zip(outs_r, batch)), "a frame was unchanged")
    print(f"resident: batch of {nb} x 1080p, ingest + {steps} steps + readback == plain "
          f"backend; launches {res_launches}")
    reset()
    outs_rl = resident("cuda", luma_only=True)
    want_l = {**want, "K1c": 0}
    check(counts() == want_l, f"resident luma_only launches {counts()}, want {want_l}")
    check(np.array_equal(outs_rl, resident("torch", luma_only=True)), "resident luma_only != plain")
    check(np.array_equal(outs_rl[:, w * h :], batch[:, w * h :]), "resident luma_only touched chroma")
    print(f"resident luma_only: batch of {nb} x 1080p == plain backend, chroma untouched")
    outs_rb = resident("cuda", swap=bs)
    check(np.array_equal(outs_rb, resident("torch", swap=bs)), "resident BS update != plain")
    check(not np.array_equal(outs_rb, outs_r), "the resident BS update changed nothing")
    print(f"resident with a BS update after step 1: batch of {nb} x 1080p == plain backend")

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
        by_path = {"stream": launches[variant], "resident": res_launches[name.split()[0]]}
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": err[chroma],
            "ms": min(ms for ms, _ in runs["kernel"]),
            "plain_ms": min(ms for ms, _ in runs["plain"]),
            # tiles read and written once, four BS maps read once
            "bound_ms": bytes_bound_ms(2 * tiles.numel() + 4 * maps[0].numel()),
            "bound_by": "bytes", "library_ms": None,
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

    # -- 4b. relayout, pack and resident times -----------------------------------
    p = 4
    y1 = y4[0]
    t_y = rk.plane_to_tiles_cuda(y1, p)
    by, bx = t_y.shape[-2:]
    y_ext = torch.nn.functional.pad(y1, (p, p, p, p))
    uv_stack = torch.empty((8, 8, 2, 68, 121), dtype=torch.uint8, device=dev)
    uv_view = uv_stack.movedim(2, 0)  # the resident ingest's destination
    rk.plane_to_tiles_cuda(uv1, p, out=uv_view)
    uv_ext = torch.nn.functional.pad(uv1, (p, p, p, p))[:, : 8 * 68]  # covered rows (Q9)
    uv_t = uv_view.contiguous()
    yn, cn = w * h, w * h // 4
    planes = (frames4[0, :yn], frames4[0, yn : yn + cn], frames4[0, yn + cn :])
    timed = (  # (kernel, shape, kernel fn, plain fn, one-call library fn, bytes moved)
        ("T2", "1080p luma", lambda: rk.plane_to_tiles_cuda(y1, p),
         lambda: rk.plane_to_tiles_plain(y1, p),
         lambda: y_ext.reshape(by, 8, bx, 8).permute(1, 3, 0, 2).contiguous(),
         y1.numel() + t_y.numel()),
        ("T2", "1080p U+V", lambda: rk.plane_to_tiles_cuda(uv1, p, out=uv_view),
         lambda: rk.plane_to_tiles_plain(uv1, p),
         lambda: uv_ext.reshape(2, 68, 8, 121, 8).permute(0, 2, 4, 1, 3).contiguous(),
         uv1.numel() + uv_stack.numel()),
        ("T3", "1080p luma", lambda: rk.tiles_to_plane_cuda(t_y, p, h, w),
         lambda: rk.tiles_to_plane_plain(t_y, p, h, w),
         lambda: t_y.permute(2, 0, 3, 1).reshape(8 * by, 8 * bx),
         y1.numel() + t_y.numel()),
        ("T3", "1080p U+V", lambda: rk.tiles_to_plane_cuda(uv_view, p, h // 2, w // 2),
         lambda: rk.tiles_to_plane_plain(uv_view, p, h // 2, w // 2),
         lambda: uv_t.permute(0, 3, 1, 4, 2).reshape(2, 8 * 68, 8 * 121),
         uv1.numel() + uv_stack.numel()),
        ("T4", "1080p frame", lambda: rk.pack_yv12_cuda(*planes),
         lambda: rk.pack_yv12_plain(*planes), lambda: torch.cat(planes),
         2 * (yn + 2 * cn)),
    )
    rows = {}
    for kname, shape, kern, plain_fn, lib_fn, nbytes in timed:
        r = in_turns({"kernel": kern, "plain": plain_fn, "library": lib_fn},
                     {"kernel": 200, "plain": 50, "library": 200})
        row = {"shape": shape, "ms": r["kernel"][0], "plain_ms": r["plain"][0],
               "library_ms": r["library"][0], "bound_ms": bytes_bound_ms(nbytes)}
        rows.setdefault(kname, []).append(row)
        print(f"{kname} {shape}: kernel {row['ms'] * 1e3:.2f} us, plain {row['plain_ms'] * 1e3:.2f}"
              f" us, library {row['library_ms'] * 1e3:.2f} us, bound {row['bound_ms'] * 1e3:.2f}"
              f" us (queued ahead: {all(ok for _, ok in r.values())}; device time; {smi})")
    for kname, what, kind in (("T2", "plane_to_tiles", "fwd"), ("T3", "tiles_to_plane", "inv"),
                              ("T4", "pack_yv12", "pack")):
        main_row, *others = rows[kname]
        replaces = {"T2": "tools/kernel_relayout_exp.py:55", "T3": "tools/kernel_relayout_exp.py:87",
                    "T4": "tools/pack_exp.py:91"}[kname]
        kernels.append({
            "name": f"{kname} {what} ({main_row['shape']})", "route": "cuda",
            "source": RELAYOUT_SOURCE, "replaces": replaces,
            "launches": res_launches[kname], "launches_by_path": {"resident": res_launches[kname]},
            "max_abs_err": rerr[kind],
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": "bytes",
            "library_ms": main_row["library_ms"],
            **({"other_shapes": others} if others else {}),
        })

    for nb_t, frame in ((1, frames4[0]), (4, frames4)):
        rd = ResidentDeblocker(w, h, 35, device=dev)
        st = rd.step_time(frame, iters=50, repeats=2)
        print(f"resident 1080p batch {nb_t}: step {st['step_us']:.1f} us, ingest "
              f"{st['ingest_us']:.1f} us, readback {st['readback_us']:.1f} us (device time, "
              f"queued ahead: {st['queued_ahead']}); dispatch {st['dispatch_us']:.1f} us/step "
              f"({smi})")

    # -- 4c. where the time goes: device kernels by name (torch.profiler) ------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def trace(what: str, fn, reps: int = 20) -> None:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6 / reps
        rows = sorted(((getattr(e, "self_device_time_total", 0) / reps, e.count / reps, e.key)
                       for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                      reverse=True)
        busy = sum(us for us, _, _ in rows)
        if not busy:
            print(f"profile {what}: the profiler shows no device time (not measured)")
            return
        print(f"profile {what}: kernels {busy:.1f} us per call, wall {wall_us:.1f} us per call, "
              f"device busy {100 * busy / wall_us:.0f}% ({smi})")
        for us, count, key in rows:
            print(f"  {us:8.2f} us  x{count:g}  {key[:90]}")

    rd1 = ResidentDeblocker(w, h, 35, device=dev)
    trace("resident 1080p ingest + step + readback to the device, batch 1",
          lambda: _readback(rd1.step(rd1.ingest(frames4[0])), w, h))
    trace("resident 1080p ingest + step + readback to the device, batch 4",
          lambda: _readback(rd1.step(rd1.ingest(frames4)), w, h), reps=5)
    trace("streaming packed _step 1080p", lambda: s._step(buf))

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
