"""Device time per launch of the deblock kernels on one CUDA device, for
comparing two trees of the port in one run on one card.

    python gpu_video_codec_tpu_torch/tools/kernel_time.py [--tree DIR] \\
        [--iters 200] [--repeats 3] [--chroma-format 4:2:0|4:2:2|4:4:4]

--tree: the checkout whose gpu_video_codec_tpu_torch is imported (default:
the one this file lies in), e.g. a `git archive` of another commit; run
the two trees in turns (parent, change, change, parent) in one call.
Times, at QP 35 on blocky tiles (flat 8x8 blocks with small steps, a
quarter uniform noise; numpy seed 11) with BS maps uniform in 0..2:
K1 and K1-i16 at the 1080p luma grid (8, 8, 136, 241), K1c and K1-i16c at
the 1080p U+V grid (2, 8, 8, 68, 121) with one shared map, and K1 and T1 at
the race grid (8, 8, 136, 256), T1 also on uniform noise and with every
BS byte 0, and T5 on the race grid's rows layout (136, 8, 8, 256) on
blocky tiles, on noise and with BS 0 (TMA-staged), the same blocky and BS
0 on a copy 8 bytes past a 16-byte boundary (staged in 8-byte words), and
at the 1080p luma width (136, 8, 8, 241); each through the public
wrappers with their default blocks.  And the packed step at the benchmark
cells' shapes, 16 1080p and 4 4K blocky frames in place (QP 37, BS maps
uniform in 0..2): the chain T2 -> K1 -> T3, T2 -> K1c -> T3 (the public
wrappers, as the tree's streaming step composes them) and, where the tree
has it, K2 (deblock_packed_cuda) and its plain version (3 launches a
repeat), beside the byte bound of the step and K2's registers, occupancy
and shared memory; and, where the tree has it, K2-10
(deblock_packed_cuda(..., bit_depth=10)) and its plain version on 4 4K
Main 10 frames (the 4K frames' samples times 4 plus 0..3, int16), with its
bound (2 bytes a sample) and its launch.  K2 and K2-10 also run with the
benchmark cells' all-intra BS (BoundaryStrength.intra_default's maps:
"all-intra").
Prints one JSON line: per kernel the device us per launch of each repeat
(utils.timing.device_ms: CUDA events around `iters` launches queued
behind a spin kernel) and whether every repeat was queued ahead; the
packed step's bounds in us ("bound_us") and K2's and K2-10's launches
("k2", "k2_10", null in a tree without them).  Exits non-zero without a CUDA device.

--chroma-format 4:2:2 times the packed step of 4:2:2 frames instead, and
nothing else: K2-10 (deblock_packed_cuda(..., bit_depth=10,
chroma_format="4:2:2")) in place on 4 4K Main 4:2:2 10 frames, an int16
(4, 4320, 3840) buffer of the same blocky content, with BS maps uniform in
0..2 and with the all-intra maps (BoundaryStrength.intra_default(...,
"4:2:2")), its plain version, and K2 on the 8-bit frames; beside the
bounds (2 x 2wh samples a frame) and K2's and K2-10's launches.  A tree without
4:2:2 exits non-zero.

--chroma-format 4:4:4 does the same on 4 4K Main 4:4:4 frames, a uint8
(4, 6480, 3840) buffer (the 4:4:4 cell's), and their int16 Main 4:4:4 10
twin: K2 and K2-10 (chroma_format="4:4:4") with random and all-intra
maps, and K2's plain version; beside the bounds (2 x 3wh samples a
frame), the tiles a frame and K2's and K2-10's launches.  A tree without
4:4:4 exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def blocky_tiles(rng, shape):
    """uint8 tile-planes (.., 8, 8, By, Bx): flat blocks with small steps at
    the edges the filter reads (strong and normal filters fire), a quarter
    of the tiles uniform noise."""
    import numpy as np

    cell = shape[:-4] + (1, 1) + shape[-2:]
    t = rng.integers(40, 216, cell) + rng.integers(-3, 4, shape)
    t[..., 4:, :, :, :] += rng.integers(-20, 21, cell)
    t = np.where(rng.random(cell) < 0.25, rng.integers(0, 256, shape), t)
    return np.clip(t, 0, 255).astype(np.uint8)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), help="checkout to import the port from")
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--chroma-format", choices=("4:2:0", "4:2:2", "4:4:4"), default="4:2:0")
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_time: needs a CUDA device", file=sys.stderr)
        return 1
    import gpu_video_codec_tpu_torch as pkg
    from gpu_video_codec_tpu_torch.models.streaming import StreamingDeblocker
    from gpu_video_codec_tpu_torch.ops import cuda_kernel as ck
    from gpu_video_codec_tpu_torch.ops import relayout_kernel as rk
    from gpu_video_codec_tpu_torch.ops import swar_kernel as sk
    from gpu_video_codec_tpu_torch.ops.tables import get_beta, get_tc
    from gpu_video_codec_tpu_torch.utils.timing import device_ms

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True).stdout.strip()
    rng = np.random.default_rng(11)
    beta, tc = get_beta(35), get_tc(35)
    if args.chroma_format != "4:2:0":
        fmt = args.chroma_format
        if f"packed10_{fmt.replace(':', '')}" not in ck.LAUNCHES:
            print(f"kernel_time: this tree has no {fmt} packed step", file=sys.stderr)
            return 1
        return _time_format(args, fmt, pkg, ck, dev, smi, rng)

    def operands(shape, mshape, noise=False):
        tiles = (rng.integers(0, 256, shape, dtype=np.uint8) if noise
                 else blocky_tiles(rng, shape))
        maps = [torch.from_numpy(rng.integers(0, 3, mshape, dtype=np.uint8)).to(dev)
                for _ in range(4)]
        return torch.from_numpy(tiles).to(dev), maps

    luma = operands((8, 8, 136, 241), (136, 241))
    chroma = operands((2, 8, 8, 68, 121), (1, 68, 121))
    race = operands((8, 8, 136, 256), (136, 256))
    noise = operands((8, 8, 136, 256), (136, 256), noise=True)
    off = [torch.zeros_like(m) for m in race[1]]
    rows = race[0].permute(2, 0, 1, 3).contiguous()
    noise_rows = noise[0].permute(2, 0, 1, 3).contiguous()
    rows_241 = luma[0].permute(2, 0, 1, 3).contiguous()
    space = torch.empty(rows.numel() + 16, dtype=torch.uint8, device=dev)
    rows_off8 = space[8:8 + rows.numel()].view(rows.shape)  # T5's words route
    rows_off8.copy_(rows)
    fns = {
        "K1 (8, 8, 136, 241)": lambda: ck.deblock_tiles_cuda(luma[0], *luma[1], beta, tc),
        "K1-i16 (8, 8, 136, 241)": lambda: ck.deblock_tiles_cuda(
            luma[0], *luma[1], beta, tc, dtype=torch.int16),
        "K1c (2, 8, 8, 68, 121)": lambda: ck.deblock_tiles_cuda(
            chroma[0], *chroma[1], beta, tc, chroma=True),
        "K1-i16c (2, 8, 8, 68, 121)": lambda: ck.deblock_tiles_cuda(
            chroma[0], *chroma[1], beta, tc, chroma=True, dtype=torch.int16),
        "K1 race (8, 8, 136, 256)": lambda: ck.deblock_tiles_cuda(race[0], *race[1], beta, tc),
        "T1 race (8, 8, 136, 256)": lambda: sk.deblock_tiles_swar_cuda(race[0], *race[1], beta,
                                                                        tc),
        "T1 race on noise": lambda: sk.deblock_tiles_swar_cuda(noise[0], *noise[1], beta, tc),
        "T1 race BS 0": lambda: sk.deblock_tiles_swar_cuda(race[0], *off, beta, tc),
        "T5 race (136, 8, 8, 256)": lambda: ck.deblock_rows_cuda(rows, *race[1], beta, tc),
        "T5 race on noise": lambda: ck.deblock_rows_cuda(noise_rows, *noise[1], beta, tc),
        "T5 race BS 0": lambda: ck.deblock_rows_cuda(rows, *off, beta, tc),
        "T5 race, 8-byte words": lambda: ck.deblock_rows_cuda(rows_off8, *race[1], beta, tc),
        "T5 race BS 0, 8-byte words": lambda: ck.deblock_rows_cuda(rows_off8, *off, beta, tc),
        "T5 (136, 8, 8, 241)": lambda: ck.deblock_rows_cuda(rows_241, *luma[1], beta, tc),
    }
    k2 = hasattr(ck, "deblock_packed_cuda")
    k2_10 = "packed10" in ck.LAUNCHES
    plain_fns, bounds = {}, {}
    b37, t37 = get_beta(37), get_tc(37)
    for k, w, h in ((16, 1920, 1080), (4, 3840, 2160)):
        shape = f"({k}, {3 * h // 2}, {w})"
        nby = (3 * h // 2 + 7) // 8  # blocky 8x8 blocks over the packed rows
        blocks = blocky_tiles(rng, (k, 8, 8, nby, w // 8)).transpose(0, 3, 1, 4, 2)
        buf = torch.from_numpy(np.ascontiguousarray(
            blocks.reshape(k, 8 * nby, w)[:, : 3 * h // 2])).to(dev)
        y, uv = buf[:, :h], buf[:, h:].view(k, 2, h // 2, w // 2)
        lm = [torch.from_numpy(rng.integers(0, 3, ((h + 8) // 8, (w + 8) // 8),
                                            dtype=np.uint8)).to(dev) for _ in range(4)]
        cm = [torch.from_numpy(rng.integers(0, 3, ((h // 2 + 8) // 8, (w // 2 + 8) // 8),
                                            dtype=np.uint8)).to(dev) for _ in range(4)]

        def chain(y=y, uv=uv, lm=lm, cm=cm, h=h, w=w):
            t = ck.deblock_tiles_cuda(rk.plane_to_tiles_cuda(y, 4), *(m[None] for m in lm),
                                      b37, t37)
            rk.tiles_to_plane_cuda(t, 4, h, w, out=y)
            t = rk.plane_to_tiles_cuda(uv, 4)
            t = ck.deblock_tiles_cuda(t.reshape(-1, *t.shape[-4:]), *(m[None] for m in cm),
                                      b37, t37, chroma=True).reshape(t.shape)
            rk.tiles_to_plane_cuda(t, 4, h // 2, w // 2, out=uv)

        fns[f"chain {shape}"] = chain
        sd = StreamingDeblocker(w, h, 37, device=dev)  # the cells' all-intra BS maps
        ai = (sd._lm, sd._cm)
        if k2:
            from gpu_video_codec_tpu_torch.ops.deblock import deblock_packed_plain

            fns[f"K2 {shape}"] = lambda y=y, uv=uv, lm=lm, cm=cm: ck.deblock_packed_cuda(
                y, uv, lm, cm, b37, t37, out=(y, uv))
            fns[f"K2 all-intra {shape}"] = lambda y=y, uv=uv, m=ai: ck.deblock_packed_cuda(
                y, uv, *m, b37, t37, out=(y, uv))
            plain_fns[f"K2 plain {shape}"] = lambda y=y, uv=uv, lm=lm, cm=cm: (
                deblock_packed_plain(y, uv, lm, cm, b37, t37))
        bounds[shape] = 2 * buf.numel() / 3.35e12 * 1e6  # read once, written once
        if k2_10 and w == 3840:
            buf10 = (buf.to(torch.int16) << 2) + torch.from_numpy(
                rng.integers(0, 4, tuple(buf.shape), dtype=np.int16)).to(dev)
            y10, uv10 = buf10[:, :h], buf10[:, h:].view(k, 2, h // 2, w // 2)
            fns[f"K2-10 {shape}"] = lambda y=y10, uv=uv10, lm=lm, cm=cm: ck.deblock_packed_cuda(
                y, uv, lm, cm, b37, t37, out=(y, uv), bit_depth=10)
            fns[f"K2-10 all-intra {shape}"] = lambda y=y10, uv=uv10, m=ai: ck.deblock_packed_cuda(
                y, uv, *m, b37, t37, out=(y, uv), bit_depth=10)
            plain_fns[f"K2-10 plain {shape}"] = lambda y=y10, uv=uv10, lm=lm, cm=cm: (
                deblock_packed_plain(y, uv, lm, cm, b37, t37, bit_depth=10))
            bounds[f"{shape} 10-bit"] = 2 * buf10.numel() * 2 / 3.35e12 * 1e6
    runs = {name: [device_ms(fn, args.iters) for _ in range(args.repeats)]
            for name, fn in fns.items()}
    runs.update({name: [device_ms(fn, 3) for _ in range(args.repeats)]
                 for name, fn in plain_fns.items()})
    print(json.dumps({
        "tree": os.path.relpath(os.path.dirname(os.path.dirname(pkg.__file__))), "card": smi,
        "us": {name: [ms * 1e3 for ms, _ in r] for name, r in runs.items()},
        "queued_ahead": all(ok for r in runs.values() for _, ok in r),
        "bound_us": bounds, "k2": ck.deblock_packed_info(dev) if k2 else None,
        "k2_10": ck.deblock_packed_info(dev, bit_depth=10) if k2_10 else None}))
    return 0


def _time_format(args, fmt, pkg, ck, dev, smi, rng) -> int:
    """--chroma-format 4:2:2 or 4:4:4: K2-10 and K2 on 4 4K frames of the
    format (and, at 4:4:4, K2's plain version beside K2-10's)."""
    import numpy as np
    import torch

    from gpu_video_codec_tpu_torch.ops.deblock import deblock_packed_plain
    from gpu_video_codec_tpu_torch.ops.tables import chroma_width, get_beta, get_tc, packed_rows
    from gpu_video_codec_tpu_torch.utils.bs import BoundaryStrength, segment_bs_maps_device
    from gpu_video_codec_tpu_torch.utils.timing import device_ms

    k, w, h = 4, 3840, 2160
    rows, cw = packed_rows(h, fmt), chroma_width(w, fmt)
    b37, t37 = get_beta(37), get_tc(37)
    shape = f"({k}, {rows}, {w})"
    blocks = blocky_tiles(rng, (k, 8, 8, rows // 8, w // 8)).transpose(0, 3, 1, 4, 2)
    buf = torch.from_numpy(np.ascontiguousarray(blocks.reshape(k, rows, w))).to(dev)
    buf10 = (buf.to(torch.int16) << 2) + torch.from_numpy(
        rng.integers(0, 4, tuple(buf.shape), dtype=np.int16)).to(dev)
    (by, bx), (cby, cbx) = ck.packed_grids(w, h, fmt)
    lm = [torch.from_numpy(rng.integers(0, 3, (by, bx), dtype=np.uint8)).to(dev)
          for _ in range(4)]
    cm = [torch.from_numpy(rng.integers(0, 3, (cby, cbx), dtype=np.uint8)).to(dev)
          for _ in range(4)]
    bs = BoundaryStrength.intra_default(w, h, fmt)
    ny, nx = h // 8 + 1, w // 8 + 1
    ai = (segment_bs_maps_device(bs.vert, bs.hor, w, ny, nx, ny, nx, device=dev),
          segment_bs_maps_device(bs.chroma_vert, bs.chroma_hor, cw, cby, cbx, ny, nx,
                                 device=dev))

    def planes(b):
        return b[:, :h], b[:, h:].view(k, 2, h, cw)

    def k2(b, maps, bd):
        y, uv = planes(b)
        return lambda: ck.deblock_packed_cuda(y, uv, *maps, b37, t37, out=(y, uv), bit_depth=bd,
                                              chroma_format=fmt)

    fns = {f"K2-10 {fmt} {shape}": k2(buf10, (lm, cm), 10),
           f"K2-10 {fmt} all-intra {shape}": k2(buf10, ai, 10),
           f"K2 {fmt} {shape}": k2(buf, (lm, cm), 8),
           f"K2 {fmt} all-intra {shape}": k2(buf, ai, 8)}
    runs = {name: [device_ms(fn, args.iters) for _ in range(args.repeats)]
            for name, fn in fns.items()}
    plain = {f"K2-10 {fmt} plain {shape}": (buf10, 10)}
    if fmt == "4:4:4":
        plain[f"K2 {fmt} plain {shape}"] = (buf, 8)
    for name, (b, bd) in plain.items():
        y, uv = planes(b)
        runs[name] = [device_ms(lambda y=y, uv=uv, bd=bd: deblock_packed_plain(
            y, uv, lm, cm, b37, t37, bit_depth=bd), 3) for _ in range(args.repeats)]
    print(json.dumps({
        "tree": os.path.relpath(os.path.dirname(os.path.dirname(pkg.__file__))), "card": smi,
        "us": {name: [ms * 1e3 for ms, _ in r] for name, r in runs.items()},
        "queued_ahead": all(ok for r in runs.values() for _, ok in r),
        "bound_us": {shape: 2 * buf.numel() / 3.35e12 * 1e6,
                     f"{shape} 10-bit": 2 * buf10.numel() * 2 / 3.35e12 * 1e6},
        "tiles_per_frame": {"luma": by * bx, "chroma": 2 * cby * cbx},
        "k2": ck.deblock_packed_info(dev), "k2_10": ck.deblock_packed_info(dev, bit_depth=10)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
