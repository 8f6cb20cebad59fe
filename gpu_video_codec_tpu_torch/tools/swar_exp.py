"""Does a SWAR sweep, tile pairs in the 16-bit lanes of 32-bit words, beat the int32
deblock kernel?  The port's counterpart of tools/swar_exp.py.

    python -m gpu_video_codec_tpu_torch.tools.swar_exp --check [--device cuda|cpu]
    python -m gpu_video_codec_tpu_torch.tools.swar_exp --race [--device cuda|cpu]

--check: the four cases of the JAX check() (seed 0; random grids with an
  even Bx; luma and chroma; QP 0, 20, 37, 51; uniform random tiles and BS
  maps): T1 against deblock_tiles_plain, byte for byte.  T1 is the kernel
  (ops/swar_kernel.py) on a CUDA device and its g++ host build
  (csrc/swar_tile.cuh through csrc/host_shim.cpp) on the CPU.
--race: K1 (deblock_tiles_cuda) against T1 at the 1080p-luma grid (136,
  256), with the JAX race's inputs (seed 0, beta 36, tc 4): bit_exact, and
  CUDA-event device times, 200 launches each, in turns, with their ratio
  swar_over_int32.  On the CPU, K1's side is its plain version, T1's the
  host build, and the times are null.

Prints one JSON line.  Not ported: --ops (a count of jaxpr equations); its
counterpart on the card, a count of SASS instructions, is later work.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys

import numpy as np
import torch

from . import device_name, times_us
from ..ops.cuda_kernel import deblock_tiles_cuda
from ..ops.deblock import deblock_tiles_plain
from ..ops.swar_kernel import BLOCK, deblock_tiles_swar_cuda, load_host_library
from ..ops.tables import get_beta, get_tc


def swar_deblock_tiles(tiles, bs_maps, beta: int, tc: int, chroma: bool = False):
    """T1 on an (8, 8, By, Bx) uint8 tensor, Bx even, with a list of four
    (By, Bx) maps (the signature of the JAX swar_deblock_tiles): the CUDA
    kernel for a CUDA tensor, the host build of its blocks for a CPU
    tensor.  Returns a new tensor."""
    if tiles.device.type == "cuda":
        return deblock_tiles_swar_cuda(tiles, *bs_maps, beta, tc, chroma=chroma)
    if tiles.dim() != 4 or tiles.shape[-1] % 2:
        raise ValueError(f"tiles must be (8, 8, By, Bx) with Bx even, got {tuple(tiles.shape)}")
    lib = load_host_library()
    src = np.ascontiguousarray(tiles.numpy())
    ms = [np.ascontiguousarray(m.numpy()) for m in bs_maps]
    out = np.empty_like(src)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    by, bx = src.shape[-2:]
    if lib.gvct_host_swar_tiles(BLOCK, ptr(src), ptr(out), *(ptr(m) for m in ms), int(beta),
                                int(tc), by, bx, int(chroma)):
        raise ValueError(f"the host SWAR blocks refused the grid ({by}, {bx})")
    return torch.from_numpy(out)


def check(device) -> dict:
    device = torch.device(device)
    rng = np.random.default_rng(0)
    cases = []
    for case in range(4):
        by, bx = int(rng.integers(2, 8)), 2 * int(rng.integers(2, 8))
        chroma = bool(case % 2)
        qp = (0, 20, 37, 51)[case]
        beta, tc = get_beta(qp), get_tc(qp)
        tiles = torch.from_numpy(rng.integers(0, 256, (8, 8, by, bx), np.uint8)).to(device)
        maps = [torch.from_numpy(rng.integers(0, 3, (by, bx), np.uint8)).to(device)
                for _ in range(4)]
        want = deblock_tiles_plain(tiles, *maps, beta, tc, chroma=chroma)
        got = swar_deblock_tiles(tiles, maps, beta, tc, chroma=chroma)
        cases.append({"case": case, "grid": f"{by}x{bx}", "chroma": chroma, "qp": qp,
                      "bit_exact": bool(torch.equal(got.to(want.device), want))})
    return {"check": cases, "ok": all(c["bit_exact"] for c in cases),
            "device": device_name(device)}


def race(device, by: int = 136, bx: int = 256, iters: int = 200) -> dict:
    device = torch.device(device)
    rng = np.random.default_rng(0)
    tiles = torch.from_numpy(rng.integers(0, 256, (8, 8, by, bx), np.uint8)).to(device)
    maps = [torch.from_numpy(rng.integers(0, 3, (by, bx), np.uint8)).to(device)
            for _ in range(4)]
    beta, tc = 36, 4
    ref = deblock_tiles_cuda(tiles, *maps, beta, tc)
    got = swar_deblock_tiles(tiles, maps, beta, tc)
    out = {"grid": f"{by}x{bx}", "bit_exact": bool(torch.equal(got.to(ref.device), ref))}
    us = times_us({"int32": lambda: deblock_tiles_cuda(tiles, *maps, beta, tc),
                   "swar": lambda: deblock_tiles_swar_cuda(tiles, *maps, beta, tc)},
                  device, iters)
    out.update(int32_kernel_us=us["int32"], swar_kernel_us=us["swar"],
               swar_over_int32=us["swar"] / us["int32"] if us["int32"] else None,
               device=device_name(device))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    what = ap.add_mutually_exclusive_group(required=True)
    what.add_argument("--check", action="store_true", help="bit-exactness, four cases")
    what.add_argument("--race", action="store_true", help="K1 against T1 at (136, 256)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    result = check(args.device) if args.check else race(args.device)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    res = main()
    sys.exit(0 if res.get("ok", res.get("bit_exact")) else 1)
