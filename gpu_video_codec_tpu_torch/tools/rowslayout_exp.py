"""Can the deblock kernel read the "rows" tile layout directly?  The port's
counterpart of tools/rowslayout_exp.py.

    python -m gpu_video_codec_tpu_torch.tools.rowslayout_exp [--device cuda|cpu]

The rows layout (By, 8, 8, Bx), element [by, r, c, bx] = pixel (r, c) of
tile (by, bx), is what the TPU's relayout dot leaves for free: its
(8*By, [c, t])-ordered output reshapes to it row-major (tools/
rowslayout_exp.py of the JAX package).  A row-major (8*By, 8*Bx) plane's
own free reshape is (By, 8, Bx, 8), element [by, r, bx, c]; from a plane,
the rows layout and the canonical tile-planes layout (8, 8, By, Bx) each
cost a transpose.  At the 1080p luma grid (136, 256), with the JAX
experiment's inputs (uniform random tiles and BS maps from seed 0, beta 54,
tc 8), this runs canonical K1 (deblock_tiles_cuda) and T5
(deblock_rows_cuda), checks that they agree byte for byte and times both
with CUDA events, 200 launches each, in turns.  Prints one JSON line
{"grid", "bit_exact", "canonical_us", "rows_layout_us", "rows_route",
"device"} (rows_route: T5's staging, "tma" or "words"); on --device cpu the
wrappers run their plain versions and the times and route are null.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import device_name, times_us
from ..ops.cuda_kernel import deblock_rows_cuda, deblock_rows_occupancy, deblock_tiles_cuda


def run(device, by: int = 136, bx: int = 256, iters: int = 200) -> dict:
    device = torch.device(device)
    rng = np.random.default_rng(0)
    tiles_np = rng.integers(0, 256, (8, 8, by, bx), dtype=np.uint8)
    maps = [torch.from_numpy(rng.integers(0, 3, (by, bx), dtype=np.uint8)).to(device)
            for _ in range(4)]
    beta, tc = 54, 8
    tiles = torch.from_numpy(tiles_np).to(device)
    rows = torch.from_numpy(np.ascontiguousarray(tiles_np.transpose(2, 0, 1, 3))).to(device)
    can = deblock_tiles_cuda(tiles, *maps, beta, tc)
    got = deblock_rows_cuda(rows, *maps, beta, tc)
    exact = bool(torch.equal(got.permute(1, 2, 0, 3), can))
    us = times_us({"canonical": lambda: deblock_tiles_cuda(tiles, *maps, beta, tc),
                   "rows_layout": lambda: deblock_rows_cuda(rows, *maps, beta, tc)},
                  device, iters)
    route = deblock_rows_occupancy(rows)["route"] if device.type == "cuda" else None
    return {"grid": f"{by}x{bx}", "bit_exact": exact, "canonical_us": us["canonical"],
            "rows_layout_us": us["rows_layout"], "rows_route": route,
            "device": device_name(device)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    result = run(ap.parse_args(argv).device)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    sys.exit(0 if main()["bit_exact"] else 1)
