#!/usr/bin/env python
"""PSNR / max-abs-diff between two YV12 files (per plane).

Usage: python -m gpu_video_codec_tpu_torch.tools.psnr a.yuv b.yuv WIDTH HEIGHT
A user-facing validation utility the reference lacked (its CPU and GPU
outputs were never compared, main.cu:129-138)."""

import json
import sys

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray):
    """PSNR in dB; None when identical (strict-JSON-safe instead of Infinity)."""
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return None if mse == 0 else round(10 * np.log10(255.0 ** 2 / mse), 2)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 4:
        print(__doc__, file=sys.stderr)
        return 2
    pa, pb, w, h = argv[0], argv[1], int(argv[2]), int(argv[3])
    fb = 3 * w * h // 2
    a = np.fromfile(pa, np.uint8)
    b = np.fromfile(pb, np.uint8)
    n = min(a.size, b.size) // fb
    if n == 0:
        print("error: no complete frames", file=sys.stderr)
        return 1
    if a.size != b.size:
        print(f"error: size mismatch: {pa} has {a.size // fb} complete frames "
              f"({a.size} B), {pb} has {b.size // fb} ({b.size} B); comparing "
              f"the first {n}", file=sys.stderr)
    out = []
    for i in range(n):
        fa, fbuf = a[i * fb : (i + 1) * fb], b[i * fb : (i + 1) * fb]
        ya, yb = fa[: w * h], fbuf[: w * h]
        ca, cb = fa[w * h :], fbuf[w * h :]
        out.append({
            "frame": i,
            "psnr_y": psnr(ya, yb),
            "psnr_uv": psnr(ca, cb),
            "max_abs_diff": int(np.max(np.abs(fa.astype(int) - fbuf.astype(int)))),
            "identical": bool(np.array_equal(fa, fbuf)),
        })
    print(json.dumps(out))
    return 0 if a.size == b.size else 1


if __name__ == "__main__":
    sys.exit(main())
