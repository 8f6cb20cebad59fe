#!/usr/bin/env python
"""End-of-chain validation: diff one of the port's backends against the
ACTUAL reference implementation, compiled from a read-only checkout of it
(REF_DIR, else the directory that $GVCT_REFERENCE_DIR names).  The port's
counterpart of tools/validate_vs_reference.py: the same driver, cases,
fuzz draws, UB mask and words, plus --backend.

The reference's CPU path (hevc_deblocking_filter_cpu.h) is portable C++;
this tool compiles a tiny driver against it (no reference code is copied
into this repository -- the header is included straight from REF_DIR at
build time, g++ -O2 -fopenmp), runs it and byte-compares with the backend:

  (default)    the 8 CASES: the bundled frames at QPs 20/27/35/43/51, two
               with an injected pseudo-random luma BS; strict byte compare
  --fuzz       random frames x dims (sheared Q9 widths among them) x QPs
               0-60 x injected BS; diffs inside the reference's
               undefined-behaviour regions (Q2/Q6/Q9) are reported, not failed
  --fullscale  a synthetic 1920x1080 frame; the reference at 1 and 4
               threads must agree, and the backend with it outside the UB
               regions

--backend cuda (the default: the hand-written kernels through
DeblockPipeline on --device, cuda by default), packed (the cuda backend's
packed streaming step, StreamingDeblocker on --device: K2 where its guard
takes the frame, T2 -> K1 -> T3 elsewhere), torch (the plain PyTorch
version on --device), golden (the NumPy oracle) or native (the C++ OpenMP
runtime).  Prints IDENTICAL, "ALL inside reference-UB regions (OK)" or
REAL DIVERGENCE per case; exits 2 when the reference header is missing and
1 on any divergence.  Where it differs from the JAX tool: REF_DIR has no
fixed default (the JAX tool reads a fixed mount); a missing header exits 2
in every mode (the JAX tool checks it in the default mode only); and
fullscale names the backend where the JAX tool says golden.

Usage: python -m gpu_video_codec_tpu_torch.tools.validate_vs_reference [REF_DIR]
       python -m gpu_video_codec_tpu_torch.tools.validate_vs_reference --fuzz [N] [SEED] [MAX_W] [MAX_H] [REF_DIR]
       python -m gpu_video_codec_tpu_torch.tools.validate_vs_reference --fullscale [REF_DIR]
       (each also takes --backend cuda|torch|golden|native|packed and --device DEVICE)
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np

from ..models.pipeline import DeblockPipeline
from ..models.streaming import StreamingDeblocker
from ..runtime import native
from ..utils.bs import BoundaryStrength
from ..utils.config import BACKENDS
from ..utils.yuv import planes_from_yv12_bytes, read_yv12, yv12_bytes_from_planes

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REF_ENV = "GVCT_REFERENCE_DIR"  # REF_DIR when none is passed
HEADER = "hevc_deblocking_filter_cpu.h"
TOOL_BACKENDS = (*BACKENDS, "packed")  # packed: the cuda backend's packed streaming step

DRIVER = r"""
// Validation driver: runs the REFERENCE CPU implementation (included from
// the read-only reference checkout) on one YV12 frame.  Optional 6th arg
// `seed` injects pseudo-random luma BS via SetBoundaryStrenght using an
// LCG the python side replicates (exercises the injection path too).
#include "hevc_deblocking_filter_cpu.h"
#include <chrono>
#include <cstdlib>
#include <cstdio>
#include <vector>
int main(int argc, char **argv) {
    if (argc != 6 && argc != 7) {
        fprintf(stderr, "usage: %s in w h qp out [seed]\n", argv[0]);
        return 2;
    }
    unsigned int w = atoi(argv[2]), h = atoi(argv[3]);
    try {
        ReadYuvFrame frame(argv[1], w, h, atoi(argv[4]));
        if (argc == 7) {
            unsigned long long s = strtoull(argv[6], nullptr, 10);
            unsigned int nv = (w / 8 + 1) * (h / 8);
            unsigned int nh = (h / 8 + 1) * (w / 8);
            std::vector<unsigned char> v(nv), hh(nh);
            for (unsigned int i = 0; i < nv; i++) {
                s = s * 6364136223846793005ULL + 1442695040888963407ULL;
                v[i] = (unsigned char)((s >> 33) % 3);
            }
            for (unsigned int i = 0; i < nh; i++) {
                s = s * 6364136223846793005ULL + 1442695040888963407ULL;
                hh[i] = (unsigned char)((s >> 33) % 3);
            }
            frame.SetBoundaryStrenght(v.data(), nv, hh.data(), nh);
        }
        // REF_THREADS exercises the reference's OpenMP path (cpu.h:135);
        // tiles are independent so output must not depend on thread count
        const char *t = getenv("REF_THREADS");
        int nthreads = t ? atoi(t) : 1;
        // REF_BENCH_REPS=N: time the filter like main.cu:41-43 does (bracket
        // around DeblockingFilter only; frame re-read outside the bracket),
        // best-of-N, printed as "BENCH <seconds>" for the bench harness.
        const char *reps_env = getenv("REF_BENCH_REPS");
        if (reps_env) {
            int reps = atoi(reps_env);
            double best = 1e30;
            for (int i = 0; i < reps; i++) {
                ReadYuvFrame f2(argv[1], w, h, atoi(argv[4]));
                auto t0 = std::chrono::steady_clock::now();
                f2.DeblockingFilter(nthreads);
                std::chrono::duration<double> dt =
                    std::chrono::steady_clock::now() - t0;
                if (dt.count() < best) best = dt.count();
            }
            printf("BENCH %.9f\n", best);
        }
        frame.DeblockingFilter(nthreads);
        frame.Save(argv[5]);
    } catch (const char *e) { fprintf(stderr, "error: %s\n", e); return 1; }
    return 0;
}
"""


def _lcg_bs(seed: int, nv: int, nh: int):
    """Python twin of the driver's LCG BS generator."""
    s = seed & 0xFFFFFFFFFFFFFFFF
    out = []
    for n in (nv, nh):
        a = np.empty(n, np.uint8)
        for i in range(n):
            s = (s * 6364136223846793005 + 1442695040888963407) & 0xFFFFFFFFFFFFFFFF
            a[i] = (s >> 33) % 3
        out.append(a)
    return out


CASES = [
    # (file, w, h, qp, bs_seed or None for the default all-Intra BS)
    ("mother-daughter_352x288_yv12.yuv", 352, 288, 35, None),  # committed workload
    ("image1_352x288_yv12.yuv", 352, 288, 35, None),
    ("image2_768x576.yuv", 768, 576, 35, None),
    ("mother-daughter_352x288_yv12.yuv", 352, 288, 20, None),
    ("mother-daughter_352x288_yv12.yuv", 352, 288, 51, None),
    ("image2_768x576.yuv", 768, 576, 27, None),
    # injected-BS cases: exercise SetBoundaryStrenght vs our bs.set_luma
    ("mother-daughter_352x288_yv12.yuv", 352, 288, 35, 12345),
    ("image2_768x576.yuv", 768, 576, 43, 999),
]


def case_bs(w: int, h: int, bs_seed: int | None) -> BoundaryStrength:
    """The BS the driver runs with: all-Intra, with the LCG's luma BS
    injected when a seed is given."""
    bs = BoundaryStrength.intra_default(w, h)
    if bs_seed is not None:
        bs.set_luma(*_lcg_bs(bs_seed, bs.vert.size, bs.hor.size))
    return bs


def fuzz_cases(n: int, seed: int = 0, max_w: int = 128, max_h: int = 96):
    """The fuzz campaign's cases, (w, h, qp, bs_seed or None, raw packed
    frame): the JAX tool's draws, in its order."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        w = 8 * int(rng.integers(1, max_w // 8 + 1))
        h = 8 * int(rng.integers(1, max_h // 8 + 1))
        qp = int(rng.integers(0, 61))
        bs_seed = int(rng.integers(1, 1 << 31)) if rng.integers(0, 2) else None
        raw = rng.integers(0, 256, 3 * w * h // 2, dtype=np.uint8)
        yield w, h, qp, bs_seed, raw


def build_reference(ref_dir: str, workdir: str) -> str:
    src = os.path.join(workdir, "ref_main.cpp")
    exe = os.path.join(workdir, "ref_deblock")
    with open(src, "w") as f:
        f.write(DRIVER)
    subprocess.run(
        ["g++", "-O2", "-fopenmp", f"-I{ref_dir}", "-o", exe, src],
        check=True, capture_output=True, text=True,
    )
    return exe


def _ub_masked_diffs(o, r, ww, hh, chroma_ub=False, band=4):
    """Diffs outside every region the reference's UB can reach.

    UB sources: (a) uninitialized padding bytes feed any tile of the sweep
    whose 8x8 extent contains one (Q6) -- under the Q9 shear those tiles
    form diagonal stripes through the interior, not just a border band;
    (b) chroma ver2/hor2 BS reads go out of bounds for the last sweep tile
    row (Q2 x Q9, cpu.h:515/645 testing with LUMA block counts).  Mask is
    tile-granular: any output pixel living in an affected sweep tile is
    excluded.  Shared by the fuzz campaign and the fullscale check.
    """
    o2 = o.reshape(hh, ww).astype(int)
    r2 = r.reshape(hh, ww).astype(int)
    wext, hext = ww + 2 * band, hh + 2 * band
    ncby, ncbx = hext // 8, wext // 8
    vh, vw = ncby * 8, ncbx * 8
    # true-layout padding map -> sheared view -> tainted tiles
    pad = np.ones((hext, wext), bool)
    pad[band : band + hh, band : band + ww] = False
    pad_sheared = pad.ravel()[: vh * vw].reshape(vh, vw)
    tainted = pad_sheared.reshape(ncby, 8, ncbx, 8).any(axis=(1, 3))
    if chroma_ub:
        tainted[-1, :] = True  # OOB BS reads (Q2 x Q9)
    # map output pixels -> sheared tile; mask tainted ones
    rows = np.arange(hh)[:, None] + band
    cols = np.arange(ww)[None, :] + band
    flat = rows * wext + cols
    in_sweep = flat < vh * vw
    sr = np.minimum(flat, vh * vw - 1) // vw // 8
    sc = (np.minimum(flat, vh * vw - 1) % vw) // 8
    # out-of-sweep pixels are untouched by both sides: compare them
    # strictly; in-sweep pixels compare unless tainted
    m = ~in_sweep | ~tainted[sr, sc]
    return int(np.sum((o2 != r2) & m))



def deblocked(frame, bs: BoundaryStrength, qp: int, backend: str, device: str) -> np.ndarray:
    """The backend's packed YV12 output for one frame."""
    if backend == "packed":
        sd = StreamingDeblocker(frame.width, frame.height, qp, bs=bs, device=device)
        return next(sd.run([yv12_bytes_from_planes(frame)]))
    out = DeblockPipeline(frame.width, frame.height, qp, backend=backend, bs=bs,
                          device=device)(frame)
    return np.frombuffer(yv12_bytes_from_planes(out), np.uint8)


def _masked_planes(ours, ref, w: int, h: int) -> tuple[int, int, int]:
    """Diffs of two packed frames outside the reference's UB regions: Y, U, V."""
    cw, ch = w // 2, h // 2
    fy, fc = w * h, cw * ch
    return (_ub_masked_diffs(ours[:fy], ref[:fy], w, h),
            _ub_masked_diffs(ours[fy:fy + fc], ref[fy:fy + fc], cw, ch, chroma_ub=True),
            _ub_masked_diffs(ours[fy + fc:], ref[fy + fc:], cw, ch, chroma_ub=True))


def cases(ref_dir: str, backend: str = "cuda", device: str = "cuda") -> int:
    """The 8 CASES, byte for byte (no UB mask: the bundled frames' widths
    are 16-aligned and the reference reads zeroed padding)."""
    failures = 0
    with tempfile.TemporaryDirectory() as td:
        exe = build_reference(ref_dir, td)
        for name, w, h, qp, seed in CASES:
            inp = os.path.join(REPO, "testdata", name)
            out = os.path.join(td, "ref_out.yuv")
            cmd = [exe, inp, str(w), str(h), str(qp), out]
            label = f"{name} {w}x{h} qp={qp}"
            if seed is not None:
                cmd.append(str(seed))
                label += f" bs_seed={seed}"
            subprocess.run(cmd, check=True)
            ref = np.fromfile(out, np.uint8)
            ours = deblocked(read_yv12(inp, w, h), case_bs(w, h, seed), qp, backend, device)
            diffs = int(np.sum(ours != ref))
            status = "IDENTICAL" if diffs == 0 else f"{diffs} byte diffs"
            print(f"{label}: {status}")
            failures += diffs != 0
    return 1 if failures else 0


def fuzz(ref_dir: str, n_cases: int, seed: int = 0, max_w: int = 128, max_h: int = 96,
         backend: str = "cuda", device: str = "cuda") -> int:
    """Adversarial campaign: random frames x dims x QPs x injected BS vs the
    compiled reference binary.

    Comparison masks the reference's *undefined-behavior* regions (the port
    pins them -- SURVEY.md quirks Q2/Q6/Q9 -- so byte equality there is luck
    of the reference process's heap): any sweep tile whose 8x8 extent
    contains an uninitialized padding byte (under the Q9 shear those tiles
    form diagonal stripes through the interior), and the last sheared chroma
    tile row (OOB BS reads).  Any mismatch OUTSIDE those regions is a real
    divergence and fails.
    """
    if backend == "native":
        print(f"fuzz backend: native ({native.active_isa()})")
    failures = 0
    with tempfile.TemporaryDirectory() as td:
        exe = build_reference(ref_dir, td)
        inp = os.path.join(td, "in.yuv")
        out = os.path.join(td, "out.yuv")
        for case, (w, h, qp, bs_seed, raw) in enumerate(fuzz_cases(n_cases, seed, max_w, max_h)):
            raw.tofile(inp)
            cmd = [exe, inp, str(w), str(h), str(qp), out]
            if bs_seed is not None:
                cmd.append(str(bs_seed))
            subprocess.run(cmd, check=True)
            ours = deblocked(planes_from_yv12_bytes(raw, w, h), case_bs(w, h, bs_seed), qp,
                              backend, device)
            ref = np.fromfile(out, np.uint8)

            label = f"fuzz[{case}] {w}x{h} qp={qp} bs={'rand' if bs_seed else 'intra'}"
            total = int(np.sum(ours != ref))
            if total == 0:
                print(f"{label}: IDENTICAL")
                continue
            dy, du, dv = _masked_planes(ours, ref, w, h)
            if dy + du + dv == 0:
                print(f"{label}: {total} byte diffs, ALL inside reference-UB regions (OK)")
            else:
                print(f"{label}: REAL DIVERGENCE outside UB regions "
                      f"(Y {dy}, U {du}, V {dv} of {total} total)")
                failures += 1
    print(f"fuzz: {n_cases} cases, {failures} real divergences")
    return 1 if failures else 0


def fullscale(ref_dir: str, w: int = 1920, h: int = 1080, qp: int = 35,
              backend: str = "cuda", device: str = "cuda") -> int:
    """Production-scale byte-compare and thread-determinism run.

    1080p is the Q9 ROW-truncation case at real scale: extended chroma
    height 548 is not 8-aligned, so the reference's chroma sweep covers only
    68 * 8 = 544 of the 548 extended rows.  The compiled reference runs at
    REF_THREADS=1 and =4 on a synthetic gradient+noise frame (both filter
    branches active at QP 35): the two outputs must be byte-identical to
    each other, and the backend to them outside the UB regions (the
    reference's chroma BS reads for the last sweep tile row go past its
    arrays, Q2; the port pins those reads to 0)."""
    rng = np.random.default_rng(1080)
    yy = ((np.arange(h)[:, None] * 3 + np.arange(w)[None, :] * 2
           + rng.integers(-6, 7, (h, w))) % 256).astype(np.uint8)
    cw, ch = w // 2, h // 2
    uu = ((np.arange(ch)[:, None] + rng.integers(-4, 5, (ch, cw))) % 256).astype(np.uint8)
    vv = ((np.arange(cw)[None, :] + rng.integers(-4, 5, (ch, cw))) % 256).astype(np.uint8)
    raw = np.concatenate([yy.ravel(), uu.ravel(), vv.ravel()])

    failures = 0
    with tempfile.TemporaryDirectory() as td:
        exe = build_reference(ref_dir, td)
        inp = os.path.join(td, "in.yuv")
        raw.tofile(inp)
        outs = {}
        for nt in (1, 4):
            out = os.path.join(td, f"out_{nt}.yuv")
            env = dict(os.environ, REF_THREADS=str(nt))
            subprocess.run([exe, inp, str(w), str(h), str(qp), out], env=env, check=True)
            outs[nt] = np.fromfile(out, np.uint8)
        det = int(np.sum(outs[1] != outs[4]))
        print(f"fullscale {w}x{h} qp={qp}: 1-thread vs 4-thread reference: "
              f"{'IDENTICAL' if det == 0 else f'{det} byte diffs (RACE?)'}")
        failures += det != 0

        ours = deblocked(planes_from_yv12_bytes(raw, w, h), BoundaryStrength.intra_default(w, h),
                          qp, backend, device)
        strict = int(np.sum(ours != outs[1]))
        changed = int(np.sum(outs[1] != raw))
        real = sum(_masked_planes(ours, outs[1], w, h))
        if real == 0:
            verdict = ("IDENTICAL" if strict == 0 else
                       f"IDENTICAL outside reference-UB regions "
                       f"({strict} diffs, all in the Q2xQ9 last chroma "
                       f"tile row)")
        else:
            verdict = f"{real} REAL byte diffs outside UB regions"
        print(f"fullscale {w}x{h} qp={qp}: {backend} vs compiled reference: "
              f"{verdict} ({changed} bytes filtered)")
        failures += real != 0
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gpu_video_codec_tpu_torch.tools.validate_vs_reference",
        description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--fuzz", action="store_true",
                      help="random campaign: [N] [SEED] [MAX_W] [MAX_H] [REF_DIR]")
    mode.add_argument("--fullscale", action="store_true", help="1080p, 1 and 4 threads")
    ap.add_argument("args", nargs="*", help="[REF_DIR], or --fuzz's five")
    ap.add_argument("--backend", choices=TOOL_BACKENDS, default="cuda")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the cuda and torch backends (default cuda)")
    a = ap.parse_intermixed_args(argv)
    if len(a.args) > (5 if a.fuzz else 1):
        ap.error(f"too many arguments: {a.args}")
    if a.fuzz:
        try:
            nums = [int(x) for x in a.args[:4]]
        except ValueError as e:
            ap.error(str(e))
        n, seed, max_w, max_h = nums + [30, 0, 128, 96][len(nums):]
        ref_dir = a.args[4] if len(a.args) > 4 else os.environ.get(REF_ENV)
    else:
        ref_dir = a.args[0] if a.args else os.environ.get(REF_ENV)
    if not ref_dir:
        print(f"no reference checkout given; pass REF_DIR or set {REF_ENV}", file=sys.stderr)
        return 2
    header = os.path.join(ref_dir, HEADER)
    if not os.path.exists(header):
        print(f"reference header not found at {header}; pass REF_DIR", file=sys.stderr)
        return 2
    if a.fuzz:
        return fuzz(ref_dir, n, seed=seed, max_w=max_w, max_h=max_h, backend=a.backend,
                    device=a.device)
    if a.fullscale:
        return fullscale(ref_dir, backend=a.backend, device=a.device)
    return cases(ref_dir, backend=a.backend, device=a.device)


if __name__ == "__main__":
    sys.exit(main())
