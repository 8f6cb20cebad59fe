#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one CUDA GPU.

    python3 chip_smoke.py

0. Builds the kernels from gpu_video_codec_tpu_torch/csrc, one nvcc per
   library (deblock, relayout, SWAR), and the native CPU runtime
   (gpu_video_codec_tpu_torch/runtime/src, g++), all started together;
   prints ptxas's registers, spills and shared memory and the static SASS
   count of every kernel entry (parsed by gpu_video_codec_tpu_torch/tools/
   sass.py); checks that swar_exp --ops reads the same counts for K1's and
   T1's W8 entries, luma and chroma; checks that no entry of the quad kernels
   (K1, K1c, K1-i16, K1-i16c, T1, T5 on both staging routes) spills and
   that K1/K1c at T = int keep the registers and SASS counts they had
   before the compute type became a template parameter (QUAD_INT_COUNTS);
   prints the commonest static SASS opcodes of the luma entries of K1,
   K1-i16, T1 and T5 (TMA and byte words); and prints, from the CUDA
   runtime, blocks and warps per SM and the staging word for K1/K1c at TB
   32 and 64 tiles per block (with the 1080p grids' waves), for
   K1-i16/K1-i16c at their default TB, for T1 at its default block of
   pairs at the race grid, and T5's route, blocks per SM and shared memory
   at the race grid (TMA) and at Bx 241 (words); and that K2 (the packed
   step's kernel) and K2-10 (its 10-bit instance) do not spill and keep to
   64 registers, each with the registers and static SASS of its tile in
   registers (K2_COUNTS), with their blocks and warps per SM and shared
   memory.
1. Holds each variant of the deblock kernel against its plain PyTorch
   version on the card, byte for byte, at the main path's grids (1080p luma
   and U+V chroma), a sheared chroma grid, tail grids (Bx 5, 1, 31, 33,
   65) and a batched luma grid, over QP {0,17,30,35,51}, at TB 32 and 64.
1b. Holds the relayout kernels T2 (plane -> tile-planes) and T3 (the
   inverse) and the pack kernel T4 against their plain versions, byte for
   byte: 1080p luma and U+V, the sheared 360x288 chroma core, a tail grid,
   a batch of four 1080p frames; views that start 1-15 bytes past a 16-byte
   boundary on either side, with row strides that are not multiples of 4,
   at 1080p and at Bx in {1, 2, 15, 16, 17, 31, 33} with pad 0 and 4 (no
   byte outside the destination view may change); T3 straight into the
   rows of a packed 1080p frame (out=); T4 at 1080p and 360x288.
   The flat view (Q9, flat=True): T2 with its flat tail and T3 from it or
   in place, on the sheared 360x288 and 1928x1080 U+V pairs and the 1080p
   extended pair with pad 0.
1c. Holds K1-i16 and K1-i16c (the quad kernel at int16_t) at TB 32 and 64,
   T5 (the quad on the rows layout) and T1 (SWAR, a quad of four lanes per
   tile pair) against their plain versions, and K1-i16 and T1 against K1,
   byte for byte, over QP {0,17,30,35,51}: 1080p luma and U+V grids, the
   race grid (136, 256), the sheared chroma stack, tail grids (a batched
   one with per-frame maps; for T1 Bx/2 = 35 and 36, staged in byte and
   4-byte words); T5 at (136, 8, 8, 256) and (136, 8, 8, 272) (TMA),
   (136, 8, 8, 241), (3, 8, 8, 5) and a race-grid view 8 bytes past a
   16-byte boundary (words), luma and chroma, on blocky tiles, on noise and
   with every BS byte 0 (which returns the input), printing each case's
   route; T1 with every BS byte 0 returns its input; T1 refuses an odd
   Bx.
2. Runs the CLI on the three bundled frames, and StreamingDeblocker on a
   synthetic 1920x1080 frame and a sheared 360x288 frame, against the
   golden NumPy oracle.
2b. The int16 frame path: deblock_frame_cuda(dtype=torch.int16) on a
   synthetic 1920x1080 frame and a sheared 360x288 frame == golden, with
   exactly one K1-i16 luma and one chroma launch, three T2 and three T3 per
   frame (luma, U, V; no plain relayout or stacking copy on the card).
2c. The three experiments' entry points (gpu_video_codec_tpu_torch/tools:
   int16_probe, rowslayout_exp, swar_exp --check and --race) on the card,
   each reporting bit-exact.
2d. Inside phase 2: tools.psnr on the CLI's output (its default backend,
   cuda) of the bundled mother-daughter frame at QP 35 against golden's
   (identical, null PSNR) and on the unfiltered input against it (finite
   PSNRs).
3. Streams 16 distinct 1080p frames through StreamingDeblocker.run (the
   main path: a ring of device slots whose steps are CUDA graph replays,
   with the read-back overlapped), checks each against the plain backend
   on the card and that each frame launched K2 once, counting replays;
   then again with luma_only, across a mid-stream update_boundary_strength
   (after the ring's graphs were captured), and a sheared 360x288 stream,
   which K2's guard leaves to T2 twice, K1 and K1c once and T3 twice.
3b. The device-resident path (ResidentDeblocker): == golden at 1920x1080
   and 360x288; a batch of four distinct 1080p frames through ingest, three
   steps and readback == the plain backend, with exactly 2 T2, 3 K1, 3 K1c,
   2 T3 and 1 T4 launches; luma_only (no K1c, chroma untouched); a BS
   update between steps.
3c. CUDA graphs against eager steps of the plain backend on a copy, byte
   for byte, on blocky frames at QP 35: StreamingDeblocker._chain(buf, n)
   at 1920x1080 for n in {1, 3, 50} (n K2 launches) and at the sheared
   360x288 for n = 3 (n x (T2 2, K1 1, K1c 1, T3 2)), at the capturing call
   and at a replay alone; ResidentDeblocker.run_steps(tf, 3) on one 1080p
   frame and a batch of four (K1 3, K1c 3 per call): two successive results
   both right, in memory of their own, and the input state unchanged.
3d. The driver layer: DeblockPipeline at 1920x1080 with the cuda, torch,
   golden and native backends, byte-equal to golden, the cuda backend with
   T2 3, K1 1, K1c 1, T3 3 per frame; batch() of four frames == four single
   calls, with one K1 and one K1c (T2 2, T3 2); the host-to-host time per
   frame of both and the native runtime's at 1, 2, 4 and 8 threads, with
   the host's CPU model and nproc.
3e. compat: ReadYuvFrame (cuda and native) on the three bundled frames ==
   golden; ExecuteCpu's thread sweep and ExecuteGpu's kernel_s, h2d_s and
   total_s at 1080p (through K2), printed, each output == golden.
3f. The CLI with --backend native --num-threads 2 --bench == golden; the
   three examples (gpu_video_codec_tpu_torch/examples) on the card.
3g. Sheared chroma (Q9) at 360x288: a 4-frame stream, a resident batch of
   four and a pipeline batch of four == golden with their exact launches;
   the sheared _step's device time; torch.profiler lists the kernels of a
   graph-replayed _step and of a resident ingest + step + readback: the
   port's T2, K1, K1c, T3 (and T4) and no other.
4. Times K1 and K1c at TB 32 and 64 in turns with their plain versions,
   K2 at the benchmark cells' shapes, (16, 1620, 1920) and (4, 3240, 3840),
   in turns with the chain it replaces and its plain version beside its
   byte bound, K2-10 on 4 4K Main 10 frames against its plain version,
   byte for byte, then in turns with it beside its byte bound (2 bytes a
   sample), the packed step (a graph replay) and the copy with CUDA
   events; prints
   time_breakdown(measure_d2h=True) (dispatch per replayed step beside an
   eager step's, the profiler's device split, the synchronous end-to-end
   frame).
4b. Times T2, T3 and T4 at the 1080p shapes beside their plain versions
   and a one-call PyTorch yardstick (printing kernel / yardstick and the
   fraction of the byte bound), and the resident step, ingest and readback
   at 1080p, batch 1 and 4, with the host dispatch per eager step and per
   step of run_steps and the device time of run_steps' copy-out.
4c. Lists the device kernels by name and time (torch.profiler) for the
   resident path and the streaming packed step at 1080p, replayed from its
   graph and run eagerly; the replay runs K2 and no other kernel (no
   relayout, layout copy, fill or write-back), and
   utils.tracing.profiled_device_us's total agrees with the profiler's
   key_averages() within 2%.  Both take each kernel's mean launch times its
   launches per call (utils.tracing.per_iter_us).
3h. The mesh paths (gpu_video_codec_tpu_torch/parallel) on slots of
   cuda:0: MultiStreamDeblocker at 1920x1080, 4 streams x 8 steps, depth
   2, on a (1, 1) mesh == the plain backend (the first and last batch ==
   golden, computed in four worker processes), again with a BS swap
   before batch 3 (earlier batches in flight) and with luma_only; the
   sheared 360x288 with 4 streams (== golden); 3840x2160 with 2 streams x
   2 steps; 3 streams on [cuda:0] * 2 as (1, 2) (chunks of 2 and 1);
   deblock_batch_sharded of extended 1080p planes on (1, 2) and (1, 3)
   slots (uneven slabs), eager and as graph replays, == one slot;
   MeshResidentDeblocker, a batch of 4 x 3 steps on (2, 1) slots ==
   ResidentDeblocker; the CLI --streams 4 --mesh 1,1 on 10 frames ==
   golden, tail included.  Every run's launches: K2 1 per slot and batch
   (T2 2, K1 1, K1c 1, T3 2 at the sheared width); the profile of the
   batched packed step holds K2 alone.  The Main 10 packed step through
   deblock_packed_batch_sharded and _jit on a (1, 1) mesh at (4, 3240,
   3840) int16 with random BS, twice each (the jit's capture and replay,
   then a replay alone): in place, == its plain version sample for sample,
   one K2-10 launch a call and no other kernel.  One Main 4:2:2 10 call at
   (4, 4320, 3840) int16 the same way.  Main 4:4:4 at (4, 6480, 3840)
   uint8 and Main 4:4:4 10 at its int16 twin through the _jit entry, two
   calls each: the plain version == bench_torch/references/hevc_deblock.py,
   and in place == both, one K2 (K2-10) launch a call under packed_444
   (packed10_444) and no other kernel.
4d. Times the quad K1 against K1-i16 (the quad at int16_t), T5 (the quad
   on the rows layout, TMA-staged) and T1 (a quad per tile pair) in turns
   at the race grid (136, 256), on blocky tiles, on uniform noise (cond1
   fails almost everywhere) and with every BS byte 0 (no segment filtered:
   what a design pays per tile whatever the content), T5 also at Bx 241
   (its words route), and K1-i16 luma and chroma at the 1080p grids beside
   K1/K1c, each beside its plain version and its byte bound.
4e. Times the batched packed step at 1080p for k = 1, 4 and 8 frames
   beside the single-frame _step (CUDA events, in turns), and the frames
   per second of MultiStreamDeblocker.run at 4 streams x 1080p against
   StreamingDeblocker.run on the same frames, with and without read-back
   (host wall clock, in turns).
5c. The fuzz cases of tools/validate_vs_reference.py (fuzz_cases, seed 0:
   48 frames up to 128x96 and 8 up to 1024x576; sheared widths, QPs 0-60,
   random data, the LCG's luma BS in about half) through
   DeblockPipeline(backend="cuda"), each extended plane byte-equal to
   golden, with T2 3, K1 1, K1c 1 and T3 3 launches a frame; then through
   the packed streaming step (the tool's --backend packed), each frame ==
   golden, K2 once a frame where its guard takes the width (w % 32 == 0),
   T2 2, K1, K1c, T3 2 elsewhere.

Exits non-zero at the first failure.  Prints the card's name and power
limit, a JSON line of per-kernel results, and last a JSON line with
"ok": true.  Needs one CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import redirect_stdout

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
QPS = (0, 17, 30, 35, 51)
BLOCKS = (32, 64)  # K1/K1c tiles per block (TB) held and timed
KERNEL_SOURCE = "gpu_video_codec_tpu_torch/csrc/deblock_kernel.cu"
TPU_KERNEL = "gpu_video_codec_tpu/ops/pallas_kernel.py:71"
RELAYOUT_SOURCE = "gpu_video_codec_tpu_torch/csrc/relayout_kernel.cu"
SWAR_SOURCE = "gpu_video_codec_tpu_torch/csrc/swar_kernel.cu"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak bandwidth
RACE_SHAPE = (8, 8, 136, 256)  # the race grid of rowslayout_exp and swar_exp
# deblock_quad_kernel<CHROMA, W> before its compute type became a template
# parameter: (CHROMA, W) -> (ptxas registers, cuobjdump static SASS count)
# with CUDA 12.8's nvcc for sm_90a; T = int must compile to the same
QUAD_INT_COUNTS = {(False, 8): (47, 960), (False, 1): (46, 1032), (False, 4): (53, 992),
                   (True, 8): (32, 384), (True, 1): (44, 416), (True, 4): (32, 384)}
# deblock_packed_kernel<BD> with the lanes' tile in registers, BD -> (ptxas
# registers, static SASS count) with CUDA 12.8's nvcc for sm_90a; a change
# that moves them is a change to K2 or K2-10 to measure
K2_COUNTS = {8: (38, 1376), 10: (39, 1496)}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def blocky_frame(rng, w, h, ch=None, cw=None):
    """Packed YV12 frame: piecewise-flat 8x8 blocks with noise, so every
    filter branch runs; chroma planes of ch rows (default h/2; h for a
    4:2:2 or 4:4:4 frame) and cw columns (default w/2; w for 4:4:4)."""
    ch = h // 2 if ch is None else ch
    cw = w // 2 if cw is None else cw
    def plane(hh, ww):
        steps = rng.integers(-14, 15, (hh // 8 + 1, ww // 8 + 1))
        means = 128 + np.cumsum(steps, axis=1) // 2 + np.cumsum(steps, axis=0) // 3
        img = np.kron(means, np.ones((8, 8), np.int64))[:hh, :ww]
        return np.clip(img + rng.integers(-2, 3, img.shape), 0, 255).astype(np.uint8)
    return np.concatenate([plane(h, w).ravel(), plane(ch, cw).ravel(), plane(ch, cw).ravel()])


def golden_packed(args) -> bytes:
    """(raw packed frame, w, h) -> the golden oracle's packed output at QP
    35 (run in worker processes: a 1080p frame takes seconds)."""
    from gpu_video_codec_tpu_torch.models.golden import deblock_frame_golden
    from gpu_video_codec_tpu_torch.utils.bs import BoundaryStrength
    from gpu_video_codec_tpu_torch.utils.yuv import planes_from_yv12_bytes, yv12_bytes_from_planes

    raw, w, h = args
    return yv12_bytes_from_planes(deblock_frame_golden(
        planes_from_yv12_bytes(raw, w, h), BoundaryStrength.intra_default(w, h), 35))


def bytes_bound_ms(nbytes: int) -> float:
    """The least time to move `nbytes` (each input read once, each output
    written once) at the card's memory rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from gpu_video_codec_tpu_torch import compat
    from gpu_video_codec_tpu_torch.examples import one_shot, resident_chain, streaming
    from gpu_video_codec_tpu_torch.models.golden import deblock_frame_golden
    from gpu_video_codec_tpu_torch.models.pipeline import DeblockPipeline
    from gpu_video_codec_tpu_torch.models.resident import ResidentDeblocker, _readback
    from gpu_video_codec_tpu_torch.models.streaming import StreamingDeblocker
    from gpu_video_codec_tpu_torch.ops import cuda_kernel as ck
    from gpu_video_codec_tpu_torch.ops import relayout_kernel as rk
    from gpu_video_codec_tpu_torch.ops import swar_kernel as sk
    from gpu_video_codec_tpu_torch.ops.chain import deblock_frame_cuda, tile_chain
    from gpu_video_codec_tpu_torch.ops.deblock import (
        deblock_packed_plain, deblock_rows_plain, deblock_tiles_plain,
    )
    from gpu_video_codec_tpu_torch.ops.tables import get_beta, get_tc
    from gpu_video_codec_tpu_torch.runtime import native
    from gpu_video_codec_tpu_torch.tools import int16_probe, psnr, rowslayout_exp, sass, swar_exp
    from gpu_video_codec_tpu_torch.tools.kernel_time import blocky_tiles
    from gpu_video_codec_tpu_torch.tools.validate_vs_reference import (
        case_bs, deblocked, fuzz_cases,
    )
    from gpu_video_codec_tpu_torch.utils.bs import (
        BoundaryStrength, chroma_segment_maps, luma_segment_maps,
    )
    from gpu_video_codec_tpu_torch.utils.tiles import split_covered_data
    from gpu_video_codec_tpu_torch.utils.timing import device_ms, in_turns
    from gpu_video_codec_tpu_torch.utils.tracing import per_iter_us, profiled_device_us
    from gpu_video_codec_tpu_torch.utils.yuv import (
        FramePlanes, planes_from_yv12_bytes, yv12_bytes_from_planes,
    )

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = (ck.build_library, rk.build_library, sk.build_library)
    with ThreadPoolExecutor(len(libs) + 1) as pool:  # one compiler per library, together
        native_build = pool.submit(native.build_library)  # g++, the host runtime
        builds = list(pool.map(lambda build: build(), libs))
        native_lib = native_build.result()
    print(f"kernel build (three CUDA libraries and the native runtime): "
          f"{time.perf_counter() - t0:.1f} s; native -> {os.path.relpath(native_lib, REPO)}")
    nvcc = ck._nvcc()
    entries = {}  # mangled name -> {"registers", "spill_stores", "spill_loads", "smem", "sass"}
    for path, log in builds:
        print(f"  -> {os.path.relpath(path, REPO)}")
        for line in log.splitlines():
            if any(k in line for k in ("entry function", "registers", "spill", "smem")):
                print(f"  ptxas: {line.strip()}")
        for mangled, e in sass.ptxas_entries(log).items():
            entries.setdefault(mangled, {"sass": None}).update(e)
        try:
            listing = sass.static_sass(path, nvcc)
        except FileNotFoundError:
            print("  sass: cuobjdump not found (instruction counts not measured)")
            continue
        for mangled, (n, opcodes) in listing.items():
            print(f"  sass: {sass.demangle(mangled)}: {n} instructions (static)")
            e = entries.setdefault(mangled, {"smem": 0})
            e["sass"], e["opcodes"] = n, opcodes
    # the quad kernels' entries by (kernel, CHROMA, W, compute type), from
    # their mangled names: deblock_quad_kernel<CHROMA, W, T> (T int for K1,
    # short for K1-i16), swar_quad_kernel<CHROMA, W> (T1) and
    # deblock_rows_quad_kernel<CHROMA, Staging> (T5; W 0 for RowsTma, the
    # TMA route, else RowsWords<W>)
    quads = {}
    for mangled, e in entries.items():
        if m := re.search(r"deblock_quad_kernelILb([01])ELi(\d)E([is])E", mangled):
            quads["K1" if m.group(3) == "i" else "K1-i16", m.group(1) == "1", int(m.group(2))] = e
        elif m := re.search(r"swar_quad_kernelILb([01])ELi(\d)EE", mangled):
            quads["T1", m.group(1) == "1", int(m.group(2))] = e
        elif m := re.search(r"deblock_rows_quad_kernelILb([01])E\w*?(?:RowsTma|RowsWordsILi(\d)E)",
                            mangled):
            quads["T5", m.group(1) == "1", int(m.group(2) or 0)] = e
    check(len(quads) == 26, f"expected 26 quad entries (K1, K1-i16, T1 x chroma x W; T5 x "
                            f"chroma x staging), found {sorted(quads)}")
    for key, e in sorted(quads.items()):
        check(e.get("spill_stores") == 0 and e.get("spill_loads") == 0,
              f"{key}: spills ({e.get('spill_stores')} B stored, {e.get('spill_loads')} B loaded)")
        if key[0] == "K1":
            want = QUAD_INT_COUNTS[key[1:]]
            got = (e.get("registers"), e["sass"] if e["sass"] is not None else want[1])
            check(got == want, f"K1 quad {key[1:]} at T = int: (registers, static SASS) {got}, "
                               f"was {want} before the compute type became a parameter")
    # deblock_packed_kernel<BD>: K2 (BD 8) and K2-10 (BD 10)
    k2_entries = {int(m.group(1)): e for mangled, e in entries.items()
                  if (m := re.search(r"deblock_packed_kernelILi(\d+)EE", mangled))}
    check(sorted(k2_entries) == [8, 10] and all(
        e.get("spill_stores") == 0 and e.get("spill_loads") == 0
        and (e.get("registers") or 99) <= 64 for e in k2_entries.values()),
          f"K2 and K2-10 (deblock_packed_kernel<8>, <10>): one entry each, no spills, at most "
          f"64 registers: {k2_entries}")
    for bd, e in sorted(k2_entries.items()):
        want = K2_COUNTS[bd]
        got = (e.get("registers"), e["sass"] if e.get("sass") is not None else want[1])
        check(got == want, f"deblock_packed_kernel<{bd}>: (registers, static SASS) {got}, "
                           f"pinned at {want}")
    k2_info = ck.deblock_packed_info(dev)
    for bd, name in ((8, "K2"), (10, "K2-10")):
        e, info = k2_entries[bd], ck.deblock_packed_info(dev, bit_depth=bd)
        print(f"{name} deblock_packed_kernel<{bd}>: {e.get('registers')} registers, no spills, "
              f"{info['smem_bytes']} B shared memory, {info['threads']} threads "
              f"({info['tiles_per_block']} tiles) per block, {info['blocks_per_sm']} blocks = "
              f"{info['warps_per_sm']} warps per SM, static SASS {e.get('sass')}")
    for key in (("K1", False, 8), ("K1-i16", False, 8), ("T1", False, 8), ("T5", False, 0),
                ("T5", False, 1)):
        if quads[key].get("opcodes"):
            print(f"static SASS opcodes of {key[0]} luma, "
                  f"{f'{key[2]}-byte words' if key[2] else 'TMA'}: " + ", ".join(
                      f"{op} {n}" for op, n in quads[key]["opcodes"].most_common(12)))
    print("quad entries, (chroma, W; T5's W0 the TMA route): registers / spills / smem / "
          "static SASS: " + "; ".join(
        f"{k} {c} W{w} {e.get('registers')} / {e.get('spill_stores')} / {e['smem']} / {e['sass']}"
        for (k, c, w), e in sorted(quads.items()))
          + "; K1 at T = int unchanged, no spills")
    ops = swar_exp.main(["--ops"])
    for key, quad in (("int32", ("K1", False, 8)), ("int32_chroma", ("K1", True, 8)),
                      ("swar", ("T1", False, 8)), ("swar_chroma", ("T1", True, 8))):
        check(ops[f"{key}_sass_static"] == quads[quad]["sass"],
              f"swar_exp --ops {key}: {ops[f'{key}_sass_static']} static SASS, phase 0 "
              f"{quads[quad]['sass']} for {quad}")
    print(f"swar_exp --ops == phase 0's counts: K1 luma W8 {ops['int32_sass_static']}, T1 "
          f"{ops['swar_sass_static']} (lane-equivalent {ops['swar_lane_equivalent']}, predicted "
          f"ratio {ops['predicted_ratio_vs_int32']}); chroma {ops['int32_chroma_sass_static']}, "
          f"{ops['swar_chroma_sass_static']} ({ops['predicted_chroma_ratio_vs_int32']})")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grids_1080p = {"K1": (False, (8, 8, 136, 241)), "K1c": (True, (2, 8, 8, 68, 121))}
    occupancy = {}
    for kname, (chroma, shape) in grids_1080p.items():
        for tb in BLOCKS:
            occ = ck.deblock_tiles_occupancy(shape, chroma=chroma, block_bx=tb, device=dev)
            blocks = -(-shape[-1] * shape[-2] // tb) * (shape[0] if len(shape) == 5 else 1)
            occupancy[kname, tb] = {**occ, "grid_blocks": blocks,
                                    "waves": blocks / (occ["blocks_per_sm"] * sms)}
            print(f"occupancy {kname} TB {tb}: {occ['threads']} threads per block, "
                  f"{occ['blocks_per_sm']} blocks = {occ['warps_per_sm']} warps per SM; the 1080p "
                  f"grid {shape} is {blocks} blocks, {occupancy[kname, tb]['waves']:.2f} waves on "
                  f"{sms} SMs ({4 * occupancy[kname, tb]['waves']:.2f} at batch 4); "
                  f"{occ['word_bytes']}-byte staging accesses")
    for kname, (chroma, shape) in grids_1080p.items():
        occ = ck.deblock_tiles_occupancy(shape, chroma=chroma, device=dev, dtype=torch.int16)
        occupancy[kname.replace("K1", "K1-i16"), occ["block_bx"]] = occ
        print(f"occupancy {kname.replace('K1', 'K1-i16')} TB {occ['block_bx']} (the quad at "
              f"int16_t): {occ['blocks_per_sm']} blocks = {occ['warps_per_sm']} warps per SM, "
              f"{occ['word_bytes']}-byte staging accesses at {shape}")
    occ = sk.swar_occupancy(RACE_SHAPE, device=dev)
    blocks = -(-RACE_SHAPE[-1] // 2 // sk.BLOCK) * RACE_SHAPE[-2]
    occupancy["T1", sk.BLOCK] = {**occ, "grid_blocks": blocks,
                                 "resident_warps_per_sm": blocks * occ["threads"] // 32 / sms}
    print(f"occupancy T1 block {sk.BLOCK} pairs: {occ['threads']} threads per block, "
          f"{occ['blocks_per_sm']} blocks = {occ['warps_per_sm']} warps per SM at most; the race "
          f"grid {RACE_SHAPE} is {blocks} blocks, "
          f"{occupancy['T1', sk.BLOCK]['resident_warps_per_sm']:.1f} warps per SM; "
          f"{occ['word_bytes']}-byte staging accesses")
    for kname, shape in (("T5", RACE_SHAPE), ("T5 1080p width", (8, 8, 136, 241))):
        rows = torch.empty((shape[2], 8, 8, shape[3]), dtype=torch.uint8, device=dev)
        occ = ck.deblock_rows_occupancy(rows)
        blocks = -(-shape[3] // ck.ROWS_BLOCK_BX) * shape[2]
        occupancy[kname] = {**occ, "grid_blocks": blocks,
                            "resident_warps_per_sm": blocks * occ["threads"] // 32 / sms}
        print(f"occupancy {kname} {tuple(rows.shape)}, TB {ck.ROWS_BLOCK_BX}: route "
              f"{occ['route']}" + (f" ({occ['word_bytes']}-byte words)" if occ["word_bytes"]
                                   else "") + f", {occ['blocks_per_sm']} blocks = "
              f"{occ['warps_per_sm']} warps per SM at most, {occ['smem_bytes']} B shared memory "
              f"per block, {occ['registers']} registers; {blocks} blocks, "
              f"{occupancy[kname]['resident_warps_per_sm']:.1f} warps per SM")
    check(occupancy["T5"]["route"] == "tma" and occupancy["T5 1080p width"]["route"] == "words",
          f"T5's routes: {occupancy['T5']['route']} at {RACE_SHAPE}, "
          f"{occupancy['T5 1080p width']['route']} at Bx 241")
    rng = np.random.default_rng(2026)

    def counts() -> dict:
        """Launches since the last reset(), by kernel."""
        return {"T2": rk.LAUNCHES["fwd"], "K1": ck.LAUNCHES["luma"],
                "K1c": ck.LAUNCHES["chroma"], "T3": rk.LAUNCHES["inv"],
                "T4": rk.LAUNCHES["pack"], "K1-i16": ck.LAUNCHES["luma_i16"],
                "K1-i16c": ck.LAUNCHES["chroma_i16"], "T5": ck.LAUNCHES["rows"],
                "T1": sk.LAUNCHES["swar"], "K2": ck.LAUNCHES["packed"],
                "K2-10": ck.LAUNCHES["packed10"], "K2 4:2:2": ck.LAUNCHES["packed_422"],
                "K2-10 4:2:2": ck.LAUNCHES["packed10_422"], "K2 4:4:4": ck.LAUNCHES["packed_444"],
                "K2-10 4:4:4": ck.LAUNCHES["packed10_444"]}

    def reset() -> None:
        for d in (ck.LAUNCHES, rk.LAUNCHES, sk.LAUNCHES):
            d.update(dict.fromkeys(d, 0))

    def only(**launches) -> dict:
        """counts() as it should read when only `launches` ran."""
        return {**dict.fromkeys(counts(), 0), **launches}

    def packed_steps(ww: int, n: int, luma_only: bool = False) -> dict:
        """The launches of n packed steps of a ww-wide frame on fresh (so
        aligned) buffers: K2 once each where its guard takes the width,
        else T2 2, K1, K1c, T3 2 (T2, K1, T3 under luma_only)."""
        if ck.packed_fits(ww):
            return {"K2": n}
        c = 0 if luma_only else n
        return {"T2": n + c, "K1": n, "K1c": c, "T3": n + c}

    max_err = dict.fromkeys(counts(), 0)  # max |kernel - plain| by kernel, phases 1-1c

    def same(kind: str, what: str, got, ref) -> None:
        """Hold a kernel's output against its plain version, byte for byte."""
        torch.cuda.synchronize()
        check(got.shape == ref.shape, f"{kind}: {what} shape {tuple(got.shape)} != "
                                      f"{tuple(ref.shape)}")
        diff = int((got.int() - ref.int()).abs().max()) if got.numel() else 0
        max_err[kind] = max(max_err[kind], diff)
        check(diff == 0, f"{kind} vs plain: {what} max |diff| {diff}")

    # -- 1. kernel vs plain on the card ----------------------------------------
    cases = [  # (name, chroma, tiles shape, map shape)
        ("luma 1080p", False, (8, 8, 136, 241), (136, 241)),
        ("chroma U+V 1080p shared map", True, (2, 8, 8, 68, 121), (1, 68, 121)),
        ("chroma sheared 360x288 U|V stacked", True, (8, 8, 38, 23), (38, 23)),
        ("luma tail", False, (8, 8, 3, 5), (3, 5)),
        ("chroma tail", True, (8, 8, 3, 5), (3, 5)),
        ("luma batched per-frame maps", False, (3, 8, 8, 136, 241), (3, 136, 241)),
    ] + [(f"{'chroma' if chroma else 'luma'} tail Bx {bx}", chroma, (8, 8, 2, bx), (2, bx))
         for bx in (1, 31, 33, 65) for chroma in (False, True)]
    for name, chroma, shape, mshape in cases:
        for qp in QPS:
            tiles = torch.from_numpy(blocky_tiles(rng, shape)).to(dev)
            maps = [torch.from_numpy(rng.integers(0, 3, mshape, dtype=np.uint8)).to(dev)
                    for _ in range(4)]
            beta, tc = get_beta(qp), get_tc(qp)
            ref = deblock_tiles_plain(tiles, *maps, beta, tc, chroma=chroma)
            for tb in BLOCKS:
                out = ck.deblock_tiles_cuda(tiles, *maps, beta, tc, chroma=chroma, block_bx=tb)
                same("K1c" if chroma else "K1", f"{name} qp {qp} TB {tb}", out, ref)
        print(f"kernel == plain: {name} {shape}, QP {list(QPS)}, TB {list(BLOCKS)}")

    # -- 1b. relayout and pack kernels vs plain on the card ------------------------
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
        same("T2", what, t, rk.plane_to_tiles_plain(x, pad, *grid))
        rnd = torch.randint(0, 256, t.shape, dtype=torch.uint8, device=dev)
        for tiles in (t, rnd):
            same("T3", what, rk.tiles_to_plane_cuda(tiles, pad, hh, ww),
                 rk.tiles_to_plane_plain(tiles, pad, hh, ww))
        if x.dim() == 3 and x.shape[0] == 2:  # U and V land as (8, 8, 2, cBy, cBx)
            stacked = torch.zeros((8, 8, 2, *t.shape[-2:]), dtype=torch.uint8, device=dev)
            rk.plane_to_tiles_cuda(x, pad, out=stacked.movedim(2, 0))
            same("T2", what + " into the U-over-V stack", stacked.movedim(2, 0), t)
            same("T3", what + " from the U-over-V stack",
                 rk.tiles_to_plane_cuda(stacked.movedim(2, 0), pad, hh, ww), x)
        print(f"T2/T3 == plain: {what} {tuple(x.shape)} -> {tuple(t.shape)}")
    uv1928 = torch.from_numpy(rng.integers(0, 256, (2, 540, 964), dtype=np.uint8)).to(dev)
    for what, x, pad in (
            ("sheared 360x288 U+V", cif[360 * 288 :].reshape(2, 144, 180), 4),
            ("sheared 1928x1080 U+V (tail holds rows)", uv1928, 4),
            ("1080p extended U+V, pad 0", torch.nn.functional.pad(uv1, (4, 4, 4, 4)), 0)):
        hh, ww = x.shape[-2:]
        rem = torch.empty((2, rk.flat_view(hh, ww, pad)[2]), dtype=torch.uint8, device=dev)
        t = rk.plane_to_tiles_cuda(x, pad, flat=True, rem_out=rem)
        same("T2", what + ", flat view", t, rk.plane_to_tiles_plain(x, pad, flat=True))
        same("T2", what + ", flat tail", rem, rk.flat_tail_plain(x, pad))
        rnd = torch.randint(0, 256, t.shape, dtype=torch.uint8, device=dev)
        same("T3", what + ", flat view", rk.tiles_to_plane_cuda(rnd, pad, hh, ww, flat=True,
                                                                rem=rem),
             rk.tiles_to_plane_plain(rnd, pad, hh, ww, True, rem))
        dst = x.clone()
        rk.tiles_to_plane_cuda(rnd, pad, hh, ww, out=dst, flat=True)
        same("T3", what + ", flat view in place", dst,
             rk.tiles_to_plane_plain(rnd, pad, hh, ww, True, None, x))
        print(f"T2/T3 flat view == plain: {what} {tuple(x.shape)} -> {tuple(t.shape)}, "
              f"tail {rem.shape[-1]} bytes")

    def at_residue(shape, off, row_pad=3):
        """A random uint8 view of `shape` on the card that starts `off` bytes
        past a 16-byte boundary, rows row_pad bytes wider than long, outer
        strides one byte more than the extent inside them.  Returns (view,
        the whole buffer)."""
        strides = [shape[-1] + row_pad, 1]
        for n in reversed(shape[1:-1]):
            strides.insert(0, strides[0] * n + 1)
        size = sum((n - 1) * st for n, st in zip(shape, strides)) + 1 + 32
        big = torch.randint(0, 256, (size,), dtype=torch.uint8, device=dev)
        start = (off - big.data_ptr()) % 16
        return torch.as_strided(big, shape, strides, start), big

    def expect(big, view, value):
        want = big.clone()
        torch.as_strided(want, view.shape, view.stride(), view.storage_offset()).copy_(value)
        return want

    misaligned = [("1080p luma", (), 1080, 1920, 4, 1, 7), ("1080p luma", (), 1080, 1920, 4, 12, 0),
                  ("1080p U+V", (2,), 540, 960, 4, 13, 3), ("1080p U+V", (2,), 540, 960, 4, 0, 9)]
    misaligned += [(f"Bx {bx}", lead, 12 if pad else 16, 8 * bx - 2 * pad, pad, bx % 16,
                    (3 * bx + 5) % 16)
                   for bx in (1, 2, 15, 16, 17, 31, 33) for pad in (0, 4) if 8 * bx > 2 * pad
                   for lead in ((), (2,))]
    for what, lead, hh, ww, pad, p_off, t_off in misaligned:
        byg, bxg = (hh + 2 * pad) // 8, (ww + 2 * pad) // 8
        x, _ = at_residue((*lead, hh, ww), p_off)
        t, tbig = at_residue((*lead, 8, 8, byg, bxg), t_off)
        want = expect(tbig, t, rk.plane_to_tiles_plain(x, pad))
        rk.plane_to_tiles_cuda(x, pad, out=t)
        same("T2", f"{what} {lead} pad {pad}, plane at +{p_off}, tiles at +{t_off}", tbig, want)
        back, bbig = at_residue((*lead, hh, ww), p_off)
        want = expect(bbig, back, rk.tiles_to_plane_plain(t, pad, hh, ww))
        rk.tiles_to_plane_cuda(t, pad, hh, ww, out=back)
        same("T3", f"{what} {lead} pad {pad}, tiles at +{t_off}, plane at +{p_off}", bbig, want)
    print(f"T2/T3 == plain at {len(misaligned)} misaligned or odd-Bx geometries, "
          f"bytes outside the views untouched")
    packed = frames4[1].reshape(3 * h // 2, w).clone()
    keep = packed.clone()
    t_y = torch.randint(0, 256, (8, 8, 136, 241), dtype=torch.uint8, device=dev)
    t_uv = torch.randint(0, 256, (2, 8, 8, 68, 121), dtype=torch.uint8, device=dev)
    rk.tiles_to_plane_cuda(t_y, 4, h, w, out=packed[:h])
    same("T3", "1080p luma into the packed frame's rows (out=)", packed[:h],
         rk.tiles_to_plane_plain(t_y, 4, h, w))
    same("T3", "chroma rows untouched by the luma out=", packed[h:], keep[h:])
    uv_rows = packed[h:].view(2, h // 2, w // 2)
    rk.tiles_to_plane_cuda(t_uv, 4, h // 2, w // 2, out=uv_rows)
    same("T3", "1080p U+V into the packed frame's rows (out=)", uv_rows,
         rk.tiles_to_plane_plain(t_uv, 4, h // 2, w // 2))
    print("T3 out= == plain: 1080p luma and U+V rows of a packed frame")
    for what, buf, ww, hh in (("1080p", frames4[0], 1920, 1080), ("360x288", cif, 360, 288),
                              ("1080p batch of 4", frames4, 1920, 1080)):
        yn, cn = ww * hh, ww * hh // 4
        planes = (buf[..., :yn], buf[..., yn : yn + cn], buf[..., yn + cn :])
        packed = rk.pack_yv12_cuda(*planes)
        same("T4", what, packed, rk.pack_yv12_plain(*planes))
        same("T4", what + " (round trip)", packed, buf)
        print(f"T4 == plain: {what} -> {tuple(packed.shape)}")

    # -- 1c. K1-i16, T5 and T1 vs their plain versions on the card -------------------
    def tiles_maps(shape, mshape):
        tiles = torch.from_numpy(blocky_tiles(rng, shape)).to(dev)
        maps = [torch.from_numpy(rng.integers(0, 3, mshape, dtype=np.uint8)).to(dev)
                for _ in range(4)]
        return tiles, maps

    for name, chroma, shape, mshape in (
            ("luma 1080p", False, (8, 8, 136, 241), (136, 241)),
            ("luma race grid", False, RACE_SHAPE, RACE_SHAPE[2:]),
            ("luma tail", False, (8, 8, 3, 5), (3, 5)),
            ("luma tail Bx 65, batched per-frame maps", False, (3, 8, 8, 2, 65), (3, 2, 65)),
            ("chroma U+V 1080p shared map", True, (2, 8, 8, 68, 121), (1, 68, 121)),
            ("chroma sheared 360x288 U|V stacked", True, (8, 8, 38, 23), (38, 23)),
            ("chroma tail Bx 33", True, (8, 8, 2, 33), (2, 33))):
        kind = "K1-i16c" if chroma else "K1-i16"
        for qp in QPS:
            tiles, maps = tiles_maps(shape, mshape)
            beta, tc = get_beta(qp), get_tc(qp)
            ref = deblock_tiles_plain(tiles, *maps, beta, tc, chroma=chroma, dtype=torch.int16)
            k1 = ck.deblock_tiles_cuda(tiles, *maps, beta, tc, chroma=chroma)
            for tb in BLOCKS:
                out = ck.deblock_tiles_cuda(tiles, *maps, beta, tc, chroma=chroma,
                                            block_bx=tb, dtype=torch.int16)
                same(kind, f"{name} qp {qp} TB {tb}", out, ref)
                same(kind, f"{name} qp {qp} TB {tb} against K1", out, k1)
        print(f"{kind} == plain == K1: {name} {shape}, QP {list(QPS)}, TB {list(BLOCKS)}")
    # T5 on both routes: TMA where Bx and the rows' address are multiples of
    # 16 (256, 272), words elsewhere (241, 5, and a view 8 bytes past a
    # 16-byte boundary); blocky tiles, uniform noise, every BS byte 0
    for (by, bx), off in (((136, 256), 0), ((136, 241), 0), ((136, 272), 0), ((3, 5), 0),
                          ((136, 256), 8)):
        for chroma in (False, True):
            for content in ("blocky", "noise", "BS 0"):
                for qp in QPS:
                    tiles, maps = tiles_maps((8, 8, by, bx), (by, bx))
                    if content == "noise":
                        tiles = torch.randint(0, 256, tiles.shape, dtype=torch.uint8, device=dev)
                    if content == "BS 0":
                        maps = [torch.zeros_like(m) for m in maps]
                    space = torch.empty(tiles.numel() + 16, dtype=torch.uint8, device=dev)
                    rows = space[off:off + tiles.numel()].view(by, 8, 8, bx)
                    rows.copy_(tiles.permute(2, 0, 1, 3))
                    beta, tc = get_beta(qp), get_tc(qp)
                    what = f"{(by, 8, 8, bx)} +{off} B chroma={chroma} {content} qp {qp}"
                    out = ck.deblock_rows_cuda(rows, *maps, beta, tc, chroma=chroma)
                    same("T5", what, out, deblock_rows_plain(rows, *maps, beta, tc, chroma=chroma))
                    if content == "BS 0":
                        same("T5", what + " returns its input", out, rows)
            occ = ck.deblock_rows_occupancy(rows, chroma=chroma)
            print(f"T5 == plain: {(by, 8, 8, bx)}{f' at {off} B past a 16-byte boundary' if off else ''}"
                  f", {'chroma' if chroma else 'luma'}, blocky / noise / BS 0, QP {list(QPS)}; "
                  f"route {occ['route']}"
                  + (f" ({occ['word_bytes']}-byte words)" if occ["word_bytes"] else ""))
    # T1 stages in 8-byte words where Bx/2 is a multiple of 8, 4-byte words
    # where it is 4 mod 8 and bytes where it is odd
    for name, chroma, (by, bx) in (
            ("luma race grid", False, RACE_SHAPE[2:]), ("chroma race grid", True, RACE_SHAPE[2:]),
            ("luma 1080p width, even", False, (136, 240)),
            ("chroma 1080p U+V stack, even", True, (68, 120)),
            ("luma tail, Bx/2 35, byte words", False, (5, 70)),
            ("chroma tail, Bx/2 35, byte words", True, (5, 70)),
            ("luma tail, Bx/2 36, 4-byte words", False, (3, 72)),
            ("chroma tail, Bx/2 36, 4-byte words", True, (3, 72)),
            ("luma tail", False, (3, 4)), ("chroma tail", True, (3, 4))):
        for qp in QPS:
            tiles, maps = tiles_maps((8, 8, by, bx), (by, bx))
            beta, tc = get_beta(qp), get_tc(qp)
            out = sk.deblock_tiles_swar_cuda(tiles, *maps, beta, tc, chroma=chroma)
            same("T1", f"{name} qp {qp}", out,
                 deblock_tiles_plain(tiles, *maps, beta, tc, chroma=chroma))
            same("T1", f"{name} qp {qp} against K1", out,
                 ck.deblock_tiles_cuda(tiles, *maps, beta, tc, chroma=chroma))
        print(f"T1 == plain == K1: {name} {(8, 8, by, bx)}, QP {list(QPS)}")
    for chroma in (False, True):
        tiles, maps = tiles_maps(RACE_SHAPE, RACE_SHAPE[2:])
        off = [torch.zeros_like(m) for m in maps]
        same("T1", f"race grid, every BS byte 0, chroma={chroma}",
             sk.deblock_tiles_swar_cuda(tiles, *off, 38, 4, chroma=chroma), tiles)
    print("T1 with every BS byte 0 == its input: race grid, luma and chroma")
    tiles, maps = tiles_maps((8, 8, 3, 5), (3, 5))
    try:
        sk.deblock_tiles_swar_cuda(tiles, *maps, 38, 4)
        check(False, "T1 took an odd Bx")
    except ValueError as e:
        print(f"T1 refuses an odd Bx: {e}")

    # -- 2d. tools.psnr on the CLI's output (called from phase 2's loop) -------------
    def psnr_check(tmp: str, src: str, out: str, gold, w: int, h: int) -> None:
        """tools.psnr on the CLI's output (its default backend, cuda) against
        golden's file: identical, null PSNR; on the unfiltered input against
        the output: finite PSNRs."""
        gold_path = os.path.join(tmp, "golden.yuv")
        with open(gold_path, "wb") as f:
            f.write(yv12_bytes_from_planes(gold))
        for pair, identical in (((out, gold_path), True), ((src, out), False)):
            buf = io.StringIO()
            with redirect_stdout(buf):
                rc = psnr.main([*pair, str(w), str(h)])
            check(rc == 0, f"tools.psnr {pair}: rc {rc}")
            (frame,) = json.loads(buf.getvalue())
            if identical:
                check(frame["identical"] is True and frame["psnr_y"] is None
                      and frame["psnr_uv"] is None and frame["max_abs_diff"] == 0,
                      f"tools.psnr CLI output vs golden: {frame}")
            else:
                check(frame["identical"] is False and all(
                    isinstance(frame[k], float) and np.isfinite(frame[k])
                    for k in ("psnr_y", "psnr_uv")), f"tools.psnr input vs CLI output: {frame}")
            print(f"tools.psnr {'CLI (cuda) vs golden' if identical else 'input vs CLI'}"
                  f" ({os.path.basename(src)}, QP 35): {buf.getvalue().strip()}")

    # -- 2. golden -----------------------------------------------------------
    golds = {}
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
            golds[name] = gold  # the bundled frames' oracle, again in phases 3e, 3f, 3h
            with open(dst, "rb") as f:
                check(f.read() == yv12_bytes_from_planes(gold), f"CLI output of {name} != golden")
            print(f"CLI == golden: {name} ({json.loads(res.stdout)['device']})")
            if name.startswith("mother-daughter"):
                psnr_check(tmp, src, dst, gold, w, h)
    for w, h in ((1920, 1080), (360, 288)):
        raw = blocky_frame(rng, w, h)
        (out,) = list(StreamingDeblocker(w, h, 35, device=dev).run([raw]))
        t0 = time.perf_counter()
        gold = deblock_frame_golden(planes_from_yv12_bytes(raw, w, h),
                                    BoundaryStrength.intra_default(w, h), 35)
        golds[w, h] = (raw, gold)  # again in phase 3d
        check(out.tobytes() == yv12_bytes_from_planes(gold), f"StreamingDeblocker {w}x{h} != golden")
        check(not np.array_equal(out, raw), f"{w}x{h}: the filter changed nothing")
        print(f"StreamingDeblocker == golden: {w}x{h} "
              f"({int((out != raw).sum())} bytes changed; golden {time.perf_counter() - t0:.1f} s)")

    # -- 2b. the int16 frame path ------------------------------------------------------
    beta35, tc35 = get_beta(35), get_tc(35)
    i16_launches = only()
    for w, h in ((1920, 1080), (360, 288)):
        fp = planes_from_yv12_bytes(blocky_frame(rng, w, h), w, h)
        bs = BoundaryStrength.intra_default(w, h)
        lm = [torch.from_numpy(m).to(dev) for m in luma_segment_maps(bs)]
        cm = [torch.from_numpy(m).to(dev) for m in chroma_segment_maps(bs)]
        planes = [torch.from_numpy(p).to(dev) for p in (fp.y, fp.u, fp.v)]
        reset()
        y, u, v = deblock_frame_cuda(*planes, lm, cm, beta35, tc35, dtype=torch.int16)
        got = counts()
        check(got == only(**{"K1-i16": 1, "K1-i16c": 1, "T2": 3, "T3": 3}),
              f"int16 frame {w}x{h}: launches {got}")
        i16_launches = {k: i16_launches[k] + got[k] for k in got}
        gold = deblock_frame_golden(fp, bs, 35)
        out = FramePlanes(y.cpu().numpy(), u.cpu().numpy(), v.cpu().numpy(), w, h)
        check(yv12_bytes_from_planes(out) == yv12_bytes_from_planes(gold),
              f"deblock_frame_cuda(dtype=int16) {w}x{h} != golden")
        check(not np.array_equal(out.y, fp.y), f"int16 {w}x{h}: the filter changed nothing")
        print(f"deblock_frame_cuda(dtype=torch.int16) == golden: {w}x{h}; launches {got}")

    # -- 2c. the experiments' entry points on the card ----------------------------------
    reset()
    probe = int16_probe.main([])
    check(probe.get("int16_on_gpu") == "ok-bitexact", f"int16_probe: {probe}")
    rows_res = rowslayout_exp.main([])
    check(rows_res["bit_exact"], f"rowslayout_exp: {rows_res}")
    swar_check = swar_exp.main(["--check"])
    check(swar_check["ok"], f"swar_exp --check: {swar_check}")
    swar_race = swar_exp.main(["--race"])
    check(swar_race["bit_exact"], f"swar_exp --race: {swar_race}")
    tool_launches = counts()
    check(all(tool_launches[k] > 0 for k in ("K1-i16", "K1-i16c", "T5", "T1")),
          f"the tools did not launch every new kernel: {tool_launches}")
    print(f"tools: int16_probe, rowslayout_exp, swar_exp --check/--race all bit-exact; "
          f"launches {tool_launches}")

    # -- 3. the main path: a 1080p stream ----------------------------------------
    w, h, n = 1920, 1080, 16
    frames = [blocky_frame(rng, w, h) if i % 2 else rng.integers(0, 256, 3 * w * h // 2,
                                                                 dtype=np.uint8)
              for i in range(n)]
    s = StreamingDeblocker(w, h, 35, depth=2, device=dev)
    reset()
    outs = list(s.run(frames))
    launches = counts()
    want = only(**packed_steps(w, n))
    check(launches == want, f"stream launches {launches}, want {want}")
    plain = StreamingDeblocker(w, h, 35, backend="torch", depth=2, device=dev)
    refs = list(plain.run(frames))
    check(len(outs) == n and all(np.array_equal(o, r) for o, r in zip(outs, refs)),
          "1080p stream != plain backend")
    check(all(not np.array_equal(o, f) for o, f in zip(outs, frames)), "a frame was unchanged")
    print(f"stream: {n} x 1080p == plain backend; launches {launches}")

    s_luma = StreamingDeblocker(w, h, 35, luma_only=True, device=dev)
    reset()
    outs_l = list(s_luma.run(frames))
    check(counts() == only(**packed_steps(w, n, luma_only=True)),
          f"luma_only launches {counts()}")
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

    s_swap = StreamingDeblocker(w, h, 35, device=dev)
    reset()
    outs_b = swapped(s_swap)
    check(counts() == only(**packed_steps(w, n)) and s_swap._run_ring is not None,
          f"BS swap stream launches {counts()}: not through the graph ring")
    refs_b = swapped(StreamingDeblocker(w, h, 35, backend="torch", device=dev))
    check(all(np.array_equal(o, r) for o, r in zip(outs_b, refs_b)), "BS swap != plain")
    check(all(np.array_equal(o, r) for o, r in zip(outs_b[:half], outs[:half])),
          "frames before the BS swap changed")
    check(not any(np.array_equal(o, r) for o, r in zip(outs_b[half:], outs[half:])),
          "the BS swap changed nothing")
    print(f"stream with mid-stream BS swap: {n} x 1080p through the graph ring == plain backend")

    cw_, ch_, ns = 360, 288, 8  # sheared chroma (Q9): w % 16 == 8
    cif_frames = [blocky_frame(rng, cw_, ch_) for _ in range(ns)]
    reset()
    outs_c = list(StreamingDeblocker(cw_, ch_, 35, device=dev).run(cif_frames))
    check(counts() == only(**packed_steps(cw_, ns)) and counts()["K2"] == 0,
          f"sheared stream launches {counts()}")
    refs_c = StreamingDeblocker(cw_, ch_, 35, backend="torch", device=dev).run(cif_frames)
    check(all(np.array_equal(o, r) for o, r in zip(outs_c, refs_c)),
          "sheared 360x288 stream != plain backend")
    print(f"stream sheared: {ns} x 360x288 == plain backend; launches {counts()}")

    # -- 3b. the resident path ------------------------------------------------------
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
    want = only(T2=2, K1=steps, K1c=steps, T3=2, T4=1)
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

    # -- 3c. CUDA graphs against eager plain steps -------------------------------------
    def chain_check(ww: int, hh: int, n_steps: int, raw) -> None:
        sg = StreamingDeblocker(ww, hh, 35, device=dev)
        sp = StreamingDeblocker(ww, hh, 35, backend="torch", device=dev)
        src = torch.from_numpy(raw.reshape(3 * hh // 2, ww)).to(dev)
        ref = src.clone()
        for _ in range(n_steps):
            sp._step(ref)
        buf = src.clone()
        want_l = only(**packed_steps(ww, n_steps))
        for call in ("capturing call", "replay"):
            buf.copy_(src)
            reset()
            check(sg._chain(buf, n_steps) is buf, "_chain did not work in place")
            check(counts() == want_l, f"_chain {ww}x{hh} n={n_steps} ({call}) launches "
                                      f"{counts()}, want {want_l}")
            torch.cuda.synchronize()
            check(torch.equal(buf, ref), f"_chain {ww}x{hh} n={n_steps} ({call}) != "
                                         f"{n_steps} eager plain steps")
        check(not torch.equal(ref, src), f"_chain {ww}x{hh}: the filter changed nothing")
        print(f"graphs: _chain {ww}x{hh} n={n_steps} == {n_steps} eager plain steps, at the "
              f"capturing call and a replay; launches {want_l} each")

    for n_steps in (1, 3, 50):
        chain_check(w, h, n_steps, frames[1])
    chain_check(360, 288, 3, cif_frames[0])
    for what, state_in in (("one 1080p frame", frames[1]), ("a batch of four 1080p frames",
                                                           np.stack(frames[1:8:2]))):
        rg = ResidentDeblocker(w, h, 35, device=dev)
        rp = ResidentDeblocker(w, h, 35, backend="torch", device=dev)
        tf = rg.ingest(state_in)
        keep = [t.clone() for t in tf]
        ref = rp.run_steps(rp.ingest(state_in), 3)
        results = []
        for call in ("capturing call", "replay"):
            reset()
            results.append(rg.run_steps(tf, 3))
            check(counts() == only(K1=3, K1c=3), f"run_steps {what} ({call}) launches {counts()}")
        torch.cuda.synchronize()
        for r in results:
            check(all(torch.equal(a, b) for a, b in zip(r, ref)),
                  f"run_steps {what} != 3 eager plain steps (or overwritten by the next call)")
        a, b = results
        check(a.y.data_ptr() != b.y.data_ptr() and a.uv.data_ptr() != b.uv.data_ptr(),
              f"run_steps {what}: two results share memory")
        check(all(torch.equal(t, k) for t, k in zip(tf, keep)),
              f"run_steps {what} changed its input")
        print(f"graphs: run_steps(tf, 3) on {what} == 3 eager plain steps twice over, results "
              f"distinct, input unchanged; K1 3, K1c 3 per call")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def trace(what: str, fn, reps: int = 20) -> list:
        """Print and return (us per call, launches per call, name) of every
        device kernel of `fn`; [] when the profiler shows no device time.
        The launches are those the profiler recorded (it can miss the first
        of its window); the time is per_iter_us of them."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6 / reps
        rows = sorted(((per_iter_us(getattr(e, "self_device_time_total", 0), e.count, reps),
                        e.count / reps, e.key)
                       for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                      reverse=True)
        busy = sum(us for us, _, _ in rows)
        if not busy:
            print(f"profile {what}: the profiler shows no device time (not measured)")
            return []
        print(f"profile {what}: kernels {busy:.1f} us per call, wall {wall_us:.1f} us per call, "
              f"device busy {100 * busy / wall_us:.0f}% ({smi})")
        for us, count, key in rows:
            print(f"  {us:8.2f} us  x{count:g}  {key[:90]}")
        return rows

    # -- 3d. the driver layer: DeblockPipeline at 1080p ---------------------------------
    raw, gold = golds[1920, 1080]
    fp = planes_from_yv12_bytes(raw, w, h)

    def same_planes(a, b) -> bool:
        return all(np.array_equal(getattr(a, k), getattr(b, k)) for k in "yuv")

    reset()
    pipe = DeblockPipeline(w, h, 35, device=dev)
    out = pipe(fp)
    pipe_launches = counts()
    check(pipe_launches == only(T2=3, K1=1, K1c=1, T3=3),
          f"pipeline 1080p launches {pipe_launches}, want T2 3, K1 1, K1c 1, T3 3")
    for backend in ("cuda", "torch", "golden", "native"):
        got = out if backend == "cuda" else DeblockPipeline(w, h, 35, backend=backend,
                                                            device=dev)(fp)
        check(same_planes(got, gold), f"DeblockPipeline({backend!r}) 1080p != golden")
    print(f"pipeline 1080p: cuda, torch, golden and native byte-equal (== golden); cuda "
          f"launches per frame {pipe_launches}")
    batch_frames = [planes_from_yv12_bytes(f, w, h) for f in frames[:4]]
    reset()
    outs_p = pipe.batch(batch_frames)
    batch_launches = counts()
    check(batch_launches == only(T2=2, K1=1, K1c=1, T3=2),
          f"pipeline batch of 4 launches {batch_launches}, want T2 2, K1 1, K1c 1, T3 2")
    reset()
    singles = [pipe(f) for f in batch_frames]
    check(all(same_planes(a, b) for a, b in zip(outs_p, singles)),
          "pipeline batch of 4 != four single calls")
    for k, v in batch_launches.items():
        pipe_launches[k] += v
    print(f"pipeline batch of 4 x 1080p == four single calls; launches {batch_launches}")

    def host_ms(fn, reps: int) -> list[float]:
        """Host wall ms of each of `reps` calls of fn (each ends synchronized)."""
        fn()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    with open("/proc/cpuinfo") as f:  # the first core's fields
        cpuinfo = dict(line.split(":", 1) for line in f.read().split("\n\n")[0].splitlines()
                       if ":" in line)
    cpuinfo = {k.strip(): v.strip() for k, v in cpuinfo.items()}
    cpu_model = cpuinfo.get("model name", "unknown")
    if cpu_model == "unknown":  # some hosts hide the name: give vendor, family, model
        cpu_model = (f"{cpuinfo.get('vendor_id', '?')} family {cpuinfo.get('cpu family', '?')} "
                     f"model {cpuinfo.get('model', '?')}")
    nproc = len(os.sched_getaffinity(0))
    t_single = host_ms(lambda: pipe(fp), 20)
    t_batch = host_ms(lambda: pipe.batch(batch_frames), 10)
    print(f"pipeline cuda 1080p host to host: {min(t_single):.2f} ms (median "
          f"{np.median(t_single):.2f}) per frame; batch of 4 {min(t_batch) / 4:.2f} ms (median "
          f"{np.median(t_batch) / 4:.2f}) per frame ({smi}; host {cpu_model}, nproc {nproc})")
    bs1080 = BoundaryStrength.intra_default(w, h)
    native_ms = {}
    for nt in (1, 2, 4, 8):
        native_ms[nt] = host_ms(lambda nt=nt: native.deblock_frame_native(
            fp, bs1080, 35, num_threads=nt), 5)
    print("native 1080p ms per frame by OpenMP threads: " + ", ".join(
        f"{nt}: {min(t):.2f} (median {np.median(t):.2f})" for nt, t in native_ms.items())
        + f" (isa {native.active_isa()}; host {cpu_model}, nproc {nproc})")

    # -- 3e. compat: the reference's flow and drivers ---------------------------------
    reset()
    with tempfile.TemporaryDirectory() as tmp:
        for name, ww, hh in (("image1_352x288_yv12.yuv", 352, 288),
                             ("mother-daughter_352x288_yv12.yuv", 352, 288),
                             ("image2_768x576.yuv", 768, 576)):
            for backend in ("cuda", "native"):
                dst = os.path.join(tmp, f"{backend}.yuv")
                frame = compat.ReadYuvFrame(os.path.join(REPO, "testdata", name), ww, hh, Qp=35,
                                            backend=backend, device=dev)
                frame.DeblockingFilter(4)
                frame.Save(dst)
                with open(dst, "rb") as f:
                    check(f.read() == yv12_bytes_from_planes(golds[name]),
                          f"compat ReadYuvFrame({backend!r}) {name} != golden")
        src = os.path.join(tmp, "in1080.yuv")
        with open(src, "wb") as f:
            f.write(raw.tobytes())
        cpu_t = compat.ExecuteCpu(src, os.path.join(tmp, "cpu.yuv"), w, h, 35)
        gpu_t = compat.ExecuteGpu(src, os.path.join(tmp, "gpu.yuv"), w, h, 35, device=dev)
        for what in ("cpu", "gpu"):
            with open(os.path.join(tmp, f"{what}.yuv"), "rb") as f:
                check(f.read() == yv12_bytes_from_planes(gold), f"Execute{what.title()} != golden")
    compat_launches = counts()
    check(all(compat_launches[k] > 0 for k in ("T2", "K1", "K1c", "T3", "K2")),
          f"compat did not launch T2, K1, K1c, T3 (ReadYuvFrame) and K2 (ExecuteGpu at 1080p): "
          f"{compat_launches}")
    print(f"compat: ReadYuvFrame (cuda, native) == golden on the three bundled frames; "
          f"launches {compat_launches}")
    print("ExecuteCpu 1080p seconds by threads: " + ", ".join(
        f"{nt}: {t * 1e3:.2f} ms" for nt, t in cpu_t.items())
        + f" (host {cpu_model}, nproc {nproc})")
    print(f"ExecuteGpu 1080p: kernel_s {gpu_t['kernel_s'] * 1e6:.1f} us, h2d_s "
          f"{gpu_t['h2d_s'] * 1e6:.1f} us, total_s {gpu_t['total_s'] * 1e6:.1f} us ({smi})")

    # -- 3f. the CLI's native backend and the examples on the card ------------------------
    with tempfile.TemporaryDirectory() as tmp:
        name = "mother-daughter_352x288_yv12.yuv"
        dst = os.path.join(tmp, "out.yuv")
        res = subprocess.run(
            [sys.executable, "-m", "gpu_video_codec_tpu_torch.cli", "-i",
             os.path.join(REPO, "testdata", name), "-W", "352", "-H", "288", "--qp", "35",
             "-o", dst, "--backend", "native", "--num-threads", "2", "--bench"],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        check(res.returncode == 0, f"CLI --backend native: {res.stderr[-2000:]}")
        with open(dst, "rb") as f:
            check(f.read() == yv12_bytes_from_planes(golds[name]), "CLI native != golden")
        print(f"CLI --backend native --num-threads 2 == golden: {res.stdout.strip()}")
    for mod in (one_shot, streaming, resident_chain):
        check(mod.main([]) == 0, f"example {mod.__name__} failed on the card")

    # -- 3g. sheared chroma (Q9) through T2/T3 alone, 360x288 ------------------------------
    sw, sh = 360, 288
    sheared4 = np.stack(cif_frames[:4])
    reset()
    outs_s = list(StreamingDeblocker(sw, sh, 35, device=dev).run(cif_frames[:4]))
    rd_s = ResidentDeblocker(sw, sh, 35, device=dev)
    outs_sr = rd_s.readback(rd_s.step(rd_s.ingest(sheared4)))
    sheared_planes = [planes_from_yv12_bytes(f, sw, sh) for f in cif_frames[:4]]
    outs_sp = DeblockPipeline(sw, sh, 35, device=dev).batch(sheared_planes)
    sheared_launches = counts()
    want = only(T2=2 * 4 + 2 + 2, K1=4 + 1 + 1, K1c=4 + 1 + 1, T3=2 * 4 + 2 + 2, T4=1)
    check(sheared_launches == want, f"sheared launches {sheared_launches}, want {want}")
    gold_s = [yv12_bytes_from_planes(deblock_frame_golden(
        p, BoundaryStrength.intra_default(sw, sh), 35)) for p in sheared_planes]
    check(all(o.tobytes() == g for o, g in zip(outs_s, gold_s)), "sheared stream != golden")
    check(all(o.tobytes() == g for o, g in zip(outs_sr, gold_s)), "sheared resident != golden")
    check(all(yv12_bytes_from_planes(o) == g for o, g in zip(outs_sp, gold_s)),
          "sheared pipeline batch != golden")
    print(f"sheared 360x288: 4-frame stream, resident batch of 4, pipeline batch of 4 == golden; "
          f"launches {sheared_launches}")
    s_sheared = StreamingDeblocker(sw, sh, 35, device=dev)
    sbuf = s_sheared._put(cif_frames[0])
    sheared_step_ms, ahead = device_ms(lambda: s_sheared._step(sbuf), 100)
    print(f"sheared 360x288 packed _step (a graph replay): {sheared_step_ms * 1e3:.2f} us device "
          f"time (queued ahead: {ahead}; {smi})")
    sheared_dev = torch.from_numpy(sheared4[:1]).to(dev)
    port_kernels = ("plane_to_tiles_kernel", "tiles_to_plane_kernel", "deblock_quad_kernel",
                    "pack_yv12_kernel", "deblock_packed_kernel")
    # eager launches first: a graph replay shows its kernels to a profiler
    # that has traced before in the process (phase 4c's order)
    for what, fn in (("sheared 360x288 streaming step, eager (_packed)",
                      lambda: s_sheared._packed(sbuf, True)),
                     ("sheared 360x288 resident ingest + step + readback to the device",
                      lambda: _readback(rd_s.step(rd_s.ingest(sheared_dev)), sw, sh)),
                     ("sheared 360x288 streaming _step, one graph replay",
                      lambda: s_sheared._step(sbuf))):
        rows = trace(what, fn)
        check(bool(rows), f"{what}: the profiler listed no device kernel")
        stray = [key for _, _, key in rows if not any(k in key for k in port_kernels)]
        check(not stray, f"{what} ran kernels besides the port's: {stray}")
        missing = [k for k in port_kernels[:3] if not any(k in key for _, _, key in rows)]
        check(not missing, f"{what} did not run {missing}")
        print(f"{what}: T2, the quad K1 and K1c, T3 (and T4 on the resident path), and no "
              f"other kernel")

    # -- 3h. the mesh paths (parallel/): slots of cuda:0 -------------------------------
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    from gpu_video_codec_tpu_torch.parallel import (
        MeshResidentDeblocker, MultiStreamDeblocker, deblock_batch_sharded,
        deblock_batch_sharded_jit, make_mesh,
    )
    from gpu_video_codec_tpu_torch.parallel import mesh as pmesh

    mesh_launches = only()

    def mesh_run(what: str, fn, want: dict):
        """fn() with the counts at 0 just before and read just after; checks
        them against `want` and adds them to the mesh path's launches."""
        reset()
        out = fn()
        torch.cuda.synchronize()
        got = counts()
        check(got == only(**want), f"{what}: launches {got}, want {want}")
        for k, v in got.items():
            mesh_launches[k] += v
        return out

    def slots(k: int, n_data: int = 1):
        return make_mesh(n_data, k // n_data, [dev] * k)

    steps_ms, n_ms = 8, 4  # 4 streams x 8 steps at 1080p
    streams = [[frames[(n_ms * t + i) % n] for t in range(steps_ms)] for i in range(n_ms)]
    golden_pool = ProcessPoolExecutor(4, mp_context=get_context("spawn"))
    try:
        gold_jobs = golden_pool.map(golden_packed, [
            (streams[i][t].tobytes(), w, h) for t in (0, steps_ms - 1) for i in range(n_ms)])

        def multistream(mesh, ww, hh, strs, backend="cuda", luma_only=False, swap_at=None,
                        swap_bs=None):
            """MultiStreamDeblocker.run_batches over the streams, depth 2; with
            swap_at, update_boundary_strength(swap_bs) before batch swap_at is
            dispatched (earlier batches still in flight)."""
            ms = MultiStreamDeblocker(mesh, len(strs), ww, hh, 35, backend=backend,
                                      luma_only=luma_only)

            def batches():
                for t in range(len(strs[0])):
                    if t == swap_at:
                        ms.update_boundary_strength(swap_bs)
                    yield [st[t] for st in strs]
            return list(ms.run_batches(batches()))

        def same_batches(what, got, ref):
            check(len(got) == len(ref) and all(
                len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
                for a, b in zip(got, ref)), f"{what} != plain backend")

        def batch_launches(batches_: int, active_slots: int, luma_only=False, ww=w) -> dict:
            return packed_steps(ww, batches_ * active_slots, luma_only)

        mesh11 = slots(1)
        outs_m = mesh_run("MultiStreamDeblocker 4 x 1080p, (1, 1)",
                          lambda: multistream(mesh11, w, h, streams),
                          batch_launches(steps_ms, 1))
        same_batches("MultiStreamDeblocker 4 x 1080p",
                     outs_m, multistream(mesh11, w, h, streams, backend="torch"))
        outs_sw = mesh_run("MultiStreamDeblocker 4 x 1080p, BS swap before batch 3",
                           lambda: multistream(mesh11, w, h, streams, swap_at=3, swap_bs=bs),
                           batch_launches(steps_ms, 1))
        same_batches("MultiStreamDeblocker BS swap", outs_sw,
                     multistream(mesh11, w, h, streams, backend="torch", swap_at=3, swap_bs=bs))
        check(all(np.array_equal(a, b) for t in range(3) for a, b in zip(outs_sw[t], outs_m[t]))
              and not any(np.array_equal(a, b) for a, b in zip(outs_sw[3], outs_m[3])),
              "the BS swap did not take effect at batch 3 exactly")
        outs_lo = mesh_run("MultiStreamDeblocker luma_only",
                           lambda: multistream(mesh11, w, h, streams, luma_only=True),
                           batch_launches(steps_ms, 1, luma_only=True))
        same_batches("MultiStreamDeblocker luma_only", outs_lo,
                     multistream(mesh11, w, h, streams, backend="torch", luma_only=True))
        golds_m = list(gold_jobs)
        check([o.tobytes() for o in outs_m[0] + outs_m[-1]] == golds_m,
              "MultiStreamDeblocker 1080p first and last batch != golden")
        print(f"mesh: MultiStreamDeblocker {n_ms} streams x {steps_ms} steps x 1080p on a (1, 1) "
              f"mesh of cuda:0 == plain backend (first and last batch == golden), with a BS "
              f"swap before batch 3 and luma_only; per batch K2 1")

        cif_streams = [[cif_frames[(4 * t + i) % ns] for t in range(3)] for i in range(4)]
        outs_cm = mesh_run("MultiStreamDeblocker 4 x 360x288",
                           lambda: multistream(mesh11, cw_, ch_, cif_streams),
                           batch_launches(3, 1, ww=cw_))
        same_batches("MultiStreamDeblocker sheared 360x288", outs_cm,
                     multistream(mesh11, cw_, ch_, cif_streams, backend="torch"))
        check(all(o.tobytes() == golden_packed((cif_streams[i][t].tobytes(), cw_, ch_))
                  for t in (0, 2) for i, o in enumerate(outs_cm[t])),
              "MultiStreamDeblocker 360x288 != golden")
        uhd = [[blocky_frame(rng, 3840, 2160) for _ in range(2)] for _ in range(2)]
        outs_4k = mesh_run("MultiStreamDeblocker 2 x 3840x2160",
                           lambda: multistream(mesh11, 3840, 2160, uhd),
                           batch_launches(2, 1, ww=3840))
        same_batches("MultiStreamDeblocker 3840x2160", outs_4k,
                     multistream(mesh11, 3840, 2160, uhd, backend="torch"))
        mesh12 = slots(2)
        outs_un = mesh_run("MultiStreamDeblocker 3 x 1080p on (1, 2): chunks 2 + 1",
                           lambda: multistream(mesh12, w, h, streams[:3]),
                           batch_launches(steps_ms, 2))
        same_batches("MultiStreamDeblocker uneven chunks", outs_un,
                     [b[:3] for b in outs_m])
        print("mesh: MultiStreamDeblocker sheared 360x288 (4 streams, == golden), 3840x2160 "
              "(2 streams x 2 steps) == plain backend; 3 streams on [cuda:0] * 2 as (1, 2) "
              "(chunks 2 + 1) == the (1, 1) run; per slot and batch K2 1 (T2 2, K1 1, K1c 1, "
              "T3 2 at the sheared width)")

        # deblock_batch_sharded: extended 1080p planes, uneven tile-row slabs
        ext = [torch.nn.functional.pad(p, (4, 4, 4, 4)) for p in (
            y4[:2], frames4[:2, w * h : w * h * 5 // 4].reshape(2, h // 2, w // 2),
            frames4[:2, w * h * 5 // 4 :].reshape(2, h // 2, w // 2))]
        bs_d = BoundaryStrength.intra_default(w, h)
        lm_d = [torch.from_numpy(m).to(dev) for m in luma_segment_maps(bs_d)]
        cm_d = [torch.from_numpy(m).to(dev) for m in chroma_segment_maps(bs_d)]
        one = [p.clone() for p in ext]
        deblock_batch_sharded(mesh11, *one, lm_d, cm_d, beta35, tc35)
        for shape in ((1, 2), (1, 3)):
            mesh_s = slots(shape[1])
            for fn in (deblock_batch_sharded, deblock_batch_sharded_jit):
                planes_s = [p.clone() for p in ext]
                k = shape[1]  # every slot has a luma and a chroma slab
                mesh_run(f"{fn.__name__} {shape}",
                         lambda: fn(mesh_s, *planes_s, lm_d, cm_d, beta35, tc35),
                         {"T2": 3 * k, "K1": k, "K1c": k, "T3": 3 * k})
                check(all(torch.equal(a, b) for a, b in zip(planes_s, one)),
                      f"{fn.__name__} on {shape} slots != one slot")
        check(not torch.equal(one[0], ext[0]), "deblock_batch_sharded changed nothing")
        print("mesh: deblock_batch_sharded of two extended 1080p frames on (1, 2) and (1, 3) "
              "slots of cuda:0 (luma slabs of 68/68 and 46/46/44 tile rows), eager and graph "
              "replays, == one slot")

        batch4 = np.stack(frames[:4])
        mrd = MeshResidentDeblocker(slots(2, n_data=2), w, h, 35)
        outs_mr = mesh_run("MeshResidentDeblocker batch 4 x 3 steps on (2, 1)",
                           lambda: mrd.readback(mrd.step(mrd.ingest(batch4), 3)),
                           {"T2": 4, "K1": 6, "K1c": 6, "T3": 4, "T4": 2})
        rd_one = ResidentDeblocker(w, h, 35, device=dev)
        check(np.array_equal(outs_mr, rd_one.readback(rd_one.run_steps(rd_one.ingest(batch4), 3))),
              "MeshResidentDeblocker != ResidentDeblocker")
        print("mesh: MeshResidentDeblocker batch of 4 x 1080p, 3 steps on [cuda:0] * 2 as (2, 1) "
              "== ResidentDeblocker; launches T2 4, K1 6, K1c 6, T3 4, T4 2")

        with tempfile.TemporaryDirectory() as tmp:
            names = ("mother-daughter_352x288_yv12.yuv", "image1_352x288_yv12.yuv")
            raws10 = [open(os.path.join(REPO, "testdata", names[i % 2]), "rb").read()
                      for i in range(10)]
            src, dst = os.path.join(tmp, "ten.yuv"), os.path.join(tmp, "out.yuv")
            with open(src, "wb") as f:
                f.write(b"".join(raws10))
            res = subprocess.run(
                [sys.executable, "-m", "gpu_video_codec_tpu_torch.cli", "-i", src, "-W", "352",
                 "-H", "288", "--qp", "35", "-o", dst, "--streams", "4", "--mesh", "1,1"],
                cwd=REPO, capture_output=True, text=True, timeout=300)
            check(res.returncode == 0, f"CLI --streams: {res.stderr[-2000:]}")
            check(json.loads(res.stdout)["frames"] == 10, f"CLI --streams frames: {res.stdout}")
            with open(dst, "rb") as f:
                check(f.read() == b"".join(yv12_bytes_from_planes(golds[n])
                                           for n in names * 5),
                      "CLI --streams 4 --mesh 1,1 != golden")
        print(f"mesh: CLI --streams 4 --mesh 1,1 on 10 frames (two batches and a tail of 2) "
              f"== golden: {res.stdout.strip()}")
    finally:
        golden_pool.shutdown(cancel_futures=True)

    bufs_k = {k: torch.from_numpy(np.stack([frames[i % n] for i in range(k)])
                                  .reshape(k, 3 * h // 2, w)).to(dev) for k in (1, 4, 8)}

    def packed_step(k: int):
        return lambda: pmesh.deblock_packed_batch_sharded_jit(
            mesh11, bufs_k[k], s._lm, s._cm, beta35, tc35, w=w, h=h)

    step_rows_m = trace("mesh: batched packed step 1080p, k = 4 frames, one graph replay",
                        packed_step(4))
    # the launch counters give the counts (mesh_run); the profiler may drop
    # events at its window's edges, so its listing is held to the names only
    stray = [key for _, _, key in step_rows_m if "deblock_packed_kernel" not in key]
    check(not stray and bool(step_rows_m),
          f"the batched packed step ran kernels besides K2: {stray}")
    print("mesh: the batched packed step's profile holds K2 and no other kernel (no relayout, "
          "copy, fill, cat or stack)")

    # the Main 10 packed step on the mesh's entries, as the Main 10 cell calls
    # them: int16 samples in [0, 1023] at the cell's shape, random BS
    w10, h10 = 3840, 2160
    bs10 = BoundaryStrength.intra_default(w10, h10)
    bs10.set_luma(rng.integers(0, 3, bs10.vert.size, dtype=np.uint8),
                  rng.integers(0, 3, bs10.hor.size, dtype=np.uint8))
    bs10.set_chroma(rng.integers(0, 3, bs10.chroma_vert.size, dtype=np.uint8),
                    rng.integers(0, 3, bs10.chroma_hor.size, dtype=np.uint8))
    lm10 = [torch.from_numpy(m).to(dev) for m in luma_segment_maps(bs10)]
    cm10 = [torch.from_numpy(m).to(dev) for m in chroma_segment_maps(bs10)]
    src10 = torch.from_numpy(
        np.stack([blocky_frame(rng, w10, h10) for _ in range(4)]).astype(np.int16) * 4
        + rng.integers(0, 4, (4, 3 * h10 * w10 // 2), dtype=np.int16)
    ).reshape(4, 3 * h10 // 2, w10).to(dev)
    want10 = deblock_packed_plain(src10[:, :h10], src10[:, h10:].view(4, 2, h10 // 2, w10 // 2),
                                  lm10, cm10, beta35, tc35, bit_depth=10)
    want10 = torch.cat([want10[0], want10[1].reshape(4, h10 // 2, w10)], dim=1)
    check(int((want10 != src10).sum()) > 0, "the Main 10 step's plain version changed nothing")
    buf10m = torch.empty_like(src10)
    for fn in (pmesh.deblock_packed_batch_sharded, pmesh.deblock_packed_batch_sharded_jit):
        for call in ("first", "second"):  # the jit: capture and replay, then a replay
            buf10m.copy_(src10)
            out10 = mesh_run(f"{fn.__name__} Main 10 (4, 3240, 3840), {call} call",
                             lambda: fn(mesh11, buf10m, lm10, cm10, beta35, tc35, w=w10, h=h10,
                                        bit_depth=10),
                             {"K2-10": 1})
            check(out10 is buf10m and torch.equal(buf10m, want10),
                  f"{fn.__name__} Main 10 (4, 3240, 3840), {call} call != its plain version: "
                  f"{int((buf10m != want10).sum())} samples differ")
    print(f"mesh: deblock_packed_batch_sharded and _jit, Main 10 (4, 3240, 3840) int16 on "
          f"(1, 1), random BS, two calls each: in place == the plain version sample for "
          f"sample; K2-10 1 launch a call, no other kernel ({mesh_launches['K2-10']} in all)")
    del src10, want10, buf10m, lm10, cm10

    # one Main 4:2:2 10 call, as the 4:2:2 cell makes it: an int16 (4, 2h, w)
    # batch of chroma planes (h, w/2), random BS on the chroma plane's grid
    bs422 = BoundaryStrength.intra_default(w10, h10, "4:2:2")
    bs422.set_luma(rng.integers(0, 3, bs422.vert.size, dtype=np.uint8),
                   rng.integers(0, 3, bs422.hor.size, dtype=np.uint8))
    bs422.set_chroma(rng.integers(0, 3, bs422.chroma_vert.size, dtype=np.uint8),
                     rng.integers(0, 3, bs422.chroma_hor.size, dtype=np.uint8))
    lm422 = [torch.from_numpy(m).to(dev) for m in luma_segment_maps(bs422)]
    cm422 = [torch.from_numpy(m).to(dev) for m in chroma_segment_maps(bs422)]
    src422 = torch.from_numpy(
        np.stack([blocky_frame(rng, w10, h10, h10) for _ in range(4)]).astype(np.int16) * 4
        + rng.integers(0, 4, (4, 2 * h10 * w10), dtype=np.int16)
    ).reshape(4, 2 * h10, w10).to(dev)
    want422 = deblock_packed_plain(src422[:, :h10], src422[:, h10:].view(4, 2, h10, w10 // 2),
                                   lm422, cm422, beta35, tc35, bit_depth=10)
    want422 = torch.cat([want422[0], want422[1].reshape(4, h10, w10)], dim=1)
    check(int((want422[:, h10:] != src422[:, h10:]).sum()) > 0,
          "the Main 4:2:2 10 step's plain version changed no chroma sample")
    buf422 = src422.clone()
    out422 = mesh_run("deblock_packed_batch_sharded_jit Main 4:2:2 10 (4, 4320, 3840)",
                      lambda: pmesh.deblock_packed_batch_sharded_jit(
                          mesh11, buf422, lm422, cm422, beta35, tc35, w=w10, h=h10,
                          bit_depth=10, chroma_format="4:2:2"),
                      {"K2-10 4:2:2": 1})
    check(out422 is buf422 and torch.equal(buf422, want422),
          f"deblock_packed_batch_sharded_jit Main 4:2:2 10 != its plain version: "
          f"{int((buf422 != want422).sum())} samples differ")
    print("mesh: deblock_packed_batch_sharded_jit, Main 4:2:2 10 (4, 4320, 3840) int16 on "
          "(1, 1), random BS: in place == the plain version sample for sample; K2-10 1 "
          "launch, under packed10_422, no other kernel")
    del src422, want422, buf422, lm422, cm422

    # Main 4:4:4 and Main 4:4:4 10 calls, as the 4:4:4 cell makes them: a
    # uint8 (4, 3h, w) batch of chroma planes (h, w), and its int16 twin,
    # random BS on the chroma planes' grid (the luma grid), against the
    # plain version and the benchmark's plain reference
    from bench_torch.references import hevc_deblock as bench_ref

    bs444 = BoundaryStrength.intra_default(w10, h10, "4:4:4")
    bs444.set_luma(rng.integers(0, 3, bs444.vert.size, dtype=np.uint8),
                   rng.integers(0, 3, bs444.hor.size, dtype=np.uint8))
    bs444.set_chroma(rng.integers(0, 3, bs444.chroma_vert.size, dtype=np.uint8),
                     rng.integers(0, 3, bs444.chroma_hor.size, dtype=np.uint8))
    lm444 = [torch.from_numpy(m).to(dev) for m in luma_segment_maps(bs444)]
    cm444 = [torch.from_numpy(m).to(dev) for m in chroma_segment_maps(bs444)]
    flat_bs = {k: torch.from_numpy(getattr(bs444, k)).to(dev)
               for k in ("vert", "hor", "chroma_vert", "chroma_hor")}
    src8 = torch.from_numpy(np.stack([blocky_frame(rng, w10, h10, h10, w10)
                                      for _ in range(4)])).reshape(4, 3 * h10, w10).to(dev)
    for bd, name in ((8, "K2 4:4:4"), (10, "K2-10 4:4:4")):
        src444 = src8 if bd == 8 else src8.to(torch.int16) * 4 + torch.from_numpy(
            rng.integers(0, 4, tuple(src8.shape), dtype=np.int16)).to(dev)
        want444 = deblock_packed_plain(src444[:, :h10], src444[:, h10:].view(4, 2, h10, w10),
                                       lm444, cm444, beta35, tc35, bit_depth=bd)
        want444 = torch.cat([want444[0], want444[1].reshape(4, 2 * h10, w10)], dim=1)
        ref444 = bench_ref.deblock_packed(src444, w10, h10, 35, flat_bs, bit_depth=bd,
                                          chroma_format="4:4:4")
        check(torch.equal(want444, ref444),
              f"{name}: the plain version != the benchmark's reference: "
              f"{int((want444 != ref444).sum())} samples differ")
        check(int((want444[:, h10:] != src444[:, h10:]).sum()) > 0,
              f"the {name} step's plain version changed no chroma sample")
        buf444 = src444.clone()
        for call in ("first", "second"):  # capture and replay, then a replay
            buf444.copy_(src444)
            out444 = mesh_run(f"deblock_packed_batch_sharded_jit {name} (4, 6480, 3840), {call}",
                              lambda: pmesh.deblock_packed_batch_sharded_jit(
                                  mesh11, buf444, lm444, cm444, beta35, tc35, w=w10, h=h10,
                                  bit_depth=bd, chroma_format="4:4:4"),
                              {name: 1})
            check(out444 is buf444 and torch.equal(buf444, ref444),
                  f"deblock_packed_batch_sharded_jit {name}, {call} call != the reference: "
                  f"{int((buf444 != ref444).sum())} samples differ")
        print(f"mesh: deblock_packed_batch_sharded_jit, {name} (4, 6480, 3840) "
              f"{src444.dtype} on (1, 1), random BS, two calls: in place == the plain "
              f"version and the benchmark's reference sample for sample; 1 launch a call, "
              f"under {ck.PACKED_LAUNCHES[bd, '4:4:4']}, no other kernel")
    del src8, src444, want444, ref444, buf444, lm444, cm444, flat_bs

    new_paths = {"pipeline": pipe_launches, "compat": compat_launches,
                 "sheared": sheared_launches, "mesh": mesh_launches}

    # -- 4. times --------------------------------------------------------------
    kernels = []
    for name, chroma, shape, mshape in (
            ("K1 luma deblock", False, (8, 8, 136, 241), (136, 241)),
            ("K1c chroma deblock", True, (2, 8, 8, 68, 121), (1, 68, 121))):
        tiles = torch.from_numpy(blocky_tiles(rng, shape)).to(dev)
        maps = [torch.from_numpy(rng.integers(0, 3, mshape, dtype=np.uint8)).to(dev)
                for _ in range(4)]
        beta, tc = get_beta(35), get_tc(35)
        # in turns: plain, TB 32, TB 64, TB 64, TB 32, plain
        fns = {"plain": lambda: deblock_tiles_plain(tiles, *maps, beta, tc, chroma=chroma)}
        for tb in BLOCKS:
            fns[f"TB {tb}"] = lambda tb=tb: ck.deblock_tiles_cuda(tiles, *maps, beta, tc,
                                                                  chroma=chroma, block_bx=tb)
        r = in_turns(fns, {"plain": 5, **{f"TB {tb}": 200 for tb in BLOCKS}})
        short = name.split()[0]
        block_bx = ck.CHROMA_BLOCK_BX if chroma else ck.BLOCK_BX
        by_path = {"stream": launches[short], "resident": res_launches[short],
                   **{path: n[short] for path, n in new_paths.items()}}
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max_err[short],
            "ms": r[f"TB {block_bx}"][0], "plain_ms": r["plain"][0],
            # tiles read and written once, four BS maps read once
            "bound_ms": bytes_bound_ms(2 * tiles.numel() + 4 * maps[0].numel()),
            "bound_by": "bytes", "library_ms": None,
            "block_bx": block_bx, "ms_by_block_bx": {tb: r[f"TB {tb}"][0] for tb in BLOCKS},
            "warps_per_sm": occupancy[short, block_bx]["warps_per_sm"],
        })
        print(f"{name} {shape}: " + ", ".join(f"{k} {ms * 1e3:.2f} us" for k, (ms, _) in r.items())
              + f" (the path's TB {block_bx}; queued ahead: {all(ok for _, ok in r.values())}; "
              f"device time; {smi})")

    # K2 at the benchmark cells' shapes: first out of place against the chain
    # it replaces and its plain version, byte for byte with random BS; then
    # in turns with both, in place on the same batch of blocky frames
    def chain(y, uv, lm, cm, beta, tc, out=(None, None)):  # the packed step's chain, pad 4
        (y,) = tile_chain([y], lm, beta, tc, pad=4, chroma=False, out=out[:1])
        return y, *tile_chain([uv], cm, beta, tc, pad=4, chroma=True, out=out[1:])

    k2_rows = []
    for kk, ww, hh in ((16, w, h), (4, 3840, 2160)):
        sk2 = StreamingDeblocker(ww, hh, 37, device=dev)
        bs_k = BoundaryStrength.intra_default(ww, hh)
        bs_k.set_luma(rng.integers(0, 3, bs_k.vert.size, dtype=np.uint8),
                      rng.integers(0, 3, bs_k.hor.size, dtype=np.uint8))
        bs_k.set_chroma(rng.integers(0, 3, bs_k.chroma_vert.size, dtype=np.uint8),
                        rng.integers(0, 3, bs_k.chroma_hor.size, dtype=np.uint8))
        sk2.update_boundary_strength(bs_k)
        bufk = torch.from_numpy(np.stack([blocky_frame(rng, ww, hh) for _ in range(kk)])
                                .reshape(kk, 3 * hh // 2, ww)).to(dev)
        planes_k = (bufk[:, :hh], bufk[:, hh:].view(kk, 2, hh // 2, ww // 2))
        args_k = (sk2._lm, sk2._cm, sk2._beta, sk2._tc)
        got_k = ck.deblock_packed_cuda(*planes_k, *args_k)
        chain_k = chain(*planes_k, *args_k)
        plain_k = deblock_packed_plain(*planes_k, *args_k)
        for plane, g, c, p in zip(("luma", "U+V"), got_k, chain_k, plain_k):
            check(torch.equal(g, c) and torch.equal(g, p),
                  f"K2 ({kk}, {3 * hh // 2}, {ww}) {plane} != the chain / its plain version: "
                  f"{int((g != c).sum())} / {int((g != p).sum())} bytes differ")
        changed = int((got_k[0] != planes_k[0]).sum() + (got_k[1] != planes_k[1]).sum())
        check(changed > 0, f"K2 ({kk}, {3 * hh // 2}, {ww}) changed no byte")
        print(f"K2 ({kk}, {3 * hh // 2}, {ww}), random BS: == the chain == its plain version, "
              f"byte for byte ({changed} bytes filtered)")
        del got_k, chain_k, plain_k
        r = in_turns({
            "K2": lambda pk=planes_k, ak=args_k: ck.deblock_packed_cuda(*pk, *ak, out=pk),
            "chain": lambda pk=planes_k, ak=args_k: chain(*pk, *ak, out=pk),
            "plain": lambda pk=planes_k, ak=args_k: deblock_packed_plain(*pk, *ak)},
            {"K2": 200, "chain": 200, "plain": 3})
        k2_rows.append({"shape": f"({kk}, {3 * hh // 2}, {ww})", "ms": r["K2"][0],
                        "chain_ms": r["chain"][0], "plain_ms": r["plain"][0],
                        "bound_ms": bytes_bound_ms(2 * bufk.numel())})
        bound_k = k2_rows[-1]["bound_ms"]
        print(f"K2 ({kk}, {3 * hh // 2}, {ww}): " + ", ".join(
            f"{k} {ms * 1e3:.2f} us" for k, (ms, _) in r.items())
            + f"; bound {bound_k * 1e3:.2f} us, {bound_k / r['K2'][0]:.3f} of K2's time; "
            f"chain / K2 {r['chain'][0] / r['K2'][0]:.3f} (queued ahead: "
            f"{all(ok for _, ok in r.values())}; device time; {smi})")
    # K2-10 at the Main 10 cell's shape: the 4K frames' samples times 4 plus
    # 0..3 (int16), random BS; byte for byte against its plain version, then
    # in turns with it
    ww, hh = 3840, 2160
    buf10 = (bufk.to(torch.int16) << 2) + torch.from_numpy(
        rng.integers(0, 4, tuple(bufk.shape), dtype=np.int16)).to(dev)
    planes10 = (buf10[:, :hh], buf10[:, hh:].view(4, 2, hh // 2, ww // 2))
    got10 = ck.deblock_packed_cuda(*planes10, *args_k, bit_depth=10)
    plain10 = deblock_packed_plain(*planes10, *args_k, bit_depth=10)
    for plane, g, p in zip(("luma", "U+V"), got10, plain10):
        check(torch.equal(g, p), f"K2-10 (4, 3240, 3840) {plane} != its plain version: "
                                 f"{int((g != p).sum())} samples differ")
    changed = int((got10[0] != planes10[0]).sum() + (got10[1] != planes10[1]).sum())
    check(changed > 0, "K2-10 (4, 3240, 3840) changed no sample")
    print(f"K2-10 (4, 3240, 3840), random BS: == its plain version, sample for sample "
          f"({changed} samples filtered)")
    del got10, plain10
    r = in_turns({
        "K2-10": lambda: ck.deblock_packed_cuda(*planes10, *args_k, out=planes10, bit_depth=10),
        "plain": lambda: deblock_packed_plain(*planes10, *args_k, bit_depth=10)},
        {"K2-10": 200, "plain": 3})
    bound10 = bytes_bound_ms(2 * buf10.numel() * buf10.element_size())
    print("K2-10 (4, 3240, 3840): "
          + ", ".join(f"{k} {ms * 1e3:.2f} us" for k, (ms, _) in r.items())
          + f"; bound {bound10 * 1e3:.2f} us, {bound10 / r['K2-10'][0]:.3f} of K2-10's time "
          f"(queued ahead: {all(ok for _, ok in r.values())}; device time; {smi})")
    info10 = ck.deblock_packed_info(dev, bit_depth=10)
    by_path10 = {path: n["K2-10"] for path, n in new_paths.items()}
    check(sum(by_path10.values()) == by_path10["mesh"] == 4,
          f"K2-10's launches by path: {by_path10}")
    by_path = {"stream": launches["K2"], "resident": res_launches["K2"],
               **{path: n["K2"] for path, n in new_paths.items()}}
    kernels.append({
        "name": "K2-10 packed step (4, 3240, 3840) int16", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": None, "launches": sum(by_path10.values()),
        "launches_by_path": by_path10,
        "ms": r["K2-10"][0], "plain_ms": r["plain"][0], "bound_ms": bound10,
        "bound_by": "bytes", "library_ms": None, "registers": k2_entries[10].get("registers"),
        "warps_per_sm": info10["warps_per_sm"], "smem_bytes": info10["smem_bytes"]})
    kernels.append({
        "name": f"K2 packed step {k2_rows[0]['shape']}", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": None, "launches": sum(by_path.values()), "launches_by_path": by_path,
        "ms": k2_rows[0]["ms"], "chain_ms": k2_rows[0]["chain_ms"],
        "plain_ms": k2_rows[0]["plain_ms"], "bound_ms": k2_rows[0]["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "registers": k2_entries[8].get("registers"),
        "warps_per_sm": k2_info["warps_per_sm"], "smem_bytes": k2_info["smem_bytes"],
        "other_shapes": k2_rows[1:]})

    raw = frames[1]
    buf = s._put(raw)
    step_ms, bound = device_ms(lambda: s._step(buf), 50)
    print(f"packed _step 1080p: {step_ms * 1e3:.1f} us/frame device time "
          f"(host queued ahead: {bound}; {smi})")
    tb = s.time_breakdown(raw, n=50, measure_d2h=True)
    torch.cuda.synchronize()
    eager = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(50):
            s._packed(buf, True)
        eager = min(eager, (time.perf_counter() - t0) / 50)
        torch.cuda.synchronize()
    print(f"time_breakdown 1080p: h2d {tb['h2d_s'] * 1e6:.1f} us, kernel {tb['kernel_s'] * 1e6:.1f}"
          f" us, dispatch {tb['dispatch_s'] * 1e6:.1f} us per _step (one graph replay; an eager "
          f"step {eager * 1e6:.1f} us), e2e_sync {tb['e2e_sync_s'] * 1e6:.1f} us, device_split_us "
          f"{tb.get('device_split_us', 'not measured')} ({smi})")

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
    y_flat, uv_flat, nothing = y1.reshape(-1), uv1.reshape(-1), y1.new_empty(0)
    floor = in_turns({"luma": lambda: rk.pack_yv12_cuda(y_flat, nothing, nothing),
                      "U+V": lambda: rk.pack_yv12_cuda(uv_flat, nothing, nothing)},
                     {"luma": 200, "U+V": 200})
    print("copy floor, T4 copying the same bytes in one launch: " + ", ".join(
        f"{k} {ms * 1e3:.2f} us" for k, (ms, _) in floor.items()) + f" (device time; {smi})")
    for row, plane in zip(kernels[:2], ("luma", "U+V")):  # K1, K1c: their planes' bytes
        row["copy_floor_ms"] = floor[plane][0]
        print(f"{row['name']} / copy floor: " + ", ".join(
            f"TB {tb} {ms / row['copy_floor_ms']:.3f}" for tb, ms in row["ms_by_block_bx"].items()))
    rows = {}
    for kname, shape, kern, plain_fn, lib_fn, nbytes in timed:
        r = in_turns({"kernel": kern, "plain": plain_fn, "library": lib_fn},
                     {"kernel": 200, "plain": 50, "library": 200})
        row = {"shape": shape, "ms": r["kernel"][0], "plain_ms": r["plain"][0],
               "library_ms": r["library"][0], "bound_ms": bytes_bound_ms(nbytes)}
        if kname in ("T2", "T3"):
            row["copy_floor_ms"] = floor[shape.split()[1]][0]
        rows.setdefault(kname, []).append(row)
        print(f"{kname} {shape}: kernel {row['ms'] * 1e3:.2f} us, plain {row['plain_ms'] * 1e3:.2f}"
              f" us, library {row['library_ms'] * 1e3:.2f} us, bound {row['bound_ms'] * 1e3:.2f}"
              f" us; kernel / library {row['ms'] / row['library_ms']:.3f}, bound / kernel "
              f"{row['bound_ms'] / row['ms']:.3f} (queued ahead: {all(ok for _, ok in r.values())}"
              f"; device time; {smi})")
    for kname, what in (("T2", "plane_to_tiles"), ("T3", "tiles_to_plane"), ("T4", "pack_yv12")):
        main_row, *others = rows[kname]
        replaces = {"T2": "tools/kernel_relayout_exp.py:55", "T3": "tools/kernel_relayout_exp.py:87",
                    "T4": "tools/pack_exp.py:91"}[kname]
        by_path = {"stream": launches[kname], "resident": res_launches[kname],
                   **{path: n[kname] for path, n in new_paths.items()}}
        kernels.append({
            "name": f"{kname} {what} ({main_row['shape']})", "route": "cuda",
            "source": RELAYOUT_SOURCE, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max_err[kname],
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": "bytes",
            "library_ms": main_row["library_ms"],
            **({"copy_floor_ms": main_row["copy_floor_ms"]} if "copy_floor_ms" in main_row else {}),
            **({"other_shapes": others} if others else {}),
        })

    for nb_t, frame in ((1, frames4[0]), (4, frames4)):
        rd = ResidentDeblocker(w, h, 35, device=dev)
        st = rd.step_time(frame, iters=50, repeats=2)
        print(f"resident 1080p batch {nb_t}: step {st['step_us']:.1f} us, ingest "
              f"{st['ingest_us']:.1f} us, readback {st['readback_us']:.1f} us (device time, "
              f"queued ahead: {st['queued_ahead']}); dispatch {st['dispatch_us']:.1f} us per eager "
              f"step, {st['dispatch_n_us']:.1f} us per step of run_steps(tf, 50); run_steps' "
              f"copy-out {st['copy_out_us']:.1f} us (device time) ({smi})")

    # -- 4c. where the time goes: device kernels by name (torch.profiler) ------------
    rd1 = ResidentDeblocker(w, h, 35, device=dev)
    trace("resident 1080p ingest + step + readback to the device, batch 1",
          lambda: _readback(rd1.step(rd1.ingest(frames4[0])), w, h))
    trace("resident 1080p ingest + step + readback to the device, batch 4",
          lambda: _readback(rd1.step(rd1.ingest(frames4)), w, h), reps=5)
    trace("streaming packed step 1080p, eager (_packed)", lambda: s._packed(buf, True))
    step_rows = trace("streaming packed _step 1080p, one graph replay", lambda: s._step(buf))
    stray = [key for _, _, key in step_rows if "deblock_packed_kernel" not in key]
    check(not stray, f"the streaming step ran kernels besides K2: {stray}")
    if step_rows:
        print("streaming step kernels in a graph replay: K2, and no other")
        busy = sum(us for us, _, _ in step_rows)
        # 200 replays: a replay is one launch (K2), and the profiler can miss
        # a window's first launches, all of a window of 20
        prof = profiled_device_us(lambda: s._step(buf), iters=200)
        check(prof is not None, "profiled_device_us found no device lane in the trace")
        print(f"profiled_device_us (Chrome trace, device-lane leaves): {prof[0]:.2f} us per replay "
              f"against key_averages() {busy:.2f} us, ratio {prof[0] / busy:.4f}; buckets "
              + ", ".join(f"{k} {v:.2f}" for k, v in prof[1].items()) + f" ({smi})")
        check(abs(prof[0] / busy - 1) <= 0.02, "profiled_device_us and key_averages() differ by "
                                               "more than 2%")

    # -- 4d. the quad K1 beside K1-i16, T5 and T1 --------------------------------------
    by, bx = RACE_SHAPE[2:]
    tiles, maps = tiles_maps(RACE_SHAPE, (by, bx))
    rows = tiles.permute(2, 0, 1, 3).contiguous()
    noise = torch.randint(0, 256, tiles.shape, dtype=torch.uint8, device=dev)
    noise_rows = noise.permute(2, 0, 1, 3).contiguous()
    off = [torch.zeros_like(m) for m in maps]  # BS 0: every segment gated off
    tiles_241, maps_241 = tiles_maps((8, 8, 136, 241), (136, 241))
    rows_241 = tiles_241.permute(2, 0, 1, 3).contiguous()  # T5's words route
    race = in_turns({
        "K1": lambda: ck.deblock_tiles_cuda(tiles, *maps, beta35, tc35),
        "K1-i16": lambda: ck.deblock_tiles_cuda(tiles, *maps, beta35, tc35, dtype=torch.int16),
        "T5": lambda: ck.deblock_rows_cuda(rows, *maps, beta35, tc35),
        "T1": lambda: sk.deblock_tiles_swar_cuda(tiles, *maps, beta35, tc35),
        "K1 on noise": lambda: ck.deblock_tiles_cuda(noise, *maps, beta35, tc35),
        "K1-i16 on noise": lambda: ck.deblock_tiles_cuda(noise, *maps, beta35, tc35,
                                                         dtype=torch.int16),
        "T5 on noise": lambda: ck.deblock_rows_cuda(noise_rows, *maps, beta35, tc35),
        "T1 on noise": lambda: sk.deblock_tiles_swar_cuda(noise, *maps, beta35, tc35),
        "K1 BS 0": lambda: ck.deblock_tiles_cuda(tiles, *off, beta35, tc35),
        "K1-i16 BS 0": lambda: ck.deblock_tiles_cuda(tiles, *off, beta35, tc35,
                                                     dtype=torch.int16),
        "T1 BS 0": lambda: sk.deblock_tiles_swar_cuda(tiles, *off, beta35, tc35),
        "T5 BS 0": lambda: ck.deblock_rows_cuda(rows, *off, beta35, tc35),
        "T5 Bx 241": lambda: ck.deblock_rows_cuda(rows_241, *maps_241, beta35, tc35),
    }, dict.fromkeys(("K1", "K1-i16", "T5", "T1", "K1 on noise", "K1-i16 on noise",
                      "T5 on noise", "T1 on noise", "K1 BS 0", "K1-i16 BS 0", "T1 BS 0",
                      "T5 BS 0", "T5 Bx 241"), 200))
    race_plain = in_turns({
        "int32": lambda: deblock_tiles_plain(tiles, *maps, beta35, tc35),
        "int16": lambda: deblock_tiles_plain(tiles, *maps, beta35, tc35, dtype=torch.int16),
        "rows": lambda: deblock_rows_plain(rows, *maps, beta35, tc35),
    }, {"int32": 5, "int16": 5, "rows": 5})
    race_bound = bytes_bound_ms(2 * tiles.numel() + 4 * maps[0].numel())
    print(f"race grid (8, 8, {by}, {bx}), blocky tiles, QP 35, against the quad K1 (4 lanes "
          f"per tile, TB {ck.BLOCK_BX}; K1-i16 the same quad at int16_t; T5 the quad on the "
          f"rows layout, TB {ck.ROWS_BLOCK_BX}, staged by TMA, at Bx 241 in words; T1 4 lanes "
          f"per tile pair, {sk.BLOCK} pairs a block): " + ", ".join(
              f"{k} {ms * 1e3:.2f} us" for k, (ms, _) in race.items())
        + f"; T1/K1 {race['T1'][0] / race['K1'][0]:.3f}, K1-i16/K1 "
        f"{race['K1-i16'][0] / race['K1'][0]:.3f}, T5/K1 {race['T5'][0] / race['K1'][0]:.3f}, "
        f"noise/blocky: K1 {race['K1 on noise'][0] / race['K1'][0]:.3f}, K1-i16 "
        f"{race['K1-i16 on noise'][0] / race['K1-i16'][0]:.3f}, T5 "
        f"{race['T5 on noise'][0] / race['T5'][0]:.3f}, T1 "
        f"{race['T1 on noise'][0] / race['T1'][0]:.3f}; BS 0/blocky: K1 "
        f"{race['K1 BS 0'][0] / race['K1'][0]:.3f}, K1-i16 "
        f"{race['K1-i16 BS 0'][0] / race['K1-i16'][0]:.3f}, T5 "
        f"{race['T5 BS 0'][0] / race['T5'][0]:.3f}, T1 "
        f"{race['T1 BS 0'][0] / race['T1'][0]:.3f}; "
        f"plain " + ", ".join(f"{k} {ms * 1e3:.0f} us" for k, (ms, _) in race_plain.items())
        + f"; bound {race_bound * 1e3:.2f} us (kernels queued ahead: "
        f"{all(ok for _, ok in race.values())}; device time; {smi})")
    def entry_stats(kname: str, occ: dict) -> dict:
        """Phase 0's numbers for the quad entry a timed launch ran."""
        e = quads[kname if kname in ("T1", "T5") else "K1-i16", kname.endswith("c"),
                  occ["word_bytes"] or 0]
        return {"registers": e["registers"], "spill_bytes": e["spill_stores"],
                "static_sass": e["sass"], "warps_per_sm": occ["warps_per_sm"]}

    i16_rows = {}
    for kname, chroma, shape, mshape in (("K1-i16", False, (8, 8, 136, 241), (136, 241)),
                                         ("K1-i16c", True, (2, 8, 8, 68, 121), (1, 68, 121))):
        t, m = tiles_maps(shape, mshape)
        r = in_turns({"int16": lambda: ck.deblock_tiles_cuda(t, *m, beta35, tc35, chroma=chroma,
                                                             dtype=torch.int16),
                      "int32": lambda: ck.deblock_tiles_cuda(t, *m, beta35, tc35, chroma=chroma),
                      "plain": lambda: deblock_tiles_plain(t, *m, beta35, tc35, chroma=chroma,
                                                           dtype=torch.int16)},
                     {"int16": 200, "int32": 200, "plain": 5})
        i16_rows[kname] = {"shape": str(shape), "ms": r["int16"][0], "int32_ms": r["int32"][0],
                           "plain_ms": r["plain"][0],
                           "bound_ms": bytes_bound_ms(2 * t.numel() + 4 * m[0].numel())}
        print(f"{kname} {shape}: int16 {r['int16'][0] * 1e3:.2f} us, int32 (K1/K1c) "
              f"{r['int32'][0] * 1e3:.2f} us, plain int16 {r['plain'][0] * 1e3:.0f} us (kernels "
              f"queued ahead: {r['int16'][1] and r['int32'][1]}; device time; {smi})")
    for kname, name in (("K1-i16", "K1-i16 luma deblock, int16 compute"),
                        ("K1-i16c", "K1-i16c chroma deblock, int16 compute")):
        row = i16_rows[kname]
        by_path = {"int16 frame path": i16_launches[kname], "tools": tool_launches[kname]}
        kernels.append({
            "name": f"{name} ({row['shape']})", "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": "gpu_video_codec_tpu/ops/pallas_kernel.py:139",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max_err[kname], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": "bytes", "library_ms": None,
            **({"race_grid_ms": race["K1-i16"][0]} if kname == "K1-i16" else {}),
            **entry_stats(kname, occupancy[kname, ck.BLOCK_BX]),
        })
    for kname, name, source, replaces, plain in (
            ("T5", "T5 rows-layout deblock (8, 8, 136, 256) as (136, 8, 8, 256)", KERNEL_SOURCE,
             "tools/rowslayout_exp.py:38", "rows"),
            ("T1", "T1 SWAR deblock (8, 8, 136, 256)", SWAR_SOURCE, "tools/swar_exp.py:522",
             "int32")):
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": tool_launches[kname], "launches_by_path": {"tools": tool_launches[kname]},
            "max_abs_err": max_err[kname], "ms": race[kname][0], "plain_ms": race_plain[plain][0],
            "bound_ms": race_bound, "bound_by": "bytes", "library_ms": None,
            "k1_ms_same_grid": race["K1"][0],
            **(entry_stats("T1", occupancy["T1", sk.BLOCK]) if kname == "T1" else {
                "staging": occupancy["T5"]["route"], "noise_ms": race["T5 on noise"][0],
                "bs0_ms": race["T5 BS 0"][0], "bx241_ms": race["T5 Bx 241"][0],
                **entry_stats("T5", occupancy["T5"])}),
        })

    # -- 4e. the mesh paths' times ------------------------------------------------------
    fns = {"_step": lambda: s._step(buf), **{f"k={k}": packed_step(k) for k in (1, 4, 8)}}
    r = in_turns(fns, dict.fromkeys(fns, 50))
    print("batched packed step 1080p (deblock_packed_batch_sharded_jit, one slot): " + ", ".join(
        f"{name} {ms * 1e3:.2f} us" + (f" ({ms * 1e3 / int(name[2:]):.2f} us per frame)"
                                       if name != "_step" else "")
        for name, (ms, _) in r.items())
        + f" (queued ahead: {all(ok for _, ok in r.values())}; device time; {smi})")
    steps_r = 32  # 128 frames a run
    streams_r = [[frames[(n_ms * t + i) % n] for t in range(steps_r)] for i in range(n_ms)]
    flat_frames = [streams_r[i][t] for t in range(steps_r) for i in range(n_ms)]
    ms4 = MultiStreamDeblocker(mesh11, n_ms, w, h, 35)
    ring_s, compute_s = s._device_ring()

    def stream_rb():
        for _ in s.run(flat_frames):
            pass

    def stream_norb():
        for f in flat_frames:
            ring_s.submit(f.reshape(3 * h // 2, w), compute_s, False)

    def multi_rb():
        for _ in ms4.run(streams_r):
            pass

    def multi_norb():
        for t in range(steps_r):
            ms4._dispatch([st[t] for st in streams_r], readback=False)

    rates = {name: [] for name in ("stream", "multi", "stream no-rb", "multi no-rb")}
    for fn in (stream_rb, multi_rb, stream_norb, multi_norb):
        fn()  # warm-up: rings and graphs
    torch.cuda.synchronize()
    for _ in range(3):
        for name, fn in (("stream", stream_rb), ("multi", multi_rb), ("multi", multi_rb),
                         ("stream", stream_rb), ("stream no-rb", stream_norb),
                         ("multi no-rb", multi_norb), ("multi no-rb", multi_norb),
                         ("stream no-rb", stream_norb)):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            rates[name].append(len(flat_frames) / (time.perf_counter() - t0))
    print(f"1080p fps over the same {len(flat_frames)} frames, in turns (S M M S), 6 runs each "
          f"(host wall clock to a synchronize): " + "; ".join(
              f"{name} median {np.median(v):.0f} (min {min(v):.0f}, max {max(v):.0f})"
              for name, v in rates.items())
          + f" -- StreamingDeblocker.run vs MultiStreamDeblocker.run at {n_ms} streams, with "
          f"and without read-back ({smi}; host {cpu_model}, nproc {nproc})")

    # -- 5c. validate_vs_reference's fuzz cases through the cuda backend ---------------
    reset()
    n_fuzz = sheared = above_51 = lcg = 0
    t0 = time.perf_counter()
    for n_cases, max_w, max_h in ((48, 128, 96), (8, 1024, 576)):
        for w, h, qp, bs_seed, raw in fuzz_cases(n_cases, 0, max_w, max_h):
            bs = case_bs(w, h, bs_seed)
            frame = planes_from_yv12_bytes(raw, w, h)
            got = DeblockPipeline(w, h, qp, backend="cuda", bs=bs, device=dev)(frame)
            gold = deblock_frame_golden(frame, bs, qp)
            for k in "yuv":
                check(np.array_equal(getattr(got, k), getattr(gold, k)),
                      f"fuzz {w}x{h} qp={qp} bs_seed={bs_seed}: plane {k} != golden")
            n_fuzz += 1
            sheared += w % 16 == 8
            above_51 += qp > 51
            lcg += bs_seed is not None
    fuzz_launches = counts()
    check(fuzz_launches == only(T2=3 * n_fuzz, K1=n_fuzz, K1c=n_fuzz, T3=3 * n_fuzz),
          f"fuzz: launches {fuzz_launches} for {n_fuzz} frames")
    check(sheared > 0 and above_51 > 0 and lcg > 0,
          f"fuzz: {sheared} sheared widths, {above_51} QPs above 51, {lcg} LCG BS")
    print(f"fuzz (validate_vs_reference.fuzz_cases, seed 0; 48 up to 128x96, 8 up to 1024x576): "
          f"{n_fuzz} cases through DeblockPipeline(backend='cuda') == golden, every extended "
          f"plane byte for byte; {sheared} sheared widths (w % 16 == 8), {above_51} QPs above 51, "
          f"{lcg} with the LCG's luma BS; launches {fuzz_launches}; "
          f"{time.perf_counter() - t0:.1f} s")

    # the same cases through the packed streaming step (the tool's --backend
    # packed): K2 where its guard takes the width, the chain elsewhere
    reset()
    n_k2 = 0
    t0 = time.perf_counter()
    for n_cases, max_w, max_h in ((48, 128, 96), (8, 1024, 576)):
        for w_, h_, qp, bs_seed, raw_ in fuzz_cases(n_cases, 0, max_w, max_h):
            bs_ = case_bs(w_, h_, bs_seed)
            frame = planes_from_yv12_bytes(raw_, w_, h_)
            got = deblocked(frame, bs_, qp, "packed", dev)
            check(got.tobytes() == yv12_bytes_from_planes(deblock_frame_golden(frame, bs_, qp)),
                  f"fuzz {w_}x{h_} qp={qp} bs_seed={bs_seed}: the packed step != golden")
            n_k2 += ck.packed_fits(w_)
    fuzz_k2 = counts()
    m = n_fuzz - n_k2
    want = only(K2=n_k2, T2=2 * m, K1=m, K1c=m, T3=2 * m)
    check(fuzz_k2 == want and n_k2 > 0, f"fuzz, packed step: launches {fuzz_k2}, want {want}")
    print(f"fuzz through the packed streaming step (validate_vs_reference --backend packed): "
          f"{n_fuzz} cases == golden, {n_k2} through K2 and {n_fuzz - n_k2} through the chain; "
          f"launches {fuzz_k2}; {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
