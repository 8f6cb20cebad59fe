"""Command-line entry point: the reference main()'s role (main.cu:109-141), with
actual argument parsing instead of hand-edited constants.

    python -m gpu_video_codec_tpu_torch.cli --input in.yuv --width 352 \
        --height 288 --qp 35 --output out.yuv [--backend cuda|torch|golden|native]
    python -m gpu_video_codec_tpu_torch.cli --device-info
    python -m gpu_video_codec_tpu_torch.cli --input ... --bench   # timing split
    python -m gpu_video_codec_tpu_torch.cli --input ... --batch 4  # resident, 4 frames a launch
    python -m gpu_video_codec_tpu_torch.cli --input ... --streams 4 --mesh 1,1  # multi-stream
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .utils.config import BACKENDS, DeblockConfig


def device_info() -> dict:
    """GetGpuDeviceInfo equivalent (main.cu:92-107): per CUDA device its
    name, total global memory, SM count and warp size; and, where the
    native runtime builds, its SIMD tier and OpenMP threads (the reference
    prints CPU info beside the GPU's)."""
    import torch

    devices = []
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            props = torch.cuda.get_device_properties(i)
            devices.append({
                "id": i,
                "name": props.name,
                "total_memory": props.total_memory,
                "multi_processor_count": props.multi_processor_count,
                "warp_size": getattr(props, "warp_size", None),
                "capability": f"{props.major}.{props.minor}",
            })
    info = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "num_devices": len(devices),
        "devices": devices,
    }
    from .runtime import native

    if native.available():
        info["native_runtime"] = {
            "isa": native.active_isa(),
            "omp_max_threads": native.load().gvct_num_threads(),
        }
    return info


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gpu_video_codec_tpu_torch.cli",
        description="HEVC in-loop deblocking of raw YV12 frames on a CUDA GPU",
    )
    p.add_argument("--input", "-i", help="input YV12 file (single frame or stream)")
    p.add_argument("--output", "-o", help="output YV12 file")
    p.add_argument("--width", "-W", type=int, help="frame width (multiple of 8)")
    p.add_argument("--height", "-H", type=int, help="frame height (multiple of 8)")
    p.add_argument("--qp", type=int, default=20, help="quantization parameter (default 20)")
    p.add_argument("--backend", choices=BACKENDS, default="cuda")
    p.add_argument("--device", default="cuda",
                   help="torch device of the cuda/torch backends (default cuda)")
    p.add_argument("--luma-only", action="store_true", help="skip chroma filtering")
    p.add_argument("--frames", type=int, help="max frames to process from a stream")
    p.add_argument("--num-threads", type=int, default=0,
                   help="native backend OpenMP thread count (0 = default)")
    p.add_argument("--depth", type=int, default=2, help="streaming frames in flight")
    p.add_argument("--bench", action="store_true",
                   help="add a per-frame timing breakdown to the JSON result "
                        "(copy vs step on a CUDA device, filter time on the host "
                        "backends golden and native)")
    p.add_argument("--batch", type=int,
                   help="process N frames per kernel launch through the device-resident "
                        "pipeline (models/resident.py)")
    p.add_argument("--streams", type=int,
                   help="treat INPUT as N concatenated streams processed concurrently over "
                        "a mesh of device slots (multi-stream mode)")
    p.add_argument("--mesh", metavar="DATA,SPATIAL",
                   help="mesh shape for --streams, e.g. 2,4 (default: from the CUDA device "
                        "count)")
    p.add_argument("--device-info", action="store_true", help="print device info and exit")
    return p


def _raw_frames(path: str, frame_bytes: int, max_frames: int | None):
    """Yield raw YV12 frame buffers straight from disk (memory stays
    O(pipeline depth) for long streams)."""
    count = 0
    with open(path, "rb") as f:
        while max_frames is None or count < max_frames:
            data = f.read(frame_bytes)
            if len(data) < frame_bytes:
                break
            count += 1
            yield data


def run_multistream(cfg: DeblockConfig, n_streams: int, mesh_spec: str | None) -> dict:
    """Multi-stream mode: frames of INPUT are assigned round-robin to
    n_streams concurrent streams and each batch of n_streams frames is
    deblocked in one mesh step (BASELINE config 5).  Outputs keep the
    input's frame order.  A last short batch is filled with zero frames
    (a fixed point of the filter) whose outputs are dropped, so every input
    frame is filtered and written (the JAX CLI drops the tail frames).

    --device cuda (the default) builds the mesh over every CUDA device
    (make_mesh); any other device, e.g. cpu or cuda:0, fills every slot."""
    import os

    import numpy as np
    import torch

    from .parallel import MultiStreamDeblocker, default_mesh_shape, make_mesh

    if n_streams < 1:
        raise ValueError(f"--streams must be >= 1, got {n_streams}")
    if cfg.backend not in ("cuda", "torch"):
        raise ValueError(
            f"--streams requires a device backend ('cuda' or 'torch'), got {cfg.backend!r}")
    if mesh_spec:
        n_data, n_spatial = (int(x) for x in mesh_spec.split(","))
    else:
        n_data, n_spatial = default_mesh_shape(torch.cuda.device_count())
    devices = None if cfg.device == "cuda" else [cfg.device] * (n_data * n_spatial)
    mesh = make_mesh(n_data, n_spatial, devices)
    ms = MultiStreamDeblocker(mesh, n_streams, cfg.width, cfg.height, cfg.qp,
                              backend=cfg.backend, luma_only=cfg.luma_only, depth=cfg.depth)

    frame_bytes = 3 * cfg.width * cfg.height // 2
    n_avail = os.path.getsize(cfg.input) // frame_bytes
    n = n_avail if cfg.frames is None else min(cfg.frames, n_avail)
    if n == 0:
        raise ValueError(f"no complete {cfg.width}x{cfg.height} frames in {cfg.input}")
    zero = np.zeros(frame_bytes, np.uint8)

    def batches():
        group: list = []
        for raw in _raw_frames(cfg.input, frame_bytes, n):
            group.append(raw)
            if len(group) == n_streams:
                yield group
                group = []
        if group:
            yield group + [zero] * (n_streams - len(group))

    sink = open(cfg.output, "wb") if cfg.output else None
    done = 0
    try:
        t0 = time.perf_counter()
        # overlapped: `depth` batches in flight (the next batch's H2D under
        # the current batch's kernels), not a serial step() loop
        for outs in ms.run_batches(batches()):
            outs = outs[: n - done]  # the tail batch's zero frames are dropped
            for out in outs:
                if sink is not None:
                    sink.write(out.tobytes())
            done += len(outs)
        dt = time.perf_counter() - t0
    finally:
        if sink is not None:
            sink.close()
    return {
        "frames": done, "streams": n_streams,
        "mesh": {"data": n_data, "spatial": n_spatial},
        "backend": cfg.backend, "qp": cfg.qp, "device": str(mesh.device(0)),
        "seconds": dt, "fps": done / dt,
    }


def run_batched(cfg: DeblockConfig, batch: int) -> dict:
    """Batched device-resident mode: N frames per kernel launch (the batch
    is the kernels' outermost grid dimension).  A short tail group runs as
    its own (smaller) batch."""
    import os

    import numpy as np

    from .models.resident import ResidentDeblocker

    if batch < 1:
        raise ValueError(f"--batch must be >= 1, got {batch}")
    rd = ResidentDeblocker(cfg.width, cfg.height, cfg.qp, luma_only=cfg.luma_only,
                           device=cfg.device)
    frame_bytes = rd.frame_bytes
    n_avail = os.path.getsize(cfg.input) // frame_bytes
    if n_avail == 0:
        raise ValueError(f"no complete {cfg.width}x{cfg.height} frames in {cfg.input}")
    n = n_avail if cfg.frames is None else min(cfg.frames, n_avail)

    sink = open(cfg.output, "wb") if cfg.output else None
    done = 0
    try:
        t0 = time.perf_counter()
        group: list[bytes] = []

        def flush(group):
            out = rd(np.stack([np.frombuffer(g, np.uint8) for g in group]))
            if sink is not None:
                sink.write(out.tobytes())
            return len(group)

        for raw in _raw_frames(cfg.input, frame_bytes, n):
            group.append(raw)
            if len(group) == batch:
                done += flush(group)
                group = []
        if group:
            done += flush(group)
        dt = time.perf_counter() - t0
    finally:
        if sink is not None:
            sink.close()
    return {
        "frames": done, "batch": batch, "mode": "resident",
        "backend": "cuda", "qp": cfg.qp, "device": str(rd.device),
        "seconds": dt, "fps": done / dt,
    }


def run(cfg: DeblockConfig, bench: bool = False) -> dict:
    import os

    frame_bytes = 3 * cfg.width * cfg.height // 2
    n_avail = os.path.getsize(cfg.input) // frame_bytes
    if n_avail == 0:
        raise ValueError(f"no complete {cfg.width}x{cfg.height} frames in {cfg.input}")
    n = n_avail if cfg.frames is None else min(cfg.frames, n_avail)

    result: dict = {"frames": n, "backend": cfg.backend, "qp": cfg.qp}

    if cfg.backend in ("cuda", "torch"):
        # device path: raw packed frames, copy-overlap streaming, incremental
        # output writes
        from .models.streaming import StreamingDeblocker

        s = StreamingDeblocker(cfg.width, cfg.height, cfg.qp, backend=cfg.backend,
                               luma_only=cfg.luma_only, depth=cfg.depth, device=cfg.device)
        result["device"] = str(s.device)
        sink = open(cfg.output, "wb") if cfg.output else None
        try:
            t0 = time.perf_counter()
            for o in s.run(_raw_frames(cfg.input, frame_bytes, n)):
                if sink is not None:
                    sink.write(o.tobytes())
            dt = time.perf_counter() - t0
        finally:
            if sink is not None:
                sink.close()
        if bench:
            with open(cfg.input, "rb") as f:
                first_raw = f.read(frame_bytes)
            timing = {}
            for k, v in s.time_breakdown(first_raw).items():
                if isinstance(v, dict):  # device_split_us: already µs by category
                    timing[k] = v
                else:
                    timing[k.removesuffix("_s") + "_us"] = round(v * 1e6, 1)
            result["timing"] = timing
            result["timing_unit"] = "us/frame"
    else:
        from .models.pipeline import DeblockPipeline
        from .utils.yuv import planes_from_yv12_bytes, yv12_bytes_from_planes

        pipe = DeblockPipeline(cfg.width, cfg.height, cfg.qp, luma_only=cfg.luma_only,
                               backend=cfg.backend, num_threads=cfg.num_threads)
        if cfg.backend == "native":
            from .runtime import native

            native.load()  # built and loaded before the timed frames
        sink = open(cfg.output, "wb") if cfg.output else None
        try:
            t0 = time.perf_counter()
            per_frame = []
            for raw in _raw_frames(cfg.input, frame_bytes, n):
                f0 = time.perf_counter()
                out = pipe(planes_from_yv12_bytes(raw, cfg.width, cfg.height))
                per_frame.append(time.perf_counter() - f0)
                if sink is not None:
                    sink.write(yv12_bytes_from_planes(out))
            dt = time.perf_counter() - t0
        finally:
            if sink is not None:
                sink.close()
        if bench:
            result["timing"] = {"filter_us": round(min(per_frame) * 1e6, 1)}
            result["timing_unit"] = "us/frame"

    result["seconds"] = dt
    result["fps"] = n / dt
    return result


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.device_info:
        print(json.dumps(device_info(), indent=2))
        return 0
    if not args.input or args.width is None or args.height is None:
        print("error: --input, --width and --height are required", file=sys.stderr)
        return 2
    try:
        cfg = DeblockConfig(
            input=args.input, width=args.width, height=args.height, qp=args.qp,
            output=args.output, backend=args.backend, luma_only=args.luma_only,
            frames=args.frames, num_threads=args.num_threads, depth=args.depth,
            device=args.device,
        ).validate()
        if args.batch is not None and args.streams is not None:
            raise ValueError("--batch and --streams are mutually exclusive "
                             "(batched resident vs mesh multi-stream mode)")
        if args.batch is not None:
            # the batched mode runs the device-resident pipeline through the
            # kernels: reject rather than silently override --backend
            if args.backend != "cuda":
                raise ValueError(f"--batch uses the device-resident cuda pipeline; "
                                 f"--backend {args.backend} is not supported with it")
            if args.bench:
                raise ValueError("--bench is not supported with --batch; "
                                 "ResidentDeblocker.step_time times the resident path")
        if args.streams is not None and args.bench:
            raise ValueError("--bench is not supported with --streams")
        if args.streams is not None:
            result = run_multistream(cfg, args.streams, args.mesh)
        elif args.batch is not None:
            result = run_batched(cfg, args.batch)
        else:
            result = run(cfg, bench=args.bench)
    except (ValueError, FileNotFoundError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
