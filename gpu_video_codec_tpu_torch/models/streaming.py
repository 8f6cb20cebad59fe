"""Streaming YV12 pipeline with host-to-device copy overlap, in PyTorch.

Counterpart of the main path of gpu_video_codec_tpu/models/streaming.py:

* ONE host-to-device copy per frame, of the raw packed YV12 buffer viewed
  as (3h/2, w) rows, from a ring of pinned host buffers on a copy stream;
  the compute stream waits on the copy's event, so the copy of frame i+1
  runs under the filter of frame i;
* per frame, luma goes interior -> tile-planes (T2) -> deblock kernel
  (K1) -> interior (T3), and U and V go the same way as one batch, one
  launch each of T2, K1c and T3 (ops/relayout_kernel.py,
  ops/cuda_kernel.py);
* T3 writes the filtered planes straight into the frame's device buffer,
  in place (the counterpart of buffer donation on the TPU).

Reference parity map: ExecuteGpu's alloc/copy/launch/copy/save sequence
(gpu.cu:1230-1306) becomes StreamingDeblocker.run(); the copy-vs-kernel
timing split (gpu.cu:1246-1303) is time_breakdown(), timed with CUDA events.
"""

from __future__ import annotations

import time
from collections import deque
from collections.abc import Iterable, Iterator

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.cuda_kernel import BLOCK_BX, CHROMA_BLOCK_BX, deblock_tiles_cuda
from ..ops.deblock import deblock_frame
from ..ops.relayout_kernel import plane_to_tiles_cuda, tiles_to_plane_cuda
from ..ops.tables import HALF_BLOCK, SAMPLE_BLOCK_SIZE, get_beta, get_tc
from ..utils.bs import BoundaryStrength, segment_bs_maps_device
from ..utils.tiles import split_covered_data
from ..utils.yuv import FramePlanes, check_dims


def _pack_out(buf, parts_at, inplace: bool):
    """Write the filtered (row-offset, segment) pieces into the packed
    buffer.  inplace=True writes into `buf` itself (a buffer the caller
    owns); unwritten rows (e.g. chroma under luma_only) keep their input
    bytes, like the reference's in-place plane filtering (cpu.h:146-447).
    inplace=False writes into a copy and leaves `buf` untouched."""
    out = buf if inplace else buf.clone()
    for off, p in parts_at:
        out[off : off + p.shape[0]].copy_(p)
    return out


def _deblock_planes_impl(y, uv, lm, cm, beta, tc, w, h, luma_only, backend,
                         luma_block=BLOCK_BX, chroma_block=CHROMA_BLOCK_BX, out=None):
    """PLANES contract: y (h, w) + uv (2, h/2, w/2) uint8 -> (filtered y,
    filtered uv), same shapes, new tensors (uv itself under luma_only).

    backend "cuda": luma goes interior -> tile-planes (T2) -> K1 ->
    interior (T3); T2 does the Q6 zero padding.  U and V go the same way as
    a batch of two, one launch each, with one shared map, whenever the
    extended chroma width is 8-aligned (the non-sheared Q9 case, every
    w % 16 == 0 geometry).  Sheared geometries (Q9) pad U and V and run
    T2, K1c and T3 with pad 0 on the flat covered core of the padded pair,
    whose uncovered remainder stays as it was.
    out: optional (y, uv) destinations the cuda backend's T3 writes into
    (any strides, last axis contiguous), returned in place of new tensors.
    backend "torch": the plain version on zero-extended planes."""
    p = HALF_BLOCK
    cw, ch = w // 2, h // 2
    pads = (p, p, p, p)
    if backend == "cuda":
        y_dst, uv_dst = out or (None, None)
        yt = deblock_tiles_cuda(plane_to_tiles_cuda(y, p), *lm, beta, tc, chroma=False,
                                block_bx=luma_block)
        y_int = tiles_to_plane_cuda(yt, p, h, w, out=y_dst)
        if luma_only:
            return y_int, uv
        cmaps = [m[None] for m in cm]  # one shared map across the U/V batch
        if (cw + 2 * p) % SAMPLE_BLOCK_SIZE == 0:
            uvt = deblock_tiles_cuda(plane_to_tiles_cuda(uv, p), *cmaps, beta, tc,
                                     chroma=True, block_bx=chroma_block)
            return y_int, tiles_to_plane_cuda(uvt, p, ch, cw, out=uv_dst)
        uv_ext = F.pad(uv, pads)  # a fresh pair: T3 writes its covered core back in place
        core, _ = split_covered_data(uv_ext)
        uvt = deblock_tiles_cuda(plane_to_tiles_cuda(core, 0), *cmaps, beta, tc, chroma=True,
                                 block_bx=chroma_block)
        tiles_to_plane_cuda(uvt, 0, *core.shape[-2:], out=core)
        uv_int = uv_ext[:, p : p + ch, p : p + cw]
        return y_int, uv_int.contiguous() if uv_dst is None else uv_dst.copy_(uv_int)
    ye, ue, ve = deblock_frame(F.pad(y, pads), F.pad(uv[0], pads), F.pad(uv[1], pads),
                               lm, cm, beta, tc, luma_only=luma_only)
    y_int = ye[p : p + h, p : p + w]
    if luma_only:
        return y_int, uv
    return y_int, torch.stack([ue[p : p + ch, p : p + cw], ve[p : p + ch, p : p + cw]])


def _deblock_yv12_packed_impl(buf, lm, cm, beta, tc, w, h, luma_only, backend,
                              luma_block=BLOCK_BX, chroma_block=CHROMA_BLOCK_BX,
                              inplace=False):
    """Packed YV12 uint8 (3h/2, w) -> filtered packed YV12.

    Luma is the leading h rows; the chroma rows are U then V, viewed as
    (2, h/2, w/2).  The filter is the planes contract; inplace=True writes
    the result back into `buf` and returns it, inplace=False returns a new
    buffer and leaves `buf` untouched.  The cuda backend's T3 writes the
    filtered planes straight into the destination buffer; rows it does not
    filter (chroma under luma_only) keep their input bytes."""
    y = buf[:h]
    uv = buf[h:].view(2, h // 2, w // 2)
    if backend == "cuda":
        dst = buf if inplace else torch.empty_like(buf)
        if luma_only and not inplace:
            dst[h:].copy_(buf[h:])
        _deblock_planes_impl(y, uv, lm, cm, beta, tc, w, h, luma_only, backend, luma_block,
                             chroma_block, out=(dst[:h], dst[h:].view(2, h // 2, w // 2)))
        return dst
    y_int, uv_int = _deblock_planes_impl(y, uv, lm, cm, beta, tc, w, h, luma_only, backend,
                                         luma_block, chroma_block)
    parts = [(0, y_int)]
    if not luma_only:
        parts.append((h, uv_int.reshape(h // 2, w)))
    return _pack_out(buf, parts, inplace)


class StreamingDeblocker:
    """Deblocks a stream of same-geometry raw YV12 frames with copy/compute
    overlap.  Frames are 1-D uint8 arrays of size 3*w*h/2 (or bytes).

    depth: frames in flight (2 = classic double buffering).
    backend: "cuda" (the hand-written kernels T2, K1/K1c and T3) or "torch"
    (the plain version).
    device: the torch device that holds frames and runs the filter; a CUDA
    device must exist (nothing falls back to the CPU).  On a CPU device the
    "cuda" backend's wrapper runs the plain version.
    luma_block/chroma_block: tiles per block of K1 and K1c (the kernel runs
    four threads per tile).
    """

    def __init__(self, width: int, height: int, qp: int, *,
                 backend: str = "cuda", luma_only: bool = False,
                 depth: int = 2, bs: BoundaryStrength | None = None,
                 luma_block: int = BLOCK_BX, chroma_block: int = CHROMA_BLOCK_BX,
                 device="cuda"):
        if backend not in ("cuda", "torch"):
            raise ValueError(f"streaming backend must be 'cuda' or 'torch', got {backend!r}")
        check_dims(width, height)  # reference contract (cpu.h:46-48)
        self.device = torch.device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"device must be a CUDA or CPU device, got {self.device}")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but CUDA is not available")
        self.width, self.height, self.qp = width, height, int(qp)
        self.depth = max(1, depth)
        self.frame_bytes = 3 * width * height // 2
        self._rows = 3 * height // 2
        self._beta = get_beta(qp)
        self._tc = get_tc(qp)
        self._luma_only = luma_only
        self._backend = backend
        self._luma_block = int(luma_block)
        self._chroma_block = int(chroma_block)
        if self.device.type == "cuda":
            # depth + 1 pinned staging buffers: a slot is refilled only after
            # the copy that last read it has finished (its event)
            self._copy_stream = torch.cuda.Stream(self.device)
            self._ring = [torch.empty((self._rows, width), dtype=torch.uint8, pin_memory=True)
                          for _ in range(self.depth + 1)]
            self._ring_done: list = [None] * len(self._ring)
            self._ring_next = 0
        self.update_boundary_strength(bs or BoundaryStrength.intra_default(width, height))

    def update_boundary_strength(self, bs: BoundaryStrength) -> None:
        """Install new BS arrays mid-stream (the streaming equivalent of the
        reference's SetBoundaryStrenght, cpu.h:120-132).  The segment gate
        maps are derived on the device (utils.bs.segment_bs_maps_device);
        chroma gates with the luma tile counts (quirk Q2)."""
        if (bs.width, bs.height) != (self.width, self.height):
            raise ValueError("BoundaryStrength geometry mismatch")
        b = SAMPLE_BLOCK_SIZE
        w, h = self.width, self.height
        ny, nx = h // b + 1, w // b + 1
        cny, cnx = (h // 2) // b + 1, (w // 2) // b + 1
        self._lm = segment_bs_maps_device(bs.vert, bs.hor, w, ny, nx, ny, nx,
                                          device=self.device)
        self._cm = segment_bs_maps_device(bs.chroma_vert, bs.chroma_hor, w // 2,
                                          cny, cnx, ny, nx, device=self.device)

    def _packed(self, dev_buf, inplace: bool):
        return _deblock_yv12_packed_impl(
            dev_buf, self._lm, self._cm, self._beta, self._tc, self.width, self.height,
            self._luma_only, self._backend, self._luma_block, self._chroma_block,
            inplace=inplace)

    def _step(self, dev_buf):
        """One packed deblock step, IN PLACE: the filtered frame is written
        back into dev_buf (a (3h/2, w) uint8 device buffer the caller hands
        over, such as a fresh _put), which is returned."""
        return self._packed(dev_buf, inplace=True)

    def _step_borrow(self, dev_buf):
        """The same step into a new buffer; dev_buf stays untouched."""
        return self._packed(dev_buf, inplace=False)

    def step_planes(self, y, uv):
        """One deblock step at PLANE granularity: y (h, w) + uv (2, h/2, w/2)
        uint8 device tensors -> (filtered y, filtered uv), new tensors."""
        return _deblock_planes_impl(
            y, uv, self._lm, self._cm, self._beta, self._tc, self.width, self.height,
            self._luma_only, self._backend, self._luma_block, self._chroma_block)

    def put_planes(self, frame):
        """Host packed YV12 frame -> (y, uv) device plane tensors (two
        host-to-device copies, mirroring the reference's per-plane
        cudaMemcpys, gpu.cu:1248-1250)."""
        arr = self._host_frame(frame)
        w, h = self.width, self.height
        y = torch.from_numpy(arr[: w * h].reshape(h, w).copy()).to(self.device)
        uv = torch.from_numpy(arr[w * h :].reshape(2, h // 2, w // 2).copy()).to(self.device)
        return y, uv

    def _host_frame(self, frame) -> np.ndarray:
        """Normalize a frame (bytes or array-like) to a validated uint8 buffer."""
        arr = (np.frombuffer(frame, np.uint8) if isinstance(frame, (bytes, bytearray))
               else np.asarray(frame, np.uint8).ravel())
        if arr.size != self.frame_bytes:
            raise ValueError(f"frame must be {self.frame_bytes} bytes, got {arr.size}")
        return arr

    def _put(self, frame):
        """Copy one packed frame to a fresh (3h/2, w) device buffer.  On a
        CUDA device the copy runs from a pinned ring slot on the copy
        stream, and the current stream waits for it without blocking the
        host."""
        rows = self._host_frame(frame).reshape(self._rows, self.width)
        if self.device.type == "cpu":
            return torch.from_numpy(rows.copy())
        i = self._ring_next
        self._ring_next = (i + 1) % len(self._ring)
        if self._ring_done[i] is not None:
            self._ring_done[i].synchronize()
        host = self._ring[i]
        host.numpy()[...] = rows
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            # allocated on the copy stream; record_stream below keeps the
            # allocator from reusing it before the compute stream is done
            dev = torch.empty((self._rows, self.width), dtype=torch.uint8, device=self.device)
            dev.copy_(host, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        self._ring_done[i] = done
        compute.wait_event(done)
        dev.record_stream(compute)
        return dev

    @staticmethod
    def _fetch(dev_buf) -> np.ndarray:
        """Device buffer -> flat host array that owns its bytes."""
        return dev_buf.cpu().numpy().reshape(-1)

    def run(self, frames: Iterable) -> Iterator[np.ndarray]:
        """Yield filtered packed YV12 frames (np.uint8, flat), in order.
        The copy of frame i+1 overlaps the filter of frame i; up to `depth`
        frames are in flight before the oldest is read back.  Every yielded
        array is a fresh host copy."""
        inflight: deque = deque()
        for frame in frames:
            inflight.append(self._step(self._put(frame)))
            if len(inflight) >= self.depth:
                yield self._fetch(inflight.popleft())
        while inflight:
            yield self._fetch(inflight.popleft())

    def run_frames(self, frames: Iterable[FramePlanes]) -> Iterator[FramePlanes]:
        """FramePlanes convenience wrapper around run()."""
        from ..utils.yuv import planes_from_yv12_bytes, yv12_bytes_from_planes

        packed = (np.frombuffer(yv12_bytes_from_planes(f), np.uint8) for f in frames)
        for out in self.run(packed):
            yield planes_from_yv12_bytes(out, self.width, self.height)

    # -- measurement (CUDA devices only) -------------------------------------

    def _require_cuda(self, what: str) -> None:
        if self.device.type != "cuda":
            raise RuntimeError(f"{what} times the CUDA device; this deblocker runs on "
                               f"{self.device}")

    def throughput(self, frame, n_frames: int = 100, readback: bool = False,
                   repeats: int = 3) -> dict:
        """Steady-state pipelined rate over n_frames copies of `frame`, from
        CUDA events on the compute stream (best of `repeats` batches).

        readback=False: copy in + filter, outputs stay on the device;
        readback=True: every output is read back to the host (run())."""
        self._require_cuda("throughput")
        arr = self._host_frame(frame)
        self._step(self._put(arr))  # warm-up: builds and loads the kernel
        torch.cuda.synchronize(self.device)
        stream = torch.cuda.current_stream(self.device)

        def one_batch() -> float:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            if readback:
                for _ in self.run(arr for _ in range(n_frames)):
                    pass
            else:
                for _ in range(n_frames):
                    self._step(self._put(arr))
            end.record(stream)
            end.synchronize()
            return start.elapsed_time(end) / 1e3

        dt = min(one_batch() for _ in range(repeats)) / n_frames
        return {
            "frames": n_frames,
            "per_frame_s": dt,
            "fps": 1.0 / dt,
            "mpix_per_s": self.width * self.height / dt / 1e6,
            "readback": readback,
            "device": torch.cuda.get_device_name(self.device),
        }

    def time_breakdown(self, frame, n: int = 30) -> dict:
        """Per-frame split, best of 3 runs of n (the reference's 'with
        copy'/'without copy' table, gpu.cu:1292-1303):

        h2d_s: copy-stream time per _put (CUDA events; includes waiting for
               the host to stage the frame into pinned memory);
        kernel_s: compute-stream time per packed _step, chained in place on
               one buffer (CUDA events; when the host enqueues slower than
               the device runs, this is the enqueue rate);
        dispatch_s: host wall time per _step call (enqueue only)."""
        self._require_cuda("time_breakdown")
        arr = self._host_frame(frame)
        buf = self._step(self._put(arr))  # warm-up: builds and loads the kernel
        torch.cuda.synchronize(self.device)
        compute = torch.cuda.current_stream(self.device)

        def per_call(fn, stream) -> float:
            best = float("inf")
            for _ in range(3):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(stream)
                for _ in range(n):
                    fn()
                end.record(stream)
                end.synchronize()
                best = min(best, start.elapsed_time(end) / 1e3 / n)
            return best

        h2d = per_call(lambda: self._put(arr), self._copy_stream)
        kernel = per_call(lambda: self._step(buf), compute)
        t0 = time.perf_counter()
        for _ in range(n):
            self._step(buf)
        dispatch = (time.perf_counter() - t0) / n
        torch.cuda.synchronize(self.device)
        return {"h2d_s": h2d, "kernel_s": kernel, "dispatch_s": dispatch}
