"""Streaming YV12 pipeline with host-to-device copy overlap, in PyTorch.

Counterpart of the main path of gpu_video_codec_tpu/models/streaming.py:

* ONE host-to-device copy per frame, of the raw packed YV12 buffer viewed
  as (3h/2, w) rows, from a ring of pinned host buffers on a copy stream;
  the compute stream waits on the copy's event, so the copy of frame i+1
  runs under the filter of frame i;
* per step (a frame, or a batch of frames), one launch of K2
  (ops/cuda_kernel.deblock_packed_cuda): each block's shifted 8x8 tiles
  are staged by TMA straight from the frame's planes, filtered and stored
  back into the frame's device buffer, in place (the counterpart of buffer
  donation on the TPU), wherever K2's guard (packed_fits: w % 32 == 0 and
  16-byte aligned buffers) holds.  Elsewhere -- the sheared widths (Q9),
  w % 32 == 16, misaligned buffers -- luma goes interior -> tile-planes
  (T2) -> deblock kernel (K1) -> interior (T3), and U and V go the same way
  as one batch, one launch each of T2, K1c and T3 (ops/chain.tile_chain),
  T3 writing straight into the frame's buffer;
* on a CUDA device with the cuda backend a step is ONE replay of a CUDA
  graph of those launches (utils/graphs.py), the counterpart of one jit
  dispatch: _step and _chain replay a graph per buffer from a bounded
  cache, and run() goes through a fixed ring of device slots, each with
  its step graph, that overlaps H2D(i+1), the step of frame i and
  D2H(i-depth) on three streams.

Reference parity map: ExecuteGpu's alloc/copy/launch/copy/save sequence
(gpu.cu:1230-1306) becomes StreamingDeblocker.run(); the copy-vs-kernel
timing split (gpu.cu:1246-1303) is time_breakdown(), timed with CUDA events
and torch.profiler (utils/tracing.py).
"""

from __future__ import annotations

import functools
import time
from collections import deque
from collections.abc import Iterable, Iterator

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.chain import tile_chain
from ..ops.cuda_kernel import (
    BLOCK_BX, CHROMA_BLOCK_BX, deblock_packed_cuda, packed_fits, packed_limit,
)
from ..ops.deblock import deblock_frame
from ..ops.tables import (
    HALF_BLOCK, SAMPLE_BLOCK_SIZE, chroma_height, chroma_width, get_beta, get_tc,
)
from ..utils.bs import BoundaryStrength, segment_bs_maps_device
from ..utils.graphs import CapturedStep, GraphCache, graphed, tensor_key
from ..utils.tracing import profiled_device_us
from ..utils.yuv import FramePlanes, check_dims

# _deblock_yv12_packed_n's graphs by operands and n; a 1080p step's pool
# holds about 6.3 MB of tile-planes
_GRAPHS = GraphCache(maxsize=8)


def _pack_out(buf, parts_at, inplace: bool):
    """Write the filtered (row-offset, segment) pieces into the packed
    buffer (.., rows, w).  inplace=True writes into `buf` itself (a buffer
    the caller owns); unwritten rows (e.g. chroma under luma_only) keep
    their input bytes, like the reference's in-place plane filtering
    (cpu.h:146-447).  inplace=False writes into a copy and leaves `buf`
    untouched."""
    out = buf if inplace else buf.clone()
    for off, p in parts_at:
        out[..., off : off + p.shape[-2], :].copy_(p)
    return out


def _deblock_planes_impl(y, uv, lm, cm, beta, tc, w, h, luma_only, backend,
                         luma_block=BLOCK_BX, chroma_block=CHROMA_BLOCK_BX, out=None,
                         bit_depth=8, chroma_format="4:2:0"):
    """PLANES contract: y (.., h, w) + uv (.., 2, h/2, w/2) uint8 -> (filtered
    y, filtered uv), same shapes, new tensors (uv itself under luma_only).
    At most one leading frame axis: a batch of frames shares one BS map.

    backend "cuda": K2, one launch for luma, U and V (deblock_packed_cuda),
    where its guard (packed_fits) holds for the planes and destinations;
    elsewhere the chain (ops/chain.tile_chain, pad 4): luma through T2, K1
    and T3, U and V as one tensor through T2, K1c and T3.
    out: optional (y, uv) destinations the cuda backend writes into (any
    strides, last axis contiguous; y and uv themselves for in place),
    returned in place of new tensors.
    backend "torch": the plain version on zero-extended planes.
    luma_block/chroma_block: K1's and K1c's tiles per block, so the chain's
    only; K2's are a constant of its design (ops/cuda_kernel.PACKED_TILES).
    bit_depth=10: int16 planes of Main 10 samples, beta and tc the tables'
    (scaled by the filter); the cuda backend runs K2-10 where packed_fits
    holds and raises ValueError where it does not (there is no 10-bit
    chain).  chroma_format="4:2:2": uv (.., 2, h, w/2), and "4:4:4": uv
    (.., 2, h, w), filtered the same way, by K2 or K2-10 alone on the cuda
    backend (there is no 4:2:2 or 4:4:4 chain either)."""
    p = HALF_BLOCK
    cw, ch = chroma_width(w, chroma_format), chroma_height(h, chroma_format)
    pads = (p, p, p, p)
    if backend == "cuda":
        if packed_fits(w, y, uv, *(out or ()), bit_depth=bit_depth,
                       chroma_format=chroma_format):
            return deblock_packed_cuda(y, uv, lm, cm, beta, tc, luma_only=luma_only, out=out,
                                       bit_depth=bit_depth, chroma_format=chroma_format)
        limit = packed_limit(w, bit_depth, chroma_format)
        if bit_depth != 8:
            raise ValueError(f"no {bit_depth}-bit chain: {limit}")
        if chroma_format != "4:2:0":
            raise ValueError(f"no {chroma_format} chain: {limit}")
        y_dst, uv_dst = out or (None, None)
        (y_int,) = tile_chain([y], lm, beta, tc, pad=p, chroma=False, out=[y_dst],
                              block_bx=luma_block)
        if luma_only:
            return y_int, uv
        return y_int, *tile_chain([uv], cm, beta, tc, pad=p, chroma=True, out=[uv_dst],
                                  block_bx=chroma_block)
    ye, ue, ve = deblock_frame(F.pad(y, pads), F.pad(uv[..., 0, :, :], pads),
                               F.pad(uv[..., 1, :, :], pads), lm, cm, beta, tc,
                               luma_only=luma_only, bit_depth=bit_depth)
    y_int = ye[..., p : p + h, p : p + w]
    if luma_only:
        return y_int, uv
    return y_int, torch.stack([ue[..., p : p + ch, p : p + cw], ve[..., p : p + ch, p : p + cw]],
                              dim=-3)


def _deblock_yv12_packed_impl(buf, lm, cm, beta, tc, w, h, luma_only, backend,
                              luma_block=BLOCK_BX, chroma_block=CHROMA_BLOCK_BX,
                              inplace=False, bit_depth=8, chroma_format="4:2:0"):
    """Packed YV12 uint8 (.., 3h/2, w) -> filtered packed YV12; a leading
    axis is a batch of frames (the multi-stream step, parallel/mesh.py),
    which the cuda backend runs through the same launches as one frame.
    bit_depth=10: an int16 buffer of Main 10 samples (_deblock_planes_impl);
    chroma_format="4:2:2": a (.., 2h, w) buffer of 4:2:2 frames, and
    "4:4:4" a (.., 3h, w) buffer of 4:4:4 frames; each, on the CPU, takes
    backend "torch"'s plain version at every width.

    Luma is the leading h rows; the chroma rows are U then V, viewed as
    (2, ch, cw): (h/2, w/2) at 4:2:0, (h, w/2) at 4:2:2, (h, w) at 4:4:4.
    The filter is the planes contract; inplace=True writes
    the result back into `buf` and returns it, inplace=False returns a new
    buffer and leaves `buf` untouched.  The cuda backend's T3 writes the
    filtered planes straight into the destination buffer; rows it does not
    filter (chroma under luma_only) keep their input bytes."""
    lead = tuple(buf.shape[:-2])
    ch, cw = chroma_height(h, chroma_format), chroma_width(w, chroma_format)

    def planes(b):  # (y, uv) views of a packed buffer
        return b[..., :h, :], b[..., h:, :].view(*lead, 2, ch, cw)

    if (backend == "cuda" and (bit_depth != 8 or chroma_format != "4:2:0")
            and buf.device.type == "cpu"):
        backend = "torch"  # no 10-bit, 4:2:2 or 4:4:4 chain to model on the CPU
    if backend == "cuda":
        dst = buf if inplace else torch.empty_like(buf)
        if luma_only and not inplace:
            dst[..., h:, :].copy_(buf[..., h:, :])
        src = planes(buf)
        _deblock_planes_impl(*src, lm, cm, beta, tc, w, h, luma_only, backend, luma_block,
                             chroma_block, out=src if inplace else planes(dst),
                             bit_depth=bit_depth, chroma_format=chroma_format)
        return dst
    y_int, uv_int = _deblock_planes_impl(*planes(buf), lm, cm, beta, tc, w, h, luma_only,
                                         backend, luma_block, chroma_block,
                                         bit_depth=bit_depth, chroma_format=chroma_format)
    parts = [(0, y_int)]
    if not luma_only:
        parts.append((h, uv_int.reshape(*lead, -1, w)))
    return _pack_out(buf, parts, inplace)


def _packed_steps(n, beta, tc, w, h, luma_only, backend, luma_block, chroma_block,
                  bit_depth=8, chroma_format="4:2:0"):
    """fn(buf, *lm, *cm): n in-place packed steps on buf (returns None)."""
    def steps(buf, *maps):
        for _ in range(n):
            _deblock_yv12_packed_impl(buf, maps[:4], maps[4:], beta, tc, w, h, luma_only,
                                      backend, luma_block, chroma_block, inplace=True,
                                      bit_depth=bit_depth, chroma_format=chroma_format)
    return steps


def _deblock_yv12_packed_n(buf, lm, cm, beta, tc, n, w, h, luma_only, backend,
                           luma_block=BLOCK_BX, chroma_block=CHROMA_BLOCK_BX):
    """n chained packed YV12 steps on `buf` (3h/2, w), IN PLACE; returns buf.

    With the cuda backend on a CUDA device this is ONE replay of a CUDA
    graph of the n steps (the counterpart of the JAX package's single
    dispatch of a fori_loop), captured at the first call on these operands
    and kept in a bounded cache by their addresses, shapes and n; evicting
    a graph frees its pool.  Elsewhere it is the loop of n eager steps."""
    if n <= 0:
        return buf
    args = (n, beta, tc, w, h, luma_only, backend, luma_block, chroma_block)
    if not graphed(backend, buf.device):
        _packed_steps(*args)(buf, *lm, *cm)
        return buf
    key = (tensor_key(buf, *lm, *cm), *args)
    _GRAPHS.get(key, lambda: CapturedStep(_packed_steps(*args), (buf, *lm, *cm))).replay()
    return buf


class _Ring:
    """A fixed device ring of depth + 1 slots, each a pinned input buffer, a
    device buffer of `shape` whose step is captured once (its graph; with
    graph=False the step runs eagerly) and a pinned output buffer: run()'s
    ring of (3h/2, w) frames, and a multi-stream slot's ring of (k, 3h/2,
    w) frame batches (parallel/multistream.py).

    step(buf, *operands) works on a device buffer in place.  A frame goes
    host -> pinned input (claim(): the host waits until the slot's last H2D
    is done), H2D on the copy stream once the slot's last reader is done,
    the step on the compute stream after the H2D's event, and D2H on a
    third stream after the step's event (launch()).  The slot graphs share
    one memory pool: they replay one at a time on the compute stream and
    write only their slot."""

    def __init__(self, shape, depth: int, device, step, operands, graph: bool):
        k = depth + 1
        self.h2d = torch.cuda.Stream(device)
        self.d2h = torch.cuda.Stream(device)
        pinned = [torch.empty(shape, dtype=torch.uint8, pin_memory=True) for _ in range(2 * k)]
        self.host_in, self.host_out = pinned[:k], pinned[k:]
        self.host_in_np = [t.numpy() for t in self.host_in]
        self.dev = [torch.empty(shape, dtype=torch.uint8, device=device) for _ in range(k)]
        self.loaded, self.stepped, self.released = (
            [torch.cuda.Event() for _ in range(k)] for _ in range(3))
        self.last = None  # the event of the last step enqueued
        self.next = 0
        if graph:
            self.steps, pool = [], None
            for buf in self.dev:
                g = CapturedStep(step, (buf, *operands), pool=pool)
                pool = g.pool()
                self.steps.append(g.replay)
        else:
            self.steps = [functools.partial(step, buf, *operands) for buf in self.dev]

    def claim(self) -> tuple[int, np.ndarray]:
        """The next slot and its pinned input as a host array, once the
        slot's last H2D has read it."""
        i = self.next
        self.next = (i + 1) % len(self.dev)
        self.loaded[i].synchronize()
        return i, self.host_in_np[i]

    def launch(self, i: int, compute, readback: bool) -> int:
        """Enqueue slot i's H2D, step and (readback=True) D2H; returns i."""
        self.h2d.wait_event(self.released[i])
        with torch.cuda.stream(self.h2d):
            self.dev[i].copy_(self.host_in[i], non_blocking=True)
        self.loaded[i].record(self.h2d)
        compute.wait_event(self.loaded[i])
        with torch.cuda.stream(compute):
            self.steps[i]()
        self.stepped[i].record(compute)
        self.last = self.stepped[i]
        if readback:
            self.d2h.wait_event(self.stepped[i])
            with torch.cuda.stream(self.d2h):
                self.host_out[i].copy_(self.dev[i], non_blocking=True)
            self.released[i].record(self.d2h)
        else:
            self.released[i].record(compute)
        return i

    def submit(self, rows: np.ndarray, compute, readback: bool) -> int:
        """Enqueue one host buffer of the slots' shape; returns its slot."""
        i, host = self.claim()
        host[...] = rows
        return self.launch(i, compute, readback)

    def take(self, i: int) -> np.ndarray:
        """Slot i's read-back buffer as a fresh host array of its shape."""
        self.released[i].synchronize()
        return self.host_out[i].numpy().copy()


class StreamingDeblocker:
    """Deblocks a stream of same-geometry raw YV12 frames with copy/compute
    overlap.  Frames are 1-D uint8 arrays of size 3*w*h/2 (or bytes).

    depth: frames in flight (2 = classic double buffering).
    backend: "cuda" (the hand-written kernels: K2, or T2, K1/K1c and T3
    where K2's guard does not take the geometry) or "torch" (the plain
    version).
    device: the torch device that holds frames and runs the filter; a CUDA
    device must exist (nothing falls back to the CPU).  On a CPU device the
    "cuda" backend's wrapper runs the plain version, and _step, _chain and
    run are loops of eager steps; on a CUDA device the cuda backend's steps
    are CUDA graph replays.
    luma_block/chroma_block: tiles per block of K1 and K1c (the kernel runs
    four threads per tile), so of the chain alone; K2's are a constant of
    its design (ops/cuda_kernel.PACKED_TILES).
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
        self._run_ring: _Ring | None = None  # run()'s device ring, built at first use
        self._lm = self._cm = None
        self.update_boundary_strength(bs or BoundaryStrength.intra_default(width, height))

    def update_boundary_strength(self, bs: BoundaryStrength) -> None:
        """Install new BS arrays mid-stream (the streaming equivalent of the
        reference's SetBoundaryStrenght, cpu.h:120-132).  The segment gate
        maps are derived on the device (utils.bs.segment_bs_maps_device);
        chroma gates with the luma tile counts (quirk Q2).  After the first
        install the maps are rewritten IN PLACE on the current stream, so
        captured graphs read the new maps at the same addresses and steps
        queued before the call still read the old ones."""
        if (bs.width, bs.height) != (self.width, self.height):
            raise ValueError("BoundaryStrength geometry mismatch")
        b = SAMPLE_BLOCK_SIZE
        w, h = self.width, self.height
        ny, nx = h // b + 1, w // b + 1
        cny, cnx = (h // 2) // b + 1, (w // 2) // b + 1
        lm = segment_bs_maps_device(bs.vert, bs.hor, w, ny, nx, ny, nx, device=self.device)
        cm = segment_bs_maps_device(bs.chroma_vert, bs.chroma_hor, w // 2,
                                    cny, cnx, ny, nx, device=self.device)
        if self._lm is None:
            self._lm, self._cm = tuple(lm), tuple(cm)
            return
        for dst, src in zip(self._lm + self._cm, lm + cm):
            dst.copy_(src)

    def _packed(self, dev_buf, inplace: bool):
        return _deblock_yv12_packed_impl(
            dev_buf, self._lm, self._cm, self._beta, self._tc, self.width, self.height,
            self._luma_only, self._backend, self._luma_block, self._chroma_block,
            inplace=inplace)

    def _steps_fn(self, n: int):
        """fn(buf, *lm, *cm): this deblocker's n in-place packed steps."""
        return _packed_steps(n, self._beta, self._tc, self.width, self.height, self._luma_only,
                             self._backend, self._luma_block, self._chroma_block)

    def _step(self, dev_buf):
        """One packed deblock step, IN PLACE: the filtered frame is written
        back into dev_buf (a (3h/2, w) uint8 device buffer the caller hands
        over, such as a fresh _put), which is returned.  On a CUDA device
        with the cuda backend it is one replay of the step's graph for that
        buffer (_chain with n = 1)."""
        return self._chain(dev_buf, 1)

    def _chain(self, dev_buf, n: int):
        """n chained packed steps in one dispatch (_deblock_yv12_packed_n),
        IN PLACE like _step: the result is dev_buf itself.  The JAX _chain's
        outer jit does not donate, so there the input stays alive beside a
        new result; here a caller that needs the input keeps a clone."""
        return _deblock_yv12_packed_n(
            dev_buf, self._lm, self._cm, self._beta, self._tc, int(n), self.width,
            self.height, self._luma_only, self._backend, self._luma_block, self._chroma_block)

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

    def _device_ring(self) -> tuple[_Ring, torch.cuda.Stream]:
        """run()'s device ring (built and its graphs captured at first use)
        and the compute stream, ordered after the ring's last step."""
        if self._run_ring is None:
            self._run_ring = _Ring((self._rows, self.width), self.depth, self.device,
                                   self._steps_fn(1), (*self._lm, *self._cm),
                                   graphed(self._backend, self.device))
        compute = torch.cuda.current_stream(self.device)
        if self._run_ring.last is not None:  # an earlier run on another stream
            compute.wait_event(self._run_ring.last)
        return self._run_ring, compute

    def run(self, frames: Iterable) -> Iterator[np.ndarray]:
        """Yield filtered packed YV12 frames (np.uint8, flat), in order;
        up to `depth` frames are in flight before the oldest is read back,
        and every yielded array is a fresh host copy.  On a CUDA device the
        frames go through the fixed ring of depth + 1 device slots (_Ring):
        H2D(i+1), the step of frame i (one graph replay) and D2H(i-depth)
        overlap.  On the CPU each frame is _put, stepped and fetched."""
        if self.device.type == "cpu":
            def submit(f):
                return self._step(self._put(f))
            take = self._fetch
        else:
            ring, compute = self._device_ring()

            def submit(f):
                rows = self._host_frame(f).reshape(self._rows, self.width)
                return ring.submit(rows, compute, True)

            def take(i):
                return ring.take(i).reshape(-1)
        inflight: deque = deque()
        for frame in frames:
            inflight.append(submit(frame))
            if len(inflight) >= self.depth:
                yield take(inflight.popleft())
        while inflight:
            yield take(inflight.popleft())

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

    def _stream_s(self, fn, n: int, stream: str) -> float:
        """Best of 3: seconds per call of fn over n calls, from CUDA events
        on the "copy" or "compute" (current) stream."""
        s = (self._copy_stream if stream == "copy"
             else torch.cuda.current_stream(self.device))
        best = float("inf")
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(s)
            for _ in range(n):
                fn()
            end.record(s)
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3 / n)
        return best

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def time_breakdown(self, frame, n: int = 30, measure_d2h: bool = False) -> dict:
        """Per-frame split, best of 3 runs of n (the reference's 'with
        copy'/'without copy' table, gpu.cu:1292-1303):

        h2d_s: copy-stream time per _put (CUDA events; includes waiting for
               the host to stage the frame into pinned memory);
        kernel_s: compute-stream time per packed _step, chained in place on
               one buffer (CUDA events; when the host enqueues slower than
               the device runs, this is the enqueue rate);
        dispatch_s: host wall time per _step call (one graph replay);
        device_split_us: device µs per _step by category (deblock_kernels,
               layout_and_copies, other), from the profiler's device lanes
               (utils.tracing.profiled_device_us); absent where the trace
               has none;
        e2e_sync_s (measure_d2h=True): host wall time of a synchronous
               put -> step -> read back of one frame, after one untimed
               such frame (a fresh buffer's step graph is captured at its
               first step; the timed ones reuse its memory and graph)."""
        self._require_cuda("time_breakdown")
        arr = self._host_frame(frame)
        buf = self._step(self._put(arr))  # warm-up: builds the kernels, captures the graph
        self._sync()
        h2d = self._stream_s(lambda: self._put(arr), n, "copy")
        kernel = self._stream_s(lambda: self._step(buf), n, "compute")
        t0 = time.perf_counter()
        for _ in range(n):
            self._step(buf)
        dispatch = (time.perf_counter() - t0) / n
        self._sync()
        res = {"h2d_s": h2d, "kernel_s": kernel, "dispatch_s": dispatch}
        prof = profiled_device_us(lambda: self._step(buf), iters=n)
        if prof is not None:
            res["device_split_us"] = {k: round(prof[1].get(k, 0.0), 2)
                                      for k in ("deblock_kernels", "layout_and_copies", "other")}
        if measure_d2h:
            reps = max(1, n // 10)
            self._fetch(self._step(self._put(arr)))
            t0 = time.perf_counter()
            for _ in range(reps):
                self._fetch(self._step(self._put(arr)))
            res["e2e_sync_s"] = (time.perf_counter() - t0) / reps
        return res
