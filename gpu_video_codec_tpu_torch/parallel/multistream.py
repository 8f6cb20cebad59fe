"""Multi-stream deblocking over a mesh of device slots (BASELINE config 5).

Counterpart of gpu_video_codec_tpu/parallel/multistream.py.  N concurrent
YV12 streams (N cameras, N transcode jobs) are zipped into per-step
batches of N packed frames; the frames go over the mesh's slots in
contiguous chunks (parallel/mesh.packed_batch_sharding), and a slot with k
frames filters them with ONE batched packed step (one K2 launch for the k
frames, or T2 2, K1 1, K1c 1, T3 2 where K2's guard fails;
mesh.deblock_packed_batch_sharded), in place.

Per CUDA slot, the fixed device ring of the single-stream path
(models/streaming._Ring): depth + 1 entries, each a pinned (k, 3h/2, w)
input, a device buffer whose batched step is captured once as a CUDA graph
and a pinned output.  Each raw frame is copied straight into its row of
the pinned input (no host stack); H2D runs on the slot's copy stream, the
step (one replay) on the slot's own stream, D2H on a third stream.  run()
keeps `depth` batches in flight and yields a batch once every slot's
read-back of it is done, so batch i+1's copies ride under batch i's
kernels.  On a CPU slot the batched step runs eagerly on a fresh buffer.
"""

from __future__ import annotations

from collections import deque
from collections.abc import Iterable, Iterator, Sequence

import numpy as np
import torch

from .mesh import BACKENDS, Mesh, on_device, packed_batch_sharding
from ..models.streaming import _Ring, _packed_steps
from ..ops.cuda_kernel import BLOCK_BX, CHROMA_BLOCK_BX
from ..ops.tables import SAMPLE_BLOCK_SIZE as _B, get_beta, get_tc
from ..utils.bs import BoundaryStrength, segment_bs_maps_device
from ..utils.graphs import graphed
from ..utils.yuv import check_dims


class _Slot:
    """One mesh slot of a MultiStreamDeblocker: its frames [lo, hi) of each
    batch, its BS maps on its device, and (CUDA) its stream and ring."""

    def __init__(self, ms: "MultiStreamDeblocker", device, lo: int, hi: int, stream):
        self.device, self.lo, self.hi = device, lo, hi
        self.stream = stream
        self.lm = self.cm = None
        self.ring: _Ring | None = None
        self.step = _packed_steps(1, ms._beta, ms._tc, ms.width, ms.height, ms.luma_only,
                                  ms.backend, BLOCK_BX, CHROMA_BLOCK_BX)

    def install(self, bs: BoundaryStrength) -> None:
        """Build the maps on the device (chroma gated with the luma tile
        counts, Q2; models/streaming.update_boundary_strength); after the
        first install rewrite them in place on the slot's stream, so steps
        queued before keep the old maps and graphs read the new ones."""
        w, h = bs.width, bs.height
        ny, nx = h // _B + 1, w // _B + 1
        cny, cnx = (h // 2) // _B + 1, (w // 2) // _B + 1
        lm = segment_bs_maps_device(bs.vert, bs.hor, w, ny, nx, ny, nx, device=self.device)
        cm = segment_bs_maps_device(bs.chroma_vert, bs.chroma_hor, w // 2, cny, cnx, ny, nx,
                                    device=self.device)
        if self.stream is not None:  # the maps are built on the caller's stream
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        if self.lm is None:
            self.lm, self.cm = tuple(lm), tuple(cm)
            return
        if self.stream is None:
            for dst, src in zip(self.lm + self.cm, lm + cm):
                dst.copy_(src)
            return
        with torch.cuda.stream(self.stream):
            for dst, src in zip(self.lm + self.cm, lm + cm):
                dst.copy_(src)
                src.record_stream(self.stream)


class MultiStreamDeblocker:
    """Deblocks N same-geometry YV12 streams across a mesh of slots.

    mesh: a ("data", "spatial") Mesh (parallel.make_mesh).  The number of
    streams must be a multiple of the data axis.  Frames are raw packed
    YV12 buffers (bytes or uint8 arrays of 3*w*h/2).
    backend: "cuda" (the kernels; one graph replay per slot and batch on a
    CUDA slot) or "torch" (their plain versions, eager).
    depth: batches in flight during run() (2 = double buffering).
    """

    def __init__(self, mesh: Mesh, n_streams: int, width: int, height: int, qp: int,
                 *, backend: str = "cuda", luma_only: bool = False,
                 bs: BoundaryStrength | None = None, depth: int = 2):
        check_dims(width, height)
        if n_streams % mesh.shape["data"]:
            raise ValueError(
                f"n_streams {n_streams} must divide by the data axis {mesh.shape['data']}"
            )
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.mesh = mesh
        self.n = n_streams
        self.width, self.height = width, height
        self.frame_bytes = 3 * width * height // 2
        self._rows = 3 * height // 2
        self.backend = backend
        self.luma_only = luma_only
        self.depth = max(1, depth)
        self._beta, self._tc = get_beta(qp), get_tc(qp)
        self._slots = []
        for index, (lo, hi) in enumerate(packed_batch_sharding(mesh, n_streams)):
            dev = mesh.device(index)
            if lo < hi:  # a slot with no stream idles
                stream = mesh.stream(index) if dev.type == "cuda" else None
                self._slots.append(_Slot(self, dev, lo, hi, stream))
        self.update_boundary_strength(bs or BoundaryStrength.intra_default(width, height))

    def update_boundary_strength(self, bs: BoundaryStrength) -> None:
        """Install new BS arrays on every slot mid-stream (the
        SetBoundaryStrenght story, cpu.h:120-132): one map set for the
        whole mesh, rewritten in place on each slot's stream, so captured
        graphs read it and batches already queued keep the old one."""
        if (bs.width, bs.height) != (self.width, self.height):
            raise ValueError("BoundaryStrength geometry mismatch")
        for slot in self._slots:
            slot.install(bs)

    def _host_frame(self, raw) -> np.ndarray:
        arr = (np.frombuffer(raw, np.uint8) if isinstance(raw, (bytes, bytearray))
               else np.asarray(raw, np.uint8).ravel())
        if arr.size != self.frame_bytes:
            raise ValueError(f"frame must be {self.frame_bytes} bytes, got {arr.size}")
        return arr.reshape(self._rows, self.width)

    def _ring(self, slot: _Slot) -> _Ring:
        if slot.ring is None:  # built, and its graphs captured, at first use
            k = slot.hi - slot.lo
            slot.ring = _Ring((k, self._rows, self.width), self.depth, slot.device, slot.step,
                              (*slot.lm, *slot.cm), graphed(self.backend, slot.device))
        return slot.ring

    def _dispatch(self, raws: Sequence, readback: bool = True) -> list:
        """Enqueue one batch without draining: per CUDA slot, its frames
        copied into a pinned ring entry, H2D, one batched step, D2H (the
        copies in with readback=False); per CPU slot, the step itself.
        Returns one handle per slot."""
        if len(raws) != self.n:
            raise ValueError(f"expected {self.n} frames (one per stream), got {len(raws)}")
        frames = [self._host_frame(r) for r in raws]
        handles = []
        for slot in self._slots:
            mine = frames[slot.lo : slot.hi]
            if slot.stream is None:
                buf = torch.empty((len(mine), self._rows, self.width), dtype=torch.uint8)
                host = buf.numpy()
                for dst, src in zip(host, mine):
                    dst[...] = src
                slot.step(buf, *slot.lm, *slot.cm)
                handles.append(host)
                continue
            ring = self._ring(slot)
            i, host = ring.claim()
            for dst, src in zip(host, mine):
                dst[...] = src
            with on_device(slot.device):
                handles.append(ring.launch(i, slot.stream, readback))
        return handles

    def _drain(self, handles: list) -> list[np.ndarray]:
        """Wait for every slot's read-back of one batch: the filtered frames
        in stream order, flat views of one fresh host array per slot."""
        out = []
        for slot, h in zip(self._slots, handles):
            arr = h if slot.stream is None else self._ring(slot).take(h)
            out.extend(arr.reshape(len(arr), -1))
        return out

    def step(self, raws: Sequence) -> list[np.ndarray]:
        """One synchronous batch step: one frame per stream in, filtered
        packed frames out (in stream order).  For overlapped multi-batch
        throughput use run() -- step() fully drains."""
        return self._drain(self._dispatch(raws))

    def run_batches(self, batches: Iterable[Sequence]) -> Iterator[list[np.ndarray]]:
        """Overlapped core: consume an iterable of n_streams-frame batches,
        keeping `depth` batches in flight; batch i+1's host copies and H2D
        ride under batch i's kernels, and draining lags dispatch by
        depth - 1 batches."""
        inflight: deque = deque()
        for raws in batches:
            inflight.append(self._dispatch(raws))
            if len(inflight) >= self.depth:
                yield self._drain(inflight.popleft())
        while inflight:
            yield self._drain(inflight.popleft())

    def run(self, streams: Sequence[Iterable]) -> Iterator[list[np.ndarray]]:
        """Zip N frame iterables; yield one list of filtered frames (one per
        stream) per overlapped step until the shortest stream ends."""
        if len(streams) != self.n:
            raise ValueError(f"expected {self.n} streams, got {len(streams)}")
        return self.run_batches(list(raws) for raws in zip(*streams))
