"""Device-resident, layout-persistent streaming: tile-planes end to end.

Counterpart of gpu_video_codec_tpu/models/resident.py.  A frame that stays
on the device between stages (a codec loop, a filter chain) pays the
layout cost once, at the pipeline's boundaries:

  ingest(raw)    one host-to-device copy + T2 (plane -> tile-planes) for
                 luma and one T2 for U and V together
  step(state)    the deblock kernels K1 and K1c and nothing else;
                 run_steps(state, n) chains n of them as one CUDA graph
                 replay on a CUDA device (a loop on the CPU)
  readback(st)   T3 (tile-planes -> planes) for luma and for U+V, T4 (pack
                 into one YV12 buffer), one device-to-host copy

T2, T3, T4 and K1/K1c come from ops/chain.KERNELS by backend.  The
tile grid is the exact (By, Bx) of the covered tiles: the kernels guard
their own tails, so the JAX package's padding of the grid to Pallas block
multiples has no counterpart here.  A leading batch axis on the state runs
a frame batch through every kernel as one launch, with one shared BS map.

Quirk handling is that of every other path: chroma sweeps the flat
(8*ncby, 8*ncbx) view (Q9, utils/tiles.split_covered_data), with the
uncovered flat remainder carried through the state untouched; on sheared
geometries T2 and T3 address that view and remainder themselves
(ops/relayout_kernel.py, flat=True).
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple

import numpy as np
import torch

from ..ops.chain import KERNELS
from ..ops.cuda_kernel import BLOCK_BX, CHROMA_BLOCK_BX
from ..ops.relayout_kernel import flat_view
from ..ops.tables import HALF_BLOCK, SAMPLE_BLOCK_SIZE as _B, get_beta, get_tc
from ..utils.bs import BoundaryStrength, segment_bs_maps_device
from ..utils.graphs import CapturedStep, GraphCache, graphed, tensor_key
from ..utils.yuv import check_dims

# _step_n's graphs by state, maps and n
_GRAPHS = GraphCache(maxsize=8)


class StepOperands(NamedTuple):
    """The operands a ResidentDeblocker's step consumes, for wrappers that
    re-place them (e.g. on another device) through install_operands().  The
    JAX package's yperm_*/cperm_* one-hot relayout operands belong to the
    TPU's relayout engines and have no counterpart here."""

    lm: tuple   # 4 luma segment BS maps, (By, Bx) uint8
    cm: tuple   # 4 chroma maps, U over V stacked, (2cBy, cBx) uint8
    beta: int   # QP-derived thresholds (ops/tables.py)
    tc: int


class TileFrame(NamedTuple):
    """Device-resident frame state.

    y:  (.., 8, 8, By, Bx) uint8 luma tile-planes.
    uv: (.., 8, 8, 2*cBy, cBx) uint8: the U and V covered-core tile grids
        stacked along By (one chroma launch per step).
    u_rem / v_rem: (.., n) flat uncovered remainder of the extended chroma
        planes (quirk Q9), never touched by the filter, carried for exact
        readback; zero-size on non-sheared geometries, where the remainder
        is bottom padding that readback does not need.
    """

    y: torch.Tensor
    uv: torch.Tensor
    u_rem: torch.Tensor
    v_rem: torch.Tensor


def _sheared(w: int) -> bool:
    """Q9: the extended chroma width is not 8-aligned (w % 16 == 8)."""
    return (w // 2 + 2 * HALF_BLOCK) % _B != 0


def _ingest(buf, w: int, h: int, backend: str = "cuda") -> TileFrame:
    """Packed YV12 uint8 (.., 3wh/2) on the device -> TileFrame.

    Luma goes interior -> tile-planes in one T2 launch (the Q6 zero padding
    is the kernel's).  U and V go through one more T2 launch, written as
    (.., 8, 8, 2, cBy, cBx) -- the U-over-V stack K1c takes.  On sheared
    geometries (Q9) that launch tiles the flat view of the padded planes
    (flat=True) and copies their flat tails out into the state's
    remainders, straight from the packed buffer."""
    t2 = KERNELS[backend][0]
    p = HALF_BLOCK
    cw, ch = w // 2, h // 2
    lead = tuple(buf.shape[:-1])
    n = len(lead)
    y = t2(buf[..., : w * h].reshape(*lead, h, w), p)
    uv_int = buf[..., w * h :].reshape(*lead, 2, ch, cw)
    vh, vw, tail = flat_view(ch, cw, p)
    flat = _sheared(w)
    rem = buf.new_empty((*lead, 2, tail if flat else 0))
    cby, cbx = vh // _B, vw // _B
    uv = torch.empty((*lead, _B, _B, 2, cby, cbx), dtype=torch.uint8, device=buf.device)
    # U and V land as (8, 8, 2, cBy, cBx)
    t2(uv_int, p, out=uv.movedim(n + 2, n), flat=flat, rem_out=rem if flat else None)
    return TileFrame(y, uv.reshape(*lead, _B, _B, 2 * cby, cbx), rem[..., 0, :], rem[..., 1, :])


def _rem_pair(tf: TileFrame):
    """The (.., 2, n) view of the state's U and V remainders, which _ingest
    makes as the two rows of one buffer (no copy)."""
    u, v = tf.u_rem, tf.v_rem
    step = v.data_ptr() - u.data_ptr()
    if (u.shape != v.shape or u.stride() != v.stride() or step < u.shape[-1]
            or u.untyped_storage().data_ptr() != v.untyped_storage().data_ptr()):
        raise ValueError("u_rem and v_rem must be two rows of one buffer, as ingest makes them")
    return torch.as_strided(u, (*u.shape[:-1], 2, u.shape[-1]), (*u.stride()[:-1], step, 1))


def _readback(tf: TileFrame, w: int, h: int, backend: str = "cuda"):
    """TileFrame -> filtered packed YV12 uint8 (.., 3wh/2) on the device:
    T3 for luma, T3 for U and V together (on sheared geometries from the
    flat view, the flat tails from the state's remainders), T4 to pack."""
    _, t3, t4, _ = KERNELS[backend]
    p = HALF_BLOCK
    cw, ch = w // 2, h // 2
    lead = tuple(tf.y.shape[:-4])
    n = len(lead)
    y_int = t3(tf.y, p, h, w)
    cby, cbx = tf.uv.shape[-2] // 2, tf.uv.shape[-1]
    uv_t = tf.uv.reshape(*lead, _B, _B, 2, cby, cbx).movedim(n + 2, n)
    if _sheared(w):
        uv_int = t3(uv_t, p, ch, cw, flat=True, rem=_rem_pair(tf))
    else:
        uv_int = t3(uv_t, p, ch, cw)
    return t4(y_int.reshape(*lead, h * w), uv_int[..., 0, :, :].reshape(*lead, ch * cw),
              uv_int[..., 1, :, :].reshape(*lead, ch * cw))


def _step_core(tf: TileFrame, lm, cm, beta, tc, luma_only: bool, backend: str = "cuda",
               luma_block: int = BLOCK_BX, chroma_block: int = CHROMA_BLOCK_BX) -> TileFrame:
    """The steady state: the deblock kernels only, no layout work.  A
    batched TileFrame shares one BS map across its frames."""
    deblock = KERNELS[backend][3]
    if tf.y.dim() == 5:
        lm = tuple(m[None] for m in lm)
        cm = tuple(m[None] for m in cm)
    y = deblock(tf.y, *lm, beta, tc, chroma=False, block_bx=luma_block)
    if luma_only:
        return TileFrame(y, tf.uv, tf.u_rem, tf.v_rem)
    uv = deblock(tf.uv, *cm, beta, tc, chroma=True, block_bx=chroma_block)
    return TileFrame(y, uv, tf.u_rem, tf.v_rem)


def _core_steps(n, beta, tc, luma_only, backend, lb, cb):
    """fn(y, uv, u_rem, v_rem, *lm, *cm): n chained _step_core steps."""
    def steps(y, uv, u_rem, v_rem, *maps):
        tf = TileFrame(y, uv, u_rem, v_rem)
        for _ in range(n):
            tf = _step_core(tf, maps[:4], maps[4:], beta, tc, luma_only, backend, lb, cb)
        return tf
    return steps


def _step_n(tf: TileFrame, lm, cm, beta, tc, n, luma_only, backend="cuda",
            lb=BLOCK_BX, cb=CHROMA_BLOCK_BX) -> TileFrame:
    """n chained resident steps; returns a new TileFrame and leaves tf as it
    was.

    With the cuda backend on a CUDA device this is ONE replay of a CUDA
    graph of the n steps (the counterpart of the JAX package's single
    dispatch of a fori_loop), captured at the first call on this state and
    kept in a bounded cache by the state's and maps' addresses, shapes and
    n.  The planes the steps write live in the graph's pool, which its next
    replay overwrites, so the result gets memory of its own (a clone of
    each; planes passed through -- chroma under luma_only, the remainders
    -- are tf's, as in an eager step).  Elsewhere: the loop of eager
    steps."""
    if n <= 0:
        return tf
    args = (n, beta, tc, luma_only, backend, lb, cb)
    steps = _core_steps(*args)
    if not graphed(backend, tf.y.device):
        return steps(*tf, *lm, *cm)

    def written(*operands):  # the pool's planes only: the graph keeps what this returns
        out = steps(*operands)
        return out.y, None if luma_only else out.uv

    key = (tensor_key(*tf, *lm, *cm), *args)
    y, uv = _GRAPHS.get(key, lambda: CapturedStep(written, (*tf, *lm, *cm))).replay()
    return TileFrame(y.clone(), tf.uv if uv is None else uv.clone(), tf.u_rem, tf.v_rem)


class ResidentDeblocker:
    """Deblocks frames that live on the device in tile-planes layout.

    Usage (device-resident pipeline):
        rd = ResidentDeblocker(w, h, qp)
        state = rd.ingest(raw_yv12)      # boundary: host -> canonical layout
        state = rd.step(state)           # kernels only; chain freely
        out = rd.readback(state)         # boundary: canonical layout -> host

    rd(raw) == readback(step(ingest(raw))), byte-identical to
    StreamingDeblocker on the same frame.

    backend: "cuda" (the hand-written kernels) or "torch" (their plain
    versions).  device: the torch device that holds the state; a CUDA
    device must exist (nothing falls back to the CPU).  On a CPU device the
    "cuda" backend's wrappers run the plain versions.
    luma_block/chroma_block: tiles per block of K1 and K1c (the kernel runs
    four threads per tile).
    """

    def __init__(self, width: int, height: int, qp: int, *,
                 luma_only: bool = False, bs: BoundaryStrength | None = None,
                 backend: str = "cuda", luma_block: int = BLOCK_BX,
                 chroma_block: int = CHROMA_BLOCK_BX, device="cuda"):
        if backend not in KERNELS:
            raise ValueError(f"resident backend must be 'cuda' or 'torch', got {backend!r}")
        check_dims(width, height)  # reference contract (cpu.h:46-48)
        self.device = torch.device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"device must be a CUDA or CPU device, got {self.device}")
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"device {self.device} requested but CUDA is not available")
            if self.device.index is None:  # tensors report their index: compare like with like
                self.device = torch.device("cuda", torch.cuda.current_device())
        self.width, self.height, self.qp = width, height, int(qp)
        self.frame_bytes = 3 * width * height // 2
        self._luma_only = luma_only
        self._backend = backend
        self._beta = get_beta(qp)
        self._tc = get_tc(qp)
        self._lb, self._cb = int(luma_block), int(chroma_block)
        self._lm = self._cm = None
        self.update_boundary_strength(bs or BoundaryStrength.intra_default(width, height))

    def update_boundary_strength(self, bs: BoundaryStrength) -> None:
        """Swap in new BS arrays (the SetBoundaryStrenght story,
        cpu.h:120-132); the segment gate maps are built on the device
        (utils.bs.segment_bs_maps_device), chroma stacked U over V.  After
        the first install the maps are rewritten IN PLACE on the current
        stream, so captured graphs read the new maps and steps queued before
        the call still read the old ones."""
        if (bs.width, bs.height) != (self.width, self.height):
            raise ValueError("BoundaryStrength geometry mismatch")
        w, h = self.width, self.height
        ny, nx = h // _B + 1, w // _B + 1
        cny, cnx = (h // 2) // _B + 1, (w // 2) // _B + 1
        lm = segment_bs_maps_device(bs.vert, bs.hor, w, ny, nx, ny, nx, device=self.device)
        cm = segment_bs_maps_device(bs.chroma_vert, bs.chroma_hor, w // 2, cny, cnx, ny, nx,
                                    device=self.device)
        if self._lm is None:
            self._lm = tuple(lm)
            self._cm = tuple(torch.cat([m, m], dim=0) for m in cm)
            return
        for dst, src in zip(self._lm, lm):
            dst.copy_(src)
        for dst, src in zip(self._cm, cm):
            torch.cat([src, src], dim=0, out=dst)

    # -- public operand/shape contract ----------------------------------------

    @property
    def operands(self) -> StepOperands:
        """The step's operands as one tuple: copies of the maps, which
        update_boundary_strength rewrites in place."""
        return StepOperands(tuple(m.clone() for m in self._lm),
                            tuple(m.clone() for m in self._cm), self._beta, self._tc)

    def install_operands(self, ops: StepOperands) -> None:
        """Replace the step's operands (e.g. with copies placed elsewhere).
        Shapes and dtypes must match what `operands` returned.  The deblocker
        then owns the maps: update_boundary_strength rewrites them in place."""
        self._lm, self._cm, self._beta, self._tc = ops

    @property
    def block_shapes(self) -> tuple[int, int]:
        """CUDA threads per block of the (luma, chroma) deblock launches."""
        return self._lb, self._cb

    @property
    def luma_only(self) -> bool:
        return self._luma_only

    # -- pipeline boundaries --------------------------------------------------

    def _batch_shape(self, shape) -> tuple:
        """The (frame_bytes,) or (n, frame_bytes) shape of a frame or frame
        batch of `shape`, recognized STRUCTURALLY: the trailing dims after a
        leading batch axis multiply to frame_bytes (so (n, 3wh/2),
        (n, 3h/2, w) and a batch of ONE keep their batch axis), or a 2-D
        row stack (n*3h/2, w) whose row width is the frame width.  Anything
        else whose size merely divides by frame_bytes (e.g. a transposed
        (frame_bytes, n) array) is rejected rather than reinterpreted as
        scrambled frames."""
        shape = tuple(shape)
        size = math.prod(shape)
        if len(shape) >= 2 and math.prod(shape[1:]) == self.frame_bytes:
            return (shape[0], self.frame_bytes)  # batch (incl. n == 1)
        if size == self.frame_bytes:  # single frame in any layout
            return (self.frame_bytes,)
        if len(shape) == 2 and shape[1] == self.width and size % self.frame_bytes == 0:
            return (size // self.frame_bytes, self.frame_bytes)  # stacked frame rows
        raise ValueError(
            f"frame must be {self.frame_bytes} bytes, an (n, {self.frame_bytes}) "
            f"/ (n, {3 * self.height // 2}, {self.width}) batch, or a "
            f"(n*{3 * self.height // 2}, {self.width}) row stack; got shape {shape}")

    def host_buf(self, frame) -> np.ndarray:
        """Normalize one packed frame (bytes / any uint8 array whose total
        size is frame_bytes) or a frame batch to a validated uint8 ndarray
        of shape (frame_bytes,) or (n, frame_bytes) (_batch_shape)."""
        arr = (np.frombuffer(frame, np.uint8) if isinstance(frame, (bytes, bytearray))
               else np.asarray(frame, np.uint8))
        return arr.reshape(self._batch_shape(arr.shape))

    def _device_buf(self, frame) -> torch.Tensor:
        """Frame(s) -> packed (frame_bytes,) or (n, frame_bytes) uint8 on the
        device (see ingest)."""
        if isinstance(frame, torch.Tensor):
            if frame.dtype != torch.uint8 or frame.device != self.device:
                raise ValueError(f"a tensor frame must be uint8 on {self.device}, got "
                                 f"{frame.dtype} on {frame.device}")
            return frame.reshape(self._batch_shape(frame.shape))
        if isinstance(frame, (list, tuple)):
            arr = np.stack([self.host_buf(f) for f in frame])
        else:
            arr = self.host_buf(frame)
        if not (arr.flags.writeable and arr.flags.c_contiguous):
            arr = np.array(arr)
        return torch.from_numpy(arr).to(self.device)

    def ingest(self, frame) -> TileFrame:
        """Frame(s) -> device TileFrame.  Accepts one packed frame (bytes /
        uint8 buffer), a BATCH of frames (list/tuple of frames, or an
        (n, 3wh/2)-shaped array -- the batch runs through the kernels as one
        launch each), or a packed uint8 tensor already on this deblocker's
        device (no host-to-device copy)."""
        return _ingest(self._device_buf(frame), self.width, self.height, self._backend)

    def step(self, tf: TileFrame) -> TileFrame:
        """Kernel-only deblock of a resident frame (the steady state)."""
        return _step_core(tf, self._lm, self._cm, self._beta, self._tc, self._luma_only,
                          self._backend, self._lb, self._cb)

    def run_steps(self, tf: TileFrame, n: int) -> TileFrame:
        """n chained deblock steps (identical to calling step() n times):
        one CUDA graph replay with the cuda backend on a CUDA device, a loop
        elsewhere (_step_n).  tf stays as it was, and the result is not
        overwritten by a later call."""
        return _step_n(tf, self._lm, self._cm, self._beta, self._tc, int(n), self._luma_only,
                       self._backend, self._lb, self._cb)

    def readback(self, tf: TileFrame) -> np.ndarray:
        """Device TileFrame -> filtered packed YV12 on the host."""
        return _readback(tf, self.width, self.height, self._backend).cpu().numpy()

    def __call__(self, frame) -> np.ndarray:
        return self.readback(self.step(self.ingest(frame)))

    # -- measurement (CUDA devices only) -------------------------------------

    def step_time(self, frame, iters: int = 100, repeats: int = 3) -> dict:
        """Steady-state device times of the resident path, in µs per call,
        from CUDA events around calls queued behind a spin kernel
        (utils.timing.device_ms; best of `repeats`):

        step_us -- one step (K1 + K1c) on the resident state;
        ingest_us -- ingest of a packed frame (batch) already on the device
            (the T2 launches, no host-to-device copy);
        readback_us -- the device part of readback (T3 + T4, no copy to
            the host);
        copy_out_us -- the device time run_steps spends giving its result
            memory of its own (the clones out of the graph's pool);
        queued_ahead -- whether the host queued every timed run before the
            spin ended (if not, host gaps are in the times).

        dispatch_us -- host wall time per individually dispatched chained
            step, synchronized at the end;
        dispatch_n_us -- host wall time per step of run_steps(tf, iters)
            (one graph replay), synchronized at the end."""
        from ..utils.timing import device_ms

        if self.device.type != "cuda":
            raise RuntimeError(f"step_time times the CUDA device; this deblocker runs on "
                               f"{self.device}")
        w, h = self.width, self.height
        buf = self._device_buf(frame)
        tf = self.step(_ingest(buf, w, h, self._backend))
        torch.cuda.synchronize(self.device)
        runs = {"step": lambda: self.step(tf),
                "ingest": lambda: _ingest(buf, w, h, self._backend),
                "readback": lambda: _readback(tf, w, h, self._backend),
                "copy_out": lambda: (tf.y.clone(), tf.uv if self._luma_only else tf.uv.clone())}
        out, ahead = {}, True
        with torch.cuda.device(self.device):
            for name, fn in runs.items():
                best = float("inf")
                for _ in range(repeats):
                    ms, ok = device_ms(fn, iters)
                    best, ahead = min(best, ms), ahead and ok
                out[f"{name}_us"] = best * 1e3
            dispatch = dispatch_n = float("inf")
            self.run_steps(tf, iters)  # captures the graph
            for _ in range(repeats):
                t = tf
                t0 = time.perf_counter()
                for _ in range(iters):
                    t = self.step(t)
                torch.cuda.synchronize(self.device)
                dispatch = min(dispatch, (time.perf_counter() - t0) / iters)
                t0 = time.perf_counter()
                self.run_steps(tf, iters)
                torch.cuda.synchronize(self.device)
                dispatch_n = min(dispatch_n, (time.perf_counter() - t0) / iters)
        frames = buf.shape[0] if buf.dim() == 2 else 1
        return {
            **out,
            "step_s": out["step_us"] / 1e6,
            "mpix_s": frames * w * h / out["step_us"],
            "dispatch_us": dispatch * 1e6,
            "dispatch_n_us": dispatch_n * 1e6,
            "queued_ahead": ahead,
            "frames": frames,
            "device": torch.cuda.get_device_name(self.device),
        }
