"""Frame deblocking pipeline: the execution-driver layer.

Counterpart of gpu_video_codec_tpu/models/pipeline.py, which replaces the
reference's ExecuteCpu / ExecuteGpu drivers (main.cu:36-83,
gpu.cu:1230-1306) with a backend-dispatching pipeline object:

  backend="cuda"   the hand-written kernels on `device`
                   (ops/chain.deblock_frame_cuda: per frame T2, K1 and
                   T3 for luma, T2 and T3 per plane and one K1c for U and V);
                   the counterpart of the JAX "pallas"
  backend="torch"  the plain PyTorch version on `device` (ops/deblock.py);
                   the counterpart of the JAX "jnp"
  backend="golden" the scalar NumPy oracle (models/golden.py)
  backend="native" the C++ OpenMP CPU runtime (runtime/native.py), the
                   reference's ExecuteCpu path

Frames are FramePlanes of extended host planes, in and out.  The BS segment
maps are built once per (geometry, BS), as tensors on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.chain import KERNELS, deblock_frame_cuda, tile_chain
from ..ops.deblock import deblock_frame
from ..ops.tables import get_beta, get_tc
from ..utils.bs import BoundaryStrength, chroma_segment_maps, luma_segment_maps
from ..utils.yuv import FramePlanes


def _host(t) -> np.ndarray:
    """A device tensor as a host array of its own."""
    return t.cpu().numpy() if t.device.type != "cpu" else t.numpy().copy()


class DeblockPipeline:
    """Deblock frames of a fixed geometry/QP with a chosen execution backend.

    device: the torch device of the "cuda" and "torch" backends; a CUDA
    device must exist (nothing falls back to the CPU).  On a CPU device the
    "cuda" backend's wrappers run the kernels' plain versions.  The host
    backends ("golden", "native") ignore it.
    num_threads: the "native" backend's OpenMP threads (0 = the library's
    default; the reference sweeps 1/2/4/6/8, cpu.h:135)."""

    def __init__(self, width: int, height: int, qp: int,
                 luma_only: bool = False, backend: str = "cuda",
                 bs: BoundaryStrength | None = None, num_threads: int = 0,
                 device="cuda"):
        self.width = width
        self.height = height
        self.qp = int(qp)
        self.beta = get_beta(qp)
        self.tc = get_tc(qp)
        self.luma_only = luma_only
        self.backend = backend
        self.num_threads = num_threads
        self.device = torch.device(device)
        if backend in KERNELS:
            if self.device.type not in ("cuda", "cpu"):
                raise ValueError(f"device must be a CUDA or CPU device, got {self.device}")
            if self.device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(f"device {self.device} requested but CUDA is not available")
        self.set_boundary_strength(bs or BoundaryStrength.intra_default(width, height))

    def set_boundary_strength(self, bs: BoundaryStrength) -> None:
        """Install BS arrays; the device backends' per-segment (By, Bx) gate
        maps are built here, once, on the device."""
        if (bs.width, bs.height) != (self.width, self.height):
            raise ValueError("BoundaryStrength geometry mismatch")
        self.bs = bs
        if self.backend in KERNELS:
            self.luma_maps = tuple(torch.from_numpy(m).to(self.device)
                                   for m in luma_segment_maps(bs))
            self.chroma_maps = tuple(torch.from_numpy(m).to(self.device)
                                     for m in chroma_segment_maps(bs))

    def _put(self, planes) -> list[torch.Tensor]:
        """Host planes -> tensors on the device (one copy each)."""
        return [torch.from_numpy(np.require(p, np.uint8, ["C", "W"])).to(self.device)
                for p in planes]

    def _frame(self, frame: FramePlanes, y, u, v) -> FramePlanes:
        if self.luma_only:  # chroma passes through: the input's, as a copy
            return FramePlanes(_host(y), frame.u.copy(), frame.v.copy(), frame.width,
                               frame.height)
        return FramePlanes(_host(y), _host(u), _host(v), frame.width, frame.height)

    # -- backends ----------------------------------------------------------

    def _run_cuda(self, frame: FramePlanes) -> FramePlanes:
        out = deblock_frame_cuda(*self._put((frame.y, frame.u, frame.v)), self.luma_maps,
                                 self.chroma_maps, self.beta, self.tc,
                                 luma_only=self.luma_only)
        return self._frame(frame, *out)

    def _run_torch(self, frame: FramePlanes) -> FramePlanes:
        out = deblock_frame(*self._put((frame.y, frame.u, frame.v)), self.luma_maps,
                            self.chroma_maps, self.beta, self.tc, luma_only=self.luma_only)
        return self._frame(frame, *out)

    def _run_golden(self, frame: FramePlanes) -> FramePlanes:
        from .golden import deblock_frame_golden

        return deblock_frame_golden(frame, self.bs, self.qp, luma_only=self.luma_only)

    def _run_native(self, frame: FramePlanes) -> FramePlanes:
        from ..runtime.native import deblock_frame_native

        return deblock_frame_native(frame, self.bs, self.qp, luma_only=self.luma_only,
                                    num_threads=self.num_threads)

    def __call__(self, frame: FramePlanes) -> FramePlanes:
        if (frame.width, frame.height) != (self.width, self.height):
            raise ValueError("frame geometry mismatch")
        runner = getattr(self, f"_run_{self.backend}", None)
        if runner is None:
            raise ValueError(f"unknown backend {self.backend!r}")
        return runner(frame)

    def batch(self, frames: list[FramePlanes]) -> list[FramePlanes]:
        """Deblock a batch of frames in ONE K1 and ONE K1c launch, whatever
        their number (BASELINE config 3).

        The JAX package folds the frames into one taller tile grid by row
        concatenation; here the batch is the kernels' leading axis, with one
        shared BS map, so nothing is concatenated on the device.  Per batch
        one chain (ops/chain.tile_chain, pad 0): T2, K1 and T3 for the (N,
        Hext, Wext) luma planes; T2, K1c and T3 for the (N, 2, cHext, cWext)
        U/V planes.  Device backends only ("cuda", "torch")."""
        if self.backend not in KERNELS:
            raise ValueError("batch() requires a device backend ('cuda' or 'torch')")
        for f in frames:
            if (f.width, f.height) != (self.width, self.height):
                raise ValueError("frame geometry mismatch in batch")
        if not frames:
            return []
        (y,) = self._put([np.stack([f.y for f in frames])])
        yo = _host(tile_chain([y], self.luma_maps, self.beta, self.tc, pad=0, chroma=False,
                              backend=self.backend)[0])
        if self.luma_only:
            return [FramePlanes(yo[i], f.u.copy(), f.v.copy(), self.width, self.height)
                    for i, f in enumerate(frames)]
        (uv,) = self._put([np.stack([np.stack([f.u, f.v]) for f in frames])])
        uvo = _host(tile_chain([uv], self.chroma_maps, self.beta, self.tc, pad=0, chroma=True,
                               backend=self.backend)[0])
        return [FramePlanes(yo[i], uvo[i, 0], uvo[i, 1], self.width, self.height)
                for i in range(len(frames))]
