"""Mesh-sharded device-resident streaming: frame batches over "data" slots.

Counterpart of gpu_video_codec_tpu/parallel/resident_mesh.py.  Frames stay
on their slot's device in the tile-planes layout (models/resident.py), so a
step is the deblock kernels K1 and K1c and nothing else, on every slot at
once, with no exchange between slots (tiles never communicate).

A batch of n frames goes over the mesh's "data" axis in n / n_data-frame
chunks, one port ResidentDeblocker per data slot (the slots of spatial
index 0; resident state shards by whole frames, so the spatial axis is not
used, as in the JAX package).  Where the JAX package shards one batched
TileFrame, the state here is a MeshTileFrame: one TileFrame per data slot.

Usage:
    mrd = MeshResidentDeblocker(mesh, w, h, qp)
    state = mrd.ingest(frames)        # (n, 3wh/2) batch, n % n_data == 0
    state = mrd.step(state, 3)        # kernels only: one graph replay a slot
    out = mrd.readback(state)         # (n, 3wh/2) filtered batch on the host
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .mesh import Mesh, on_device
from ..models.resident import ResidentDeblocker, _readback
from ..ops.cuda_kernel import BLOCK_BX, CHROMA_BLOCK_BX
from ..utils.bs import BoundaryStrength


class MeshTileFrame(NamedTuple):
    """Mesh-resident state: one TileFrame per data slot, in frame order."""

    parts: tuple


class MeshResidentDeblocker:
    """Device-resident deblocking of frame batches over a mesh's "data" axis.

    luma_block/chroma_block: tiles per CUDA block of K1/K1c, as
    ResidentDeblocker takes them (consecutive tiles of the flattened tile
    grid, at most 64).  The JAX package takes a (by, bx) Pallas block of
    by * bx tiles instead; its block shape has no counterpart on the card,
    so the port's default (BLOCK_BX, CHROMA_BLOCK_BX) stands for the JAX
    default."""

    def __init__(self, mesh: Mesh, width: int, height: int, qp: int, *,
                 luma_only: bool = False, bs: BoundaryStrength | None = None,
                 luma_block: int | None = None, chroma_block: int | None = None):
        if "data" not in mesh.shape:
            raise ValueError('mesh must have a "data" axis')
        self.mesh = mesh
        self.n_data = mesh.shape["data"]
        self.width, self.height, self.qp = width, height, int(qp)
        self._rds = [ResidentDeblocker(
            width, height, qp, luma_only=luma_only, bs=bs,
            luma_block=BLOCK_BX if luma_block is None else luma_block,
            chroma_block=CHROMA_BLOCK_BX if chroma_block is None else chroma_block,
            device=mesh.devices[d, 0]) for d in range(self.n_data)]
        self.frame_bytes = self._rds[0].frame_bytes

    def update_boundary_strength(self, bs: BoundaryStrength) -> None:
        """Swap in new BS arrays on every slot (rewritten in place: captured
        graphs read them, steps queued before keep the old ones)."""
        for rd in self._rds:
            rd.update_boundary_strength(bs)

    def ingest(self, frames) -> MeshTileFrame:
        """Host frame batch -> MeshTileFrame: each data slot ingests its
        chunk (one host-to-device copy and two T2 launches a slot).

        frames: list/tuple of packed frames, an (n, 3wh/2) uint8 array, or a
        packed (n, 3wh/2) uint8 tensor; n must divide by the data axis."""
        first = self._rds[0]
        if isinstance(frames, torch.Tensor):
            if frames.dtype != torch.uint8:
                raise ValueError(f"a tensor batch must be uint8, got {frames.dtype}")
            batch = frames.reshape(first._batch_shape(frames.shape))
        elif isinstance(frames, (list, tuple)):
            batch = np.stack([first.host_buf(f) for f in frames])
        else:
            batch = first.host_buf(frames)
        if batch.ndim != 2:
            raise ValueError("mesh ingest needs a BATCH of frames")
        if batch.shape[0] % self.n_data:
            raise ValueError(
                f"batch {batch.shape[0]} not divisible by data axis {self.n_data}")
        c = batch.shape[0] // self.n_data
        parts = []
        for d, rd in enumerate(self._rds):
            chunk = batch[d * c : (d + 1) * c]
            if isinstance(chunk, torch.Tensor):
                chunk = chunk.to(rd.device)
            with on_device(rd.device):
                parts.append(rd.ingest(chunk))
        return MeshTileFrame(tuple(parts))

    def step(self, tf: MeshTileFrame, n_steps: int = 1) -> MeshTileFrame:
        """n_steps kernel-only deblock passes on every slot: each slot's
        ResidentDeblocker.run_steps, one CUDA graph replay on a CUDA slot
        (a loop of eager steps on a CPU slot).  tf stays as it was."""
        parts = []
        for rd, part in zip(self._rds, tf.parts):
            with on_device(rd.device):
                parts.append(rd.run_steps(part, n_steps))
        return MeshTileFrame(tuple(parts))

    def readback(self, tf: MeshTileFrame) -> np.ndarray:
        """MeshTileFrame -> (n, 3wh/2) filtered batch on the host: per slot
        T3 for luma and for U+V and T4 (models/resident._readback), and one
        device-to-host copy straight into its rows of the result."""
        n = sum(part.y.shape[0] for part in tf.parts)
        out = np.empty((n, self.frame_bytes), dtype=np.uint8)
        host, lo = torch.from_numpy(out), 0
        for rd, part in zip(self._rds, tf.parts):
            k = part.y.shape[0]
            with on_device(rd.device):
                host[lo : lo + k].copy_(_readback(part, self.width, self.height))
            lo += k
        return out

    def __call__(self, frames) -> np.ndarray:
        return self.readback(self.step(self.ingest(frames)))
