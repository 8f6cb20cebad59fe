"""Boundary-strength (BS) subsystem.

Reference parity: cpu.h:85-132.  BS semantics: 2 => intra edge (luma filtered
with `> 0` gate, chroma with `== 2` gate), 1 => luma-only, 0 => skip.

The reference stores BS as *flat* arrays and both the initialization pattern
and every lookup are raw flat-index arithmetic.  Two of its quirks are
load-bearing for bit-exactness and are replicated here verbatim:

* Q4 -- the horizontal-BS init zero-stripe uses stride (H/8 + 1)
  (cpu.h:96-99) while lookups use stride (W/8) (cpu.h:289, 370), so the
  zeroed entries do NOT correspond to frame-top edges.  We reproduce the flat
  init pattern exactly rather than "fixing" it.

* Q2 -- the chroma loops gate segment existence with the *luma* block counts
  (cpu.h:515, 645, 786, 916), which makes some chroma BS lookups index out of
  bounds of the chroma BS arrays.  The reference then reads heap garbage
  (formally nondeterministic).  We define every out-of-bounds BS read as 0
  (edge not filtered) -- the only self-consistent deterministic choice -- and
  our golden model pins the same rule.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ops.tables import SAMPLE_BLOCK_SIZE, chroma_height, chroma_width


def _init_flat_bs(total: int, zero_stride: int) -> np.ndarray:
    """All 2 ("assume all-Intra", cpu.h:91) except every index i with
    i % zero_stride == 0 which is forced to 0 (cpu.h:92-99)."""
    bs = np.full(total, 2, dtype=np.uint8)
    bs[::zero_stride] = 0
    return bs


@dataclasses.dataclass
class BoundaryStrength:
    """Flat luma + chroma BS arrays for one frame geometry.

    Sizes (cpu.h:86-87, 104-105):
      luma  vert: (W/8 + 1) * (H/8)     luma  hor: (H/8 + 1) * (W/8)
      chroma vert: (cW/8 + 1) * (cH/8)  chroma hor: (cH/8 + 1) * (cW/8)
    with the chroma plane (cH, cW) = (H/2, W/2) at chroma_format "4:2:0",
    (H, W/2) at "4:2:2" and (H, W) at "4:4:4".
    """

    width: int
    height: int
    vert: np.ndarray
    hor: np.ndarray
    chroma_vert: np.ndarray
    chroma_hor: np.ndarray
    chroma_format: str = "4:2:0"

    @classmethod
    def intra_default(cls, width: int, height: int,
                      chroma_format: str = "4:2:0") -> "BoundaryStrength":
        b = SAMPLE_BLOCK_SIZE
        cw, ch = chroma_width(width, chroma_format), chroma_height(height, chroma_format)
        # Array sizes follow the reference's exact expressions with C++
        # left-to-right precedence: (dim/8 + 1) * other_dim / 8 means
        # ((dim/8 + 1) * other_dim) / 8 (cpu.h:86-87, 104-105).  For luma the
        # two readings coincide (height is a multiple of 8); for chroma they
        # differ whenever the chroma dim is not 8-aligned (h % 16 == 8,
        # incl. 1080p), where the reference allocates AND initializes more
        # entries -- reads our earlier (a*b//8 vs a*(b//8)) sizing treated as
        # out-of-bounds are in fact defined values there.
        return cls(
            width=width,
            height=height,
            # zero-stripe strides per cpu.h:94 (W/8+1), cpu.h:98 (H/8+1),
            # cpu.h:112 (cW/8+1), cpu.h:116 (cH/8+1)
            vert=_init_flat_bs((width // b + 1) * height // b, width // b + 1),
            hor=_init_flat_bs((height // b + 1) * width // b, height // b + 1),
            chroma_vert=_init_flat_bs((cw // b + 1) * ch // b, cw // b + 1),
            chroma_hor=_init_flat_bs((ch // b + 1) * cw // b, ch // b + 1),
            chroma_format=chroma_format,
        )

    @classmethod
    def from_arrays(cls, width, height=None, vert=None, hor=None,
                    chroma_vert=None, chroma_hor=None) -> "BoundaryStrength":
        """Build from the four flat BS arrays of a (width, height) frame,
        size-checked as set_luma/set_chroma do.

        `width` may instead be any object with the six attributes width,
        height, vert, hor, chroma_vert and chroma_hor (for example another
        package's BoundaryStrength); its arrays are copied."""
        if height is None:
            src = width
            width, height = src.width, src.height
            vert, hor = src.vert, src.hor
            chroma_vert, chroma_hor = src.chroma_vert, src.chroma_hor
        bs = cls.intra_default(int(width), int(height))
        bs.set_luma(vert, hor)
        bs.set_chroma(chroma_vert, chroma_hor)
        return bs

    def set_luma(self, vert: np.ndarray, hor: np.ndarray) -> None:
        """User BS injection -- the `SetBoundaryStrenght` equivalent
        (cpu.h:120-132; luma only there, size-checked)."""
        vert = np.asarray(vert, dtype=np.uint8).ravel()
        hor = np.asarray(hor, dtype=np.uint8).ravel()
        if vert.size != self.vert.size or hor.size != self.hor.size:
            raise ValueError(
                f"incorrect BS array sizes: vert {vert.size} (want {self.vert.size}), "
                f"hor {hor.size} (want {self.hor.size})"
            )
        self.vert = vert.copy()
        self.hor = hor.copy()

    def set_chroma(self, vert: np.ndarray, hor: np.ndarray) -> None:
        """Chroma BS injection (no reference analogue -- the reference only
        exposes luma injection; provided for API completeness)."""
        vert = np.asarray(vert, dtype=np.uint8).ravel()
        hor = np.asarray(hor, dtype=np.uint8).ravel()
        if vert.size != self.chroma_vert.size or hor.size != self.chroma_hor.size:
            raise ValueError("incorrect chroma BS array sizes")
        self.chroma_vert = vert.copy()
        self.chroma_hor = hor.copy()


def _flat_lookup(flat: np.ndarray, idx: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """flat[idx] where valid and 0 <= idx < len(flat); else 0 (the OOB->0 rule)."""
    if flat.size == 0:
        # e.g. an 8-px-wide frame has zero chroma BS entries; every read is OOB
        return np.zeros(np.broadcast_shapes(idx.shape, valid.shape), np.uint8)
    ok = valid & (idx >= 0) & (idx < flat.size)
    return np.where(ok, flat[np.clip(idx, 0, flat.size - 1)], 0).astype(np.uint8)


def segment_bs_maps(
    flat_vert: np.ndarray,
    flat_hor: np.ndarray,
    lookup_w: int,
    num_tiles_y: int,
    num_tiles_x: int,
    gate_ny: int,
    gate_nx: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-tile BS values for the four edge segments of every extended tile.

    Returns (bs_ver1, bs_ver2, bs_hor1, bs_hor2), each (num_tiles_y, num_tiles_x)
    uint8.  Index arithmetic is the reference's, verbatim:
      ver1: (by-1)*(lookup_w/8+1)+bx, gated by>0            (cpu.h:160-163)
      ver2: by*(lookup_w/8+1)+bx,    gated by<gate_ny-1     (cpu.h:223-227)
      hor1: by*(lookup_w/8)+(bx-1),  gated bx>0             (cpu.h:287-291)
      hor2: by*(lookup_w/8)+bx,      gated bx<gate_nx-1     (cpu.h:368-372)

    For luma, gate_ny/gate_nx are the luma tile counts and lookup_w the luma
    width.  For chroma, lookup_w is the chroma width but gate_ny/gate_nx are
    the *luma* tile counts (quirk Q2: cpu.h:515, 645, 786, 916), which can
    push the flat index out of bounds; _flat_lookup defines those reads as 0.
    """
    b = SAMPLE_BLOCK_SIZE
    sv = lookup_w // b + 1
    sh = lookup_w // b
    by = np.arange(num_tiles_y)[:, None]
    bx = np.arange(num_tiles_x)[None, :]

    ver1 = _flat_lookup(flat_vert, (by - 1) * sv + bx, by > 0)
    ver2 = _flat_lookup(flat_vert, by * sv + bx, by < gate_ny - 1)
    hor1 = _flat_lookup(flat_hor, by * sh + (bx - 1), bx > 0)
    hor2 = _flat_lookup(flat_hor, by * sh + bx, bx < gate_nx - 1)
    return ver1, ver2, hor1, hor2


def segment_bs_maps_device(flat_vert, flat_hor, lookup_w: int,
                           num_tiles_y: int, num_tiles_x: int,
                           gate_ny: int, gate_nx: int, *, device):
    """Torch twin of segment_bs_maps: the four (num_tiles_y, num_tiles_x)
    uint8 gate maps, built on `device` from the flat BS arrays (numpy
    arrays or tensors).  Identical semantics incl. the OOB->0 rule.  The
    maps come out contiguous, as the deblock kernel requires.
    """
    import torch

    b = SAMPLE_BLOCK_SIZE
    sv = lookup_w // b + 1
    sh = lookup_w // b
    by = torch.arange(num_tiles_y, device=device)[:, None]
    bx = torch.arange(num_tiles_x, device=device)[None, :]
    fv = torch.as_tensor(flat_vert, dtype=torch.uint8, device=device)
    fh = torch.as_tensor(flat_hor, dtype=torch.uint8, device=device)

    def look(flat, idx, valid):
        if flat.numel() == 0:
            return torch.zeros(idx.shape, dtype=torch.uint8, device=device)
        ok = valid & (idx >= 0) & (idx < flat.numel())
        vals = flat[idx.clamp(0, flat.numel() - 1)]
        return torch.where(ok, vals, torch.zeros((), dtype=torch.uint8, device=device))

    ver1 = look(fv, (by - 1) * sv + bx, by > 0)
    ver2 = look(fv, by * sv + bx, by < gate_ny - 1)
    hor1 = look(fh, by * sh + (bx - 1), bx > 0)
    hor2 = look(fh, by * sh + bx, bx < gate_nx - 1)
    return ver1, ver2, hor1, hor2


def luma_segment_maps(bs: BoundaryStrength) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    b = SAMPLE_BLOCK_SIZE
    ny = bs.height // b + 1  # luma extended tile counts (cpu.h:141-142)
    nx = bs.width // b + 1
    return segment_bs_maps(bs.vert, bs.hor, bs.width, ny, nx, ny, nx)


def chroma_segment_maps(bs: BoundaryStrength) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    b = SAMPLE_BLOCK_SIZE
    cw = chroma_width(bs.width, bs.chroma_format)
    ch = chroma_height(bs.height, bs.chroma_format)
    cny = ch // b + 1  # chroma extended tile counts (cpu.h:450-451)
    cnx = cw // b + 1
    luma_ny = bs.height // b + 1  # Q2: gates use luma counts (cpu.h:515, 645)
    luma_nx = bs.width // b + 1
    return segment_bs_maps(bs.chroma_vert, bs.chroma_hor, cw, cny, cnx, luma_ny, luma_nx)
