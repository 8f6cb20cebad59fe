"""YV12 frame I/O and padded ("extended") plane layout.

On-disk contract (reference parity, cpu.h:66-83 / 995-1018): planar YV12 --
full-resolution Y plane, then quarter-resolution U, then V, each row-major
uint8; file size must equal 3*w*h/2 (cpu.h:43) and w, h must be multiples of
the 8-px sample block (cpu.h:46).

In-memory layout: each plane is stored *extended* by one sample block
(new_dim = dim + 8) with the real pixels offset by 4 in both axes
(cpu.h:55-82).  The 8x8 tile grid over the extended plane is therefore
shifted half a block relative to real HEVC block boundaries, which is what
makes every deblocking edge segment fall entirely inside a single tile
(see ops/deblock.py).

Deliberate deviation from the reference (documented quirk Q6): the reference
never initializes the padding bytes (raw `new` / cudaMallocHost), yet border
edges are filtered against them -- formally nondeterministic output in the
3-px border band.  We define padding == 0, and our golden model does the same,
so the whole frame (border included) is bit-exact within this framework.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..ops.tables import HALF_BLOCK, SAMPLE_BLOCK_SIZE


@dataclasses.dataclass
class FramePlanes:
    """Extended (padded) YV12 planes of one frame, uint8.

    y: (h + 8, w + 8); u, v: (h//2 + 8, w//2 + 8).  Real pixels live at
    [4 : 4 + dim] in each axis; padding is zero.
    """

    y: np.ndarray
    u: np.ndarray
    v: np.ndarray
    width: int
    height: int

    @property
    def chroma_width(self) -> int:
        return self.width // 2

    @property
    def chroma_height(self) -> int:
        return self.height // 2


def check_dims(width: int, height: int) -> None:
    if width % SAMPLE_BLOCK_SIZE != 0 or height % SAMPLE_BLOCK_SIZE != 0:
        # reference throws "Width and height of image must be multiplier of
        # sample block size" (cpu.h:46-48)
        raise ValueError(
            f"width and height must be multiples of {SAMPLE_BLOCK_SIZE}, "
            f"got {width}x{height}"
        )


def extend_plane(plane: np.ndarray) -> np.ndarray:
    """Pad a (h, w) uint8 plane to (h+8, w+8) with the image at offset +4."""
    h, w = plane.shape
    ext = np.zeros((h + SAMPLE_BLOCK_SIZE, w + SAMPLE_BLOCK_SIZE), dtype=np.uint8)
    ext[HALF_BLOCK : HALF_BLOCK + h, HALF_BLOCK : HALF_BLOCK + w] = plane
    return ext


def interior(ext: np.ndarray, height: int, width: int) -> np.ndarray:
    """Extract the real (height, width) image out of an extended plane."""
    return ext[HALF_BLOCK : HALF_BLOCK + height, HALF_BLOCK : HALF_BLOCK + width]


def planes_from_yv12_bytes(data: bytes | np.ndarray, width: int, height: int) -> FramePlanes:
    """Decode one raw YV12 frame into extended planes (cpu.h:35-83 parity)."""
    check_dims(width, height)
    buf = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8).ravel()
    expected = 3 * width * height // 2
    if buf.size != expected:
        # reference throws "Incorrect file size" (cpu.h:43-45)
        raise ValueError(f"incorrect YV12 size: got {buf.size} bytes, expected {expected}")
    cw, ch = width // 2, height // 2
    y = buf[: width * height].reshape(height, width)
    u = buf[width * height : width * height + cw * ch].reshape(ch, cw)
    v = buf[width * height + cw * ch :].reshape(ch, cw)
    return FramePlanes(
        y=extend_plane(y), u=extend_plane(u), v=extend_plane(v), width=width, height=height
    )


def read_yv12(path: str | os.PathLike, width: int, height: int) -> FramePlanes:
    """Read a single YV12 frame from disk into extended planes."""
    with open(path, "rb") as f:
        data = f.read()
    return planes_from_yv12_bytes(data, width, height)


def yv12_bytes_from_planes(frame: FramePlanes) -> bytes:
    """Serialize the interior of extended planes back to raw YV12 (cpu.h:995-1018)."""
    y = interior(frame.y, frame.height, frame.width)
    u = interior(frame.u, frame.chroma_height, frame.chroma_width)
    v = interior(frame.v, frame.chroma_height, frame.chroma_width)
    return b"".join(np.ascontiguousarray(p).tobytes() for p in (y, u, v))


def write_yv12(path: str | os.PathLike, frame: FramePlanes) -> None:
    with open(path, "wb") as f:
        f.write(yv12_bytes_from_planes(frame))


def read_yv12_stream(path: str | os.PathLike, width: int, height: int,
                     max_frames: int | None = None) -> list[FramePlanes]:
    """Read a multi-frame YV12 stream (concatenated frames) from disk."""
    check_dims(width, height)
    frame_bytes = 3 * width * height // 2
    frames: list[FramePlanes] = []
    with open(path, "rb") as f:
        while max_frames is None or len(frames) < max_frames:
            data = f.read(frame_bytes)
            if len(data) < frame_bytes:
                break
            frames.append(planes_from_yv12_bytes(data, width, height))
    return frames
