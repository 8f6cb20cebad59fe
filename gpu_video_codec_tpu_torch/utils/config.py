"""Configuration for the deblocking pipeline.

Replaces the reference's hard-coded constants in main() (main.cu:111-133:
input file, dimensions and Qp commented in/out by hand; GPU block dims as
call-site literals, main.cu:138) with a validated dataclass + CLI parsing.
"""

from __future__ import annotations

import dataclasses

from ..ops.tables import SAMPLE_BLOCK_SIZE


# "cuda": the hand-written kernels; "torch": the plain PyTorch version of
# the same math; "golden": the scalar NumPy oracle; "native": the C++
# OpenMP CPU runtime (runtime/native.py).
BACKENDS = ("cuda", "torch", "golden", "native")


@dataclasses.dataclass
class DeblockConfig:
    input: str
    width: int
    height: int
    qp: int = 20  # reference default (cpu.h:35)
    output: str | None = None
    backend: str = "cuda"
    luma_only: bool = False
    frames: int | None = None  # max frames to read from a stream
    num_threads: int = 0       # native backend OpenMP threads (0 = default)
    depth: int = 2             # streaming pipeline frames in flight
    device: str = "cuda"       # torch device of the cuda/torch backends

    def validate(self) -> "DeblockConfig":
        if self.width <= 0 or self.height <= 0:
            raise ValueError("width/height must be positive")
        if self.width % SAMPLE_BLOCK_SIZE or self.height % SAMPLE_BLOCK_SIZE:
            raise ValueError(
                f"width and height must be multiples of {SAMPLE_BLOCK_SIZE}"
            )
        if self.qp < 0:
            raise ValueError("qp must be >= 0")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {self.backend!r}")
        if self.frames is not None and self.frames <= 0:
            raise ValueError("frames must be positive")
        if self.depth <= 0:
            raise ValueError("depth must be positive")
        if self.num_threads < 0:
            raise ValueError("num_threads must be >= 0")
        return self
