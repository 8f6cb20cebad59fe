"""gpu_video_codec_tpu_torch: HEVC in-loop deblocking of raw YV12 video in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of gpu_video_codec_tpu (JAX + Pallas), which stays the reference it
is checked against byte for byte.  Same layout and names:
  ops/      filter math (tables, torch int32 segment filters), whole-frame
            tile-plane deblock, the CUDA kernels' builds and wrappers (the
            deblock kernel; the relayout and YV12 pack kernels)
  csrc/     the kernels' CUDA C++ sources
  models/   the golden NumPy oracle, the streaming packed-YV12 pipeline and
            the device-resident tile-planes path
  utils/    YV12 I/O, boundary-strength subsystem, tile-planes layout,
            configuration
This package imports torch and numpy, never jax.
"""

__version__ = "0.1.0"

from .ops.tables import get_beta, get_tc  # noqa: F401
from .utils.yuv import FramePlanes, read_yv12, write_yv12  # noqa: F401
from .utils.bs import BoundaryStrength  # noqa: F401
