"""gpu_video_codec_tpu_torch: HEVC in-loop deblocking of raw YV12 video in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of gpu_video_codec_tpu (JAX + Pallas), which stays the reference it
is checked against byte for byte.  Same layout and names:
  ops/      filter math (tables, torch int32 or int16 segment filters),
            whole-frame tile-plane deblock, the CUDA kernels' builds and
            wrappers (the deblock kernel in int and int16_t and on the rows
            layout; the SWAR deblock kernel; the relayout and YV12 pack
            kernels)
  csrc/     the kernels' CUDA C++ sources
  tools/    the kernel-variant experiments (int16_probe, rowslayout_exp,
            swar_exp) and the host tools (psnr, validate_vs_reference) as
            entry points
  models/   the golden NumPy oracle, the frame pipeline and its backends
            (cuda, torch, golden, native), the streaming packed-YV12
            pipeline and the device-resident tile-planes path
  runtime/  the native C++ OpenMP CPU runtime (the JAX package's sources,
            built with g++ at first use) with its ctypes binding
  utils/    YV12 I/O, boundary-strength subsystem, tile-planes layout,
            configuration
  compat.py the reference's class API and drivers (ReadYuvFrame,
            ExecuteCpu, ExecuteGpu, GetGpuDeviceInfo)
  examples/ self-checking examples of the public API
This package imports torch and numpy, never jax.
"""

__version__ = "0.1.0"

from .ops.tables import get_beta, get_tc  # noqa: F401
from .utils.yuv import FramePlanes, read_yv12, write_yv12  # noqa: F401
from .utils.bs import BoundaryStrength  # noqa: F401
