"""Drop-in migration shim: the reference's class API on the PyTorch port.

Counterpart of gpu_video_codec_tpu/compat.py.  Users of the reference drive
everything through `ReadYuvFrame` (hevc_deblocking_filter_cpu.h:33-1489):
construct from a YV12 file, call `DeblockingFilter(num_threads)`,
optionally inject BS via `SetBoundaryStrenght` (sic -- the reference's
spelling, kept so call sites port unchanged), and `Save(path)`; and through
the drivers `ExecuteCpu` / `ExecuteGpu` and `GetGpuDeviceInfo` (main.cu).

    from gpu_video_codec_tpu_torch.compat import ReadYuvFrame
    frame = ReadYuvFrame("in.yuv", 352, 288, Qp=35)
    frame.DeblockingFilter()          # the CUDA kernels on the GPU
    frame.Save("out.yuv")

`num_threads` is the native CPU backend's OpenMP thread count when
backend="native" (reference semantics, cpu.h:135); the device backends use
the whole card and accept and ignore it, as a GPU user would expect.
"""

from __future__ import annotations

import time

import numpy as np

from .models.pipeline import DeblockPipeline
from .utils.bs import BoundaryStrength
from .utils.yuv import FramePlanes, read_yv12, write_yv12


class ReadYuvFrame:
    """Reference-API frame object (cpu.h:33).  Reads YV12 and deblocks.

    backend: one of utils.config.BACKENDS; device: the torch device of the
    "cuda" and "torch" backends (DeblockPipeline)."""

    def __init__(self, file_name: str, width: int, height: int, Qp: int = 20,
                 backend: str = "cuda", device="cuda"):
        # ctor parity: reads the file, validates size/dims, pads planes,
        # initializes all-Intra BS (cpu.h:35-118).  Padding is defined-zero
        # here (quirk Q6) instead of uninitialized heap memory.
        self._frame: FramePlanes = read_yv12(file_name, width, height)
        self._bs = BoundaryStrength.intra_default(width, height)
        self._qp = int(Qp)
        self._backend = backend
        self._device = device

    # reference spelling preserved (cpu.h:120)
    def SetBoundaryStrenght(self, vert_bs, num_vert_bs=None, hor_bs=None, num_hor_bs=None):
        """Inject luma BS arrays (cpu.h:120-132).

        Accepts either the 4-arg C-style call (arrays + explicit sizes) or
        the natural 2-arg Python call (vert_bs, hor_bs).
        """
        if hor_bs is None and num_vert_bs is not None:
            # SetBoundaryStrenght(vert, hor) convenience form
            hor_bs = num_vert_bs
            num_vert_bs = None
        vert = np.asarray(vert_bs, np.uint8).ravel()
        hor = np.asarray(hor_bs, np.uint8).ravel()
        if num_vert_bs is not None and vert.size != num_vert_bs:
            raise ValueError("num_vert_bs does not match vert_bs length")
        if num_hor_bs is not None and hor.size != num_hor_bs:
            raise ValueError("num_hor_bs does not match hor_bs length")
        self._bs.set_luma(vert, hor)  # size-checked like the reference

    def DeblockingFilter(self, num_threads: int = 1) -> None:
        """Run the in-loop deblocking filter in place (cpu.h:134)."""
        pipe = DeblockPipeline(self._frame.width, self._frame.height, self._qp,
                               backend=self._backend, bs=self._bs,
                               num_threads=num_threads if self._backend == "native" else 0,
                               device=self._device)
        self._frame = pipe(self._frame)

    def Save(self, output_file_name: str) -> None:
        """Write the (filtered) frame back as YV12 (cpu.h:995-1018)."""
        write_yv12(output_file_name, self._frame)

    # pythonic accessors beyond the reference API
    @property
    def planes(self) -> FramePlanes:
        return self._frame


def GetGpuDeviceInfo() -> dict:
    """GetGpuDeviceInfo (main.cu:92-107): name, memory, SM count and warp
    size of every CUDA device, returned structured (the reference printed
    them), with the native runtime's ISA and threads (cli.device_info)."""
    from .cli import device_info

    return device_info()


def ExecuteCpu(input_file: str, output_file: str, width: int, height: int,
               Qp: int, thread_counts=(1, 2, 4, 6, 8)) -> dict:
    """Reference ExecuteCpu parity (main.cu:36-83): run the native CPU filter
    at several OpenMP thread counts, timing each on the host clock and
    writing the (identical) output once per run like the original.  Returns
    {threads: seconds}.  The runtime is built and loaded before the timed
    region."""
    from .runtime import native

    native.load()
    timings: dict[int, float] = {}
    for nt in thread_counts:
        frame = ReadYuvFrame(input_file, width, height, Qp, backend="native")
        t0 = time.perf_counter()
        frame._frame = native.deblock_frame_native(frame._frame, frame._bs, frame._qp,
                                                   num_threads=nt)
        timings[nt] = time.perf_counter() - t0
        frame.Save(output_file)
    return timings


def ExecuteGpu(input_file: str, output_file: str, width: int, height: int,
               Qp: int, luma_block=None, chroma_block=None, device="cuda") -> dict:
    """Reference ExecuteGpu (gpu.cu:1230-1306): the kernels' filter with
    caller-chosen blocks, timing the copy and the kernels apart like the
    original's 'with copy' / 'without copy' split.  The counterpart of the
    JAX package's ExecuteTpu.

    luma_block / chroma_block: tiles per block of K1 and K1c
    (StreamingDeblocker's; default ops.cuda_kernel.BLOCK_BX and
    CHROMA_BLOCK_BX), where the step takes the chain; K2's are its own.  Returns, in seconds per frame (CUDA device only):
      kernel_s -- the packed step alone, input already resident
                  (gpu.cu:1266-1291)
      h2d_s    -- the host-to-device copy alone (gpu.cu:1248-1256)
      total_s  -- a measured synchronous put -> step -> read back of one
                  frame (time_breakdown(measure_d2h=True)["e2e_sync_s"]),
                  the reference's 'with copy' total (gpu.cu:1246-1303).
    The output file is written first; on a CPU device the timing then
    raises RuntimeError (there is no device to time)."""
    from .models.streaming import StreamingDeblocker
    from .ops.cuda_kernel import BLOCK_BX, CHROMA_BLOCK_BX

    with open(input_file, "rb") as f:
        raw = f.read(3 * width * height // 2)
    s = StreamingDeblocker(width, height, Qp, backend="cuda",
                           luma_block=BLOCK_BX if luma_block is None else luma_block,
                           chroma_block=CHROMA_BLOCK_BX if chroma_block is None else chroma_block,
                           device=device)
    (out,) = list(s.run([raw]))
    with open(output_file, "wb") as f:
        f.write(out.tobytes())
    tb = s.time_breakdown(raw, n=10, measure_d2h=True)
    return {"kernel_s": tb["kernel_s"], "h2d_s": tb["h2d_s"], "total_s": tb["e2e_sync_s"]}
