"""CUDA graphs of the port's steps: one launch where the eager step makes many.

An eager step is a handful of ctypes kernel launches plus the Python and
torch ops around them, tens to hundreds of µs of host time for 9-25 µs of
device work at 1080p.  A CUDA graph captured once replays all of it with
one cudaGraphLaunch.  The graph bakes every address it was captured with:
the operands, and the intermediates it allocated from its memory pool.  So
a graph is only replayed on the tensors it was captured on (GraphCache
keys include their addresses), and operands that change between replays
(the BS maps) are rewritten in place, never rebound.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from ..ops import cuda_kernel as ck
from ..ops import relayout_kernel as rk
from ..ops import swar_kernel as sk
from .tracing import RECORDER, stamp

# the kernels' launch counters, kept true across replays
COUNTERS = (ck.LAUNCHES, rk.LAUNCHES, sk.LAUNCHES)


def graphed(backend: str, device) -> bool:
    """Whether a step runs as a CUDA graph: the cuda backend on a CUDA
    device.  The plain torch backend, the reference the graphs are held
    against, and every CPU device run their steps eagerly."""
    return backend == "cuda" and device.type == "cuda"


def tensor_key(*tensors) -> tuple:
    """What a graph bakes of its tensor operands: address, shape, strides."""
    return tuple((t.data_ptr(), tuple(t.shape), t.stride()) for t in tensors)


class CapturedStep:
    """One torch.cuda.CUDAGraph of `fn(*args)` on CUDA tensors `args`.

    Building it first calls fn on clones of args: that loads every kernel
    library and launches each kernel once outside any capture (a library's
    first CUDA call and a kernel's lazy module load are illegal inside
    one), and leaves the caller's tensors as they were.  Then it captures
    fn(*args), which runs nothing.  Launches the counters saw during the
    warm-up and the capture are taken back; each replay() adds the
    capture's counts, so the counters say what replays ran.  A failure to
    capture raises.

    The graph keeps what fn returned (replay() returns it), and no other
    reference to args: fn returns only tensors it allocated, or None, so
    that a cached graph does not keep the caller's buffers alive.

    pool: a memory pool to share with other graphs (another graph's
    .pool()); safe only for graphs that never replay concurrently and keep
    no output in the pool that another replay could overwrite.

    The warm-up and the capture run on the device of args, on a side stream
    of that device (torch.cuda.graph's default capture stream belongs to
    the device that was current when it was first made); replay() runs on
    the current stream, which must be one of that device.

    The warm-up and the capture are the span graphs.capture
    (utils/tracing.py)."""

    def __init__(self, fn, args, pool=None):
        device = args[0].device
        before = [dict(c) for c in COUNTERS]
        with RECORDER.span("graphs.capture"), torch.cuda.device(device):
            fn(*(a.clone() for a in args))
            warm = [dict(c) for c in COUNTERS]
            self.graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(self.graph, pool=pool, stream=torch.cuda.Stream(device)):
                    self.out = fn(*args)
                self.launches = [{k: c[k] - w[k] for k in c if c[k] != w[k]}
                                 for c, w in zip(COUNTERS, warm)]
            finally:
                for c, b in zip(COUNTERS, before):
                    c.update(b)

    def pool(self):
        return self.graph.pool()

    def replay(self):
        """Launch the graph on the current stream; returns what fn returned
        at capture (tensors the next replay rewrites)."""
        self.graph.replay()
        for c, d in zip(COUNTERS, self.launches):
            for k, v in d.items():
                c[k] += v
        return self.out

    def timed_replay(self) -> tuple[int, int]:
        """replay(), returning instead the stamps around the graph's launch
        alone (the span graphs.launch, utils/tracing.py)."""
        for c, d in zip(COUNTERS, self.launches):
            for k, v in d.items():
                c[k] += v
        t0 = stamp()
        self.graph.replay()
        return t0, stamp()


class GraphCache:
    """At most `maxsize` CapturedSteps by key, least recently used evicted
    first; dropping a graph frees its memory pool."""

    def __init__(self, maxsize: int = 8):
        self.maxsize = maxsize
        self._graphs: OrderedDict = OrderedDict()

    def get(self, key, build):
        """The entry under `key`, built with build() when absent."""
        entry = self._graphs.pop(key, None)
        if entry is None:
            entry = build()
        self._graphs[key] = entry
        while len(self._graphs) > self.maxsize:
            self._graphs.popitem(last=False)
        return entry

    def __len__(self) -> int:
        return len(self._graphs)
