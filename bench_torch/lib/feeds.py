"""What every feed shares: the window's record, the tracer and the base
class.  A feed is the way a traffic mix hands frames to the program; each
is a file of its own, bench_torch/feeds/<feed>.py, found by the mix's
"feed" (lib/spec.feed) and defining a class Feed(lib.feeds.Feed) with:

  setup()                        pools, BS, the program's objects, warm-up
  window(seconds, tracer, rec)   the measured window, then (tracer on) a
                                 traced stretch; fills rec and self.samples
  missing(rec)                   frames handed over that never came back,
                                 or None where every call returns its
                                 frames done

self.samples holds what the program produced, drawn from the seed, as
(input frames, output frames) pairs.  control=True puts the plain
reference, computed with the control's broken arithmetic, in the
program's place.  Frames are of the configuration's bit_depth
(lib/frames.sample_dtype; self.sample_bytes is a sample's size) and
chroma_format ("4:2:0" where the key is missing; lib/frames.chroma_plane):
self.rows packed rows of w samples, chroma planes (self.ch, self.cw).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import numpy as np
import torch

from . import frames as fr
from . import trace as tr


class Record:
    """What a window did: the numbers the metric readers read."""

    def __init__(self, feed: str, width: int, height: int, per_batch: int, kind: str,
                 sample_bytes: int = 1, chroma_format: str = "4:2:0"):
        self.feed, self.width, self.height = feed, width, height
        self.per_batch = per_batch  # frames a batch (one call of the program)
        self.kind = kind            # the card's name
        self.sample_bytes = sample_bytes  # bytes a sample: 1 at 8 bits, 2 at 10
        self.chroma_format = chroma_format  # "4:2:0", "4:2:2" or "4:4:4"
        self.setup_s = None
        self.frames = 0             # frames done in the window
        self.handed = 0             # frames handed to the program
        self.window_s = None        # the window's wall time
        self.dispatch_s: list[float] = []    # host time of each untraced call
        self.trace: dict | None = None       # Tracer.summary()


class _Span:
    __slots__ = ("spans", "name", "t")

    def __init__(self, spans, name):
        self.spans, self.name = spans, name

    def __enter__(self):
        self.t = time.perf_counter()

    def __exit__(self, *exc):
        self.spans.append((self.t, time.perf_counter(), self.name))


class Tracer:
    """torch.profiler, device activity only, over a stretch that follows
    the measured window, with the harness's host spans stamped by
    time.perf_counter; nothing when off.  The profiler slows the host's
    calls (device activity alone by 5-50%, with host activity by about
    90%), so the window's own numbers are taken before it starts.

    The spans are moved onto the trace's clock by marks: a cudaEventQuery
    made between two perf_counter stamps, three at the start of the
    stretch and three at its end; of each three the tightest pair of
    stamps gives the offset, and the two offsets a linear map."""

    def __init__(self, on: bool):
        self.on, self.active = on, False
        self.spans: list[tuple[float, float, str]] = []
        self.marks: list[tuple[float, float]] = []

    def _mark(self):
        for _ in range(3):
            ev = torch.cuda.Event()
            ev.record()
            a = time.perf_counter()
            ev.query()
            self.marks.append((a, time.perf_counter()))

    def start(self):
        if not self.on:
            return
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        self._mark()
        self.lo = time.perf_counter()
        self.active = True

    def span(self, name: str):
        return _Span(self.spans, name) if self.active else contextlib.nullcontext()

    def stop(self):
        if not self.active:
            return
        torch.cuda.synchronize()
        self.hi = time.perf_counter()
        self._mark()
        self.prof.stop()
        self.active = False

    def _clock(self, events):
        """perf_counter seconds -> trace us, from the marks; None where the
        trace lacks them."""
        queries = tr.runtime_calls(events, "cudaEventQuery")
        if len(queries) < 6:
            return None
        pairs = []
        for marks, calls in ((self.marks[:3], queries[:3]), (self.marks[3:], queries[-3:])):
            (a, b), (ts, e) = min(zip(marks, calls), key=lambda mc: mc[0][1] - mc[0][0])
            pairs.append(((a + b) / 2 * 1e6, ts + float(e.get("dur", 0.0)) / 2))
        (x0, y0), (x1, y1) = pairs
        rate = (y1 - y0) / (x1 - x0) if x1 > x0 else 1.0
        return lambda t: y0 + (t * 1e6 - x0) * rate

    def summary(self, cards, batches: int) -> dict | None:
        """Device events per card inside the traced stretch, the stretch,
        the harness spans and which span launched what, all on the
        trace's clock (us); None where the trace has no device lane."""
        if not self.on:
            return None
        with tempfile.TemporaryDirectory(prefix="bench_torch_trace_") as d:
            path = os.path.join(d, "trace.json")
            self.prof.export_chrome_trace(path)
            events = tr.load_events(path)
        leaves = tr.device_leaves(events)
        clock = self._clock(events)
        if not leaves or clock is None:
            return None
        lo, hi = clock(self.lo), clock(self.hi)
        spans = [(clock(a), clock(b), name) for a, b, name in self.spans]
        return {
            "lo": lo, "hi": hi, "spans": spans,
            "cards": {c: tr.clip(leaves.get(c, []), lo, hi) for c in cards},
            "launch_span": tr.launch_spans(events, spans),
            "batches": batches,
        }


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Feed:
    """The base of every feed: the run's geometry, bit depth, chroma
    format, seed, sample instants, BS arrays, seeded frame pools and the
    control."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device: str, control: bool):
        self.cfg, self.mix, self.seed, self.control = cfg, mix, int(seed), control
        self.w, self.h, self.qp = int(cfg["width"]), int(cfg["height"]), int(cfg["qp"])
        self.bit_depth = int(cfg["bit_depth"])
        self.sample_bytes = fr.sample_dtype(self.bit_depth).itemsize
        self.chroma_format = cfg.get("chroma_format", "4:2:0")
        self.ch, self.cw = fr.chroma_plane(self.w, self.h, self.chroma_format)
        self.rows = fr.packed_rows(self.w, self.h, self.chroma_format)
        self.device = torch.device(device, 0) if device == "cuda" else torch.device(device)
        self.rng = np.random.default_rng(self.seed)
        self.fractions = sorted(self.rng.random(int(mix["samples"])))
        self.bs = fr.bs_arrays(self.w, self.h, mix, self.seed, self.device, self.chroma_format)
        self.samples: list[tuple] = []  # (input frames, output frames), host or device

    def kind(self) -> str:
        return torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu"

    def frame_pool(self, n: int) -> torch.Tensor:
        return fr.frame_pool(n, self.w, self.h, self.seed, self.cfg["content"], self.device,
                             self.bit_depth, self.chroma_format)

    def control_deblock(self, frames: torch.Tensor) -> torch.Tensor:
        """The control: the plain reference with its broken arithmetic."""
        from .check import reference_of

        return reference_of(self.cfg).deblock_packed(frames, self.w, self.h, self.qp, self.bs,
                                                     shift="trunc", bit_depth=self.bit_depth,
                                                     chroma_format=self.chroma_format)

    def missing(self, rec: Record) -> int | None:
        return None
