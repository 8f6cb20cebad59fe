"""The "device" feed: a closed loop over frames that already sit on the
card.  Per batch the harness refreshes one (k, rows, w) batch buffer from
the next DPB frame of each of k streams (one copy, the decoder's write)
and calls the program's packed batch step on it, in place
(parallel.mesh.deblock_packed_batch_sharded_jit on a one-slot mesh).

The mix's parameters: streams (k), in_flight (batches queued at most),
warmup_batches, samples (seeded instants of the window whose batch is
kept for the check) and trace_batches (the traced stretch's length).
The host records an event after every WAIT_EVERY-th batch and, before
dispatching one that starts such a group, waits for the event in_flight
batches back, so that a short stall of the host (tens of milliseconds at
in_flight 256) leaves the card fed.  The window ends when its time is up:
nothing more is sent, all that was sent is waited for, and the clock is
read after that wait.

The frames are of the configuration's bit_depth and chroma_format
(lib/frames.frame_pool), and so are the batch buffer and the captures:
rows = 3h/2 at 4:2:0, 2h at 4:2:2, 3h at 4:4:4 (lib/frames.packed_rows).
The program's call:

  bit_depth 8   deblock_packed_batch_sharded_jit(mesh, buf, lm, cm, beta,
                tc, w=w, h=h), buf a uint8 (k, 3h/2, w) batch;
  bit_depth 10  the same call with bit_depth=10 as one more keyword, buf
                an int16 (k, 3h/2, w) batch of samples in [0, 1023] (the
                16-bit words of yuv420p10le planes).  beta and tc stay the
                tables' beta' and tc' at the QP: the program scales them by
                2^(bit_depth - 8) and clips to [0, 2^bit_depth - 1], as
                H.265 does and as references/hevc_deblock.py documents;
  4:2:2         the call of the bit depth with chroma_format="4:2:2" as one
                more keyword, buf a (k, 2h, w) batch: luma, then U and V
                (h, w/2) each (at 10 bits the 16-bit words of yuv422p10le
                planes).  cm are the chroma planes' maps, at (h/8 + 1,
                w/16 + 1) tiles, looked up at the chroma width w/2 and gated
                by the luma tile counts, as at 4:2:0; beta and tc as above;
  4:4:4         the call of the bit depth with chroma_format="4:4:4", buf a
                (k, 3h, w) batch: luma, then U and V (h, w) each (at 10 bits
                the 16-bit words of yuv444p10le planes).  cm are at (h/8 + 1,
                w/8 + 1) tiles, looked up at the chroma width w and gated by
                the luma tile counts, which are the planes' own; beta and tc
                as above.

At 4:2:0 the call has no chroma_format keyword, at 8 bits no bit_depth.
A program that does not take one of them raises at the first call of
set-up's warm-up, and the run ends with that error and no result.
"""

from __future__ import annotations

import gc
import time

import torch

from bench_torch.lib.feeds import Feed as Base
from bench_torch.lib.feeds import Record, Tracer, sync

# batches a group: one event is recorded, and one waited for, a group
WAIT_EVERY = 8


class Feed(Base):
    """Closed loop over device-resident DPB frames of k streams."""

    def setup(self):
        k, dpb = int(self.mix["streams"]), int(self.cfg["dpb_frames"])
        self.k, self.dpb = k, dpb
        self.pool = self.frame_pool(dpb * k).view(dpb, k, self.rows, self.w)
        self.buf = torch.empty_like(self.pool[0])
        self.captures = torch.empty((len(self.fractions), *self.buf.shape), dtype=self.buf.dtype,
                                    device=self.device)
        if self.control:
            def step():
                self.buf.copy_(self.control_deblock(self.buf))
        else:
            from gpu_video_codec_tpu_torch.ops.tables import get_beta, get_tc
            from gpu_video_codec_tpu_torch.parallel import mesh as pm
            from gpu_video_codec_tpu_torch.utils.bs import segment_bs_maps_device

            b, w, h, ch, cw = 8, self.w, self.h, self.ch, self.cw
            ny, nx = h // b + 1, w // b + 1
            lm = segment_bs_maps_device(self.bs["vert"], self.bs["hor"], w, ny, nx, ny, nx,
                                        device=self.device)
            cm = segment_bs_maps_device(self.bs["chroma_vert"], self.bs["chroma_hor"], cw,
                                        ch // b + 1, cw // b + 1, ny, nx, device=self.device)
            mesh = pm.make_mesh(1, 1, devices=[self.device])
            beta, tc = get_beta(self.qp), get_tc(self.qp)
            kw = {}
            if self.bit_depth != 8:
                kw["bit_depth"] = self.bit_depth
            if self.chroma_format != "4:2:0":
                kw["chroma_format"] = self.chroma_format

            def step():
                pm.deblock_packed_batch_sharded_jit(mesh, self.buf, lm, cm, beta, tc, w=w, h=h,
                                                    **kw)
        self.step = step
        for i in range(int(self.mix["warmup_batches"])):
            self.buf.copy_(self.pool[i % dpb])
            self.step()
        sync(self.device)

    def window(self, seconds: float, tracer: Tracer, rec: Record):
        """The measured window, then (tracer on) the traced stretch."""
        cuda = self.device.type == "cuda"
        depth = int(self.mix["in_flight"])
        every = min(WAIT_EVERY, depth)
        events = [torch.cuda.Event() for _ in range(max(1, depth // every))] if cuda else []
        frames = list(self.pool)
        taken, js = 0, []

        def batch(i, now):
            nonlocal taken
            group, first = divmod(i, every)
            if cuda and first == 0 and i >= depth:
                events[group % len(events)].synchronize()
            j = i % self.dpb
            with tracer.span("refresh"):
                self.buf.copy_(frames[j])
            with tracer.span("step_call"):
                a = time.perf_counter()
                self.step()
                dt = time.perf_counter() - a
            if taken < len(self.fractions) and now >= self.fractions[taken] * seconds:
                with tracer.span("capture"):
                    self.captures[taken].copy_(self.buf)
                js.append(j)
                taken += 1
            if cuda and first == every - 1:
                events[group % len(events)].record()
            return dt

        i = 0
        gc.collect()
        gc.disable()
        t0 = time.perf_counter()
        while (now := time.perf_counter() - t0) < seconds:
            rec.dispatch_s.append(batch(i, now))
            i += 1
        sync(self.device)
        rec.window_s = time.perf_counter() - t0
        rec.frames = rec.handed = i * self.k
        n_trace = int(self.mix["trace_batches"]) if tracer.on else 0
        if n_trace:
            tracer.start()
            for _ in range(n_trace):
                batch(i, seconds)
                i += 1
            tracer.stop()
        gc.enable()
        self.samples = [(self.pool[j], self.captures[s]) for s, j in enumerate(js)]
        self.samples.append((self.pool[(i - 1) % self.dpb], self.buf))
        rec.trace = tracer.summary([0], n_trace)
