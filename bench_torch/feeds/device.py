"""The "device" feed: a closed loop over frames that already sit on the
card.  Per batch the harness refreshes one (k, 3h/2, w) batch buffer from
the next DPB frame of each of k streams (one copy, the decoder's write)
and calls the program's packed batch step on it, in place
(parallel.mesh.deblock_packed_batch_sharded_jit on a one-slot mesh).

The mix's parameters: streams (k), in_flight (batches queued at most),
warmup_batches, samples (seeded instants of the window whose batch is
kept for the check) and trace_batches (the traced stretch's length).

The frames are of the configuration's bit_depth (lib/frames.frame_pool),
and so are the batch buffer and the captures.  The program's call:

  bit_depth 8   deblock_packed_batch_sharded_jit(mesh, buf, lm, cm, beta,
                tc, w=w, h=h), buf a uint8 (k, 3h/2, w) batch;
  bit_depth 10  the same call with bit_depth=10 as one more keyword, buf
                an int16 (k, 3h/2, w) batch of samples in [0, 1023] (the
                16-bit words of yuv420p10le planes).  beta and tc stay the
                tables' beta' and tc' at the QP: the program scales them by
                2^(bit_depth - 8) and clips to [0, 2^bit_depth - 1], as
                H.265 does and as references/hevc_deblock.py documents.

A program that does not take bit_depth raises at the first call of
set-up's warm-up, and the run ends with that error and no result.
"""

from __future__ import annotations

import gc
import time

import torch

from bench_torch.lib.feeds import Feed as Base
from bench_torch.lib.feeds import Record, Tracer, sync


class Feed(Base):
    """Closed loop over device-resident DPB frames of k streams."""

    def setup(self):
        k, dpb = int(self.mix["streams"]), int(self.cfg["dpb_frames"])
        self.k, self.dpb = k, dpb
        self.pool = self.frame_pool(dpb * k).view(dpb, k, 3 * self.h // 2, self.w)
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

            b, w, h = 8, self.w, self.h
            ny, nx = h // b + 1, w // b + 1
            lm = segment_bs_maps_device(self.bs["vert"], self.bs["hor"], w, ny, nx, ny, nx,
                                        device=self.device)
            cm = segment_bs_maps_device(self.bs["chroma_vert"], self.bs["chroma_hor"], w // 2,
                                        (h // 2) // b + 1, (w // 2) // b + 1, ny, nx,
                                        device=self.device)
            mesh = pm.make_mesh(1, 1, devices=[self.device])
            beta, tc = get_beta(self.qp), get_tc(self.qp)
            bd = self.bit_depth

            if bd == 8:
                def step():
                    pm.deblock_packed_batch_sharded_jit(mesh, self.buf, lm, cm, beta, tc, w=w, h=h)
            else:
                def step():
                    pm.deblock_packed_batch_sharded_jit(mesh, self.buf, lm, cm, beta, tc, w=w, h=h,
                                                        bit_depth=bd)
        self.step = step
        for i in range(int(self.mix["warmup_batches"])):
            self.buf.copy_(self.pool[i % dpb])
            self.step()
        sync(self.device)

    def window(self, seconds: float, tracer: Tracer, rec: Record):
        """The measured window, then (tracer on) the traced stretch."""
        cuda = self.device.type == "cuda"
        depth = int(self.mix["in_flight"])
        events = [torch.cuda.Event() for _ in range(depth)] if cuda else []
        taken, js = 0, []

        def batch(i, now):
            nonlocal taken
            if cuda and i >= depth:
                events[i % depth].synchronize()
            j = i % self.dpb
            with tracer.span("refresh"):
                self.buf.copy_(self.pool[j])
            with tracer.span("step_call"):
                a = time.perf_counter()
                self.step()
                dt = time.perf_counter() - a
            if taken < len(self.fractions) and now >= self.fractions[taken] * seconds:
                with tracer.span("capture"):
                    self.captures[taken].copy_(self.buf)
                js.append(j)
                taken += 1
            if cuda:
                events[i % depth].record()
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
