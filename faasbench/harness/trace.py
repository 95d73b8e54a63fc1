"""The traced slice of a run: ``torch.profiler`` over the window's first
seconds (started before the window opens: its start takes seconds),
reduced to the device's busy time, its operations by time, its idle gaps
by what the host was doing, and every kernel's device time and launches.

Busy time is the union of the device intervals the profiler records
(kernels, copies, sets), clipped to the traced slice; an idle gap is a
stretch of the slice with none, named after the innermost host span
(``backend.Spans`` under ``record_function``) that covers its middle.
"""
from __future__ import annotations

import heapq
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

TRACE_SECONDS = 3.0       # the slice: the window's first seconds
SPAN_PREFIXES = ("backend.", "batcher.", "des.")   # backend.Spans


class Trace:
    def __init__(self, spans):
        self.spans = spans
        self.prof = None
        self.running = False
        self.t0 = self.t1 = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.running = self.spans.profiling = True
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.running = self.spans.profiling = False
        self.prof.stop()

    def reduce(self, kernel: Optional[str] = None) -> dict:
        """``busy_s``, ``window_s``, the top operations and idle gaps, the
        summed device seconds and launches of kernels whose name holds
        ``kernel``, and ``kernels``: every device operation's full name
        with its summed seconds and its launches."""
        cuda = torch.autograd.DeviceType.CUDA
        dev, host = [], []
        for ev in self.prof.events():
            tr = ev.time_range
            ours = ev.name.startswith(SPAN_PREFIXES)
            if ev.device_type == cuda and not ours:
                dev.append((tr.start, tr.end, ev.name))
            elif ours and ev.device_type != cuda:
                # a span's range also shows on the device's timeline as an
                # annotation: no work of its own, so it is left out there
                host.append((tr.start, tr.end, ev.name))
        window_s = self.t1 - self.t0
        out = {"window_s": window_s, "busy_s": 0.0, "device_ops": [],
               "idle_gaps": [], "kernel_s": None, "kernel_launches": 0,
               "kernels": {}}
        if not dev:
            return out
        dev.sort()
        # the slice on the profiler's clock: from its first host span or
        # device interval to the end of the last, padded to the wall length
        lo = min([d[0] for d in dev] + [h[0] for h in host])
        hi = max(lo + window_s * 1e6, max(d[1] for d in dev))
        busy, gaps = 0.0, []
        cur_s, cur_e = lo, lo
        for s, e, _ in dev:
            if s > cur_e:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
                cur_s = s
            cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        if hi > cur_e:
            gaps.append((cur_e, hi))
        by_op: Dict[str, float] = defaultdict(float)
        launches: Dict[str, int] = defaultdict(int)
        k_s, k_n = 0.0, 0
        for s, e, name in dev:
            by_op[name] += (e - s) * 1e-6
            launches[name] += 1
            if kernel and kernel in name:
                k_s += (e - s) * 1e-6
                k_n += 1
        by_gap: Dict[str, float] = defaultdict(float)
        host.sort()
        heap, i = [], 0          # spans begun by the gap's middle, latest first
        for g0, g1 in gaps:      # in order, so their middles rise
            mid = 0.5 * (g0 + g1)
            while i < len(host) and host[i][0] <= mid:
                heapq.heappush(heap, (-host[i][0], host[i][1], host[i][2]))
                i += 1
            while heap and heap[0][1] < mid:
                heapq.heappop(heap)
            name = heap[0][2] if heap else "outside any span"
            by_gap[name] += (g1 - g0) * 1e-6
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        out.update(
            busy_s=busy * 1e-6,
            device_ops=[[n[:120], s] for n, s in top],
            idle_gaps=sorted(([n, s] for n, s in by_gap.items()),
                             key=lambda r: -r[1])[:10],
            kernel_s=k_s if k_n else None, kernel_launches=k_n,
            kernels={n: (s, launches[n]) for n, s in by_op.items()})
        return out
