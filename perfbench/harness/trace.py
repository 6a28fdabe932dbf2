"""A traced sub-window: ``torch.profiler`` over whole steps of the window.

The profiler starts and stops between steps, after the device has
drained, so the device work inside the traced span is exactly the
work of the steps it covers. The harness's own spans (``perfbench.*``
record_function ranges around its calls into the program) name what
the host was doing while the device sat idle.
"""

from __future__ import annotations

import re
import time
from typing import Dict, Iterable, List, Tuple

import numpy as np

WINDOW_SPAN = "perfbench.traced"
#: idle gaps shorter than this are counted together, unnamed
SHORT_GAP_NS = 20_000


class Tracer:
    """Start with :meth:`start`, end with :meth:`stop` (both between
    steps), and once the measured window has closed :meth:`reduce` the
    trace; then read ``busy_s``, ``window_s``, :meth:`seconds` and
    :meth:`breakdown`."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.span = None
        self.busy_s = self.window_s = None
        self.done = False

    @property
    def active(self) -> bool:
        return self.prof is not None and not self.done

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.span = torch.profiler.record_function(WINDOW_SPAN)
        self.span.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        self.span.__exit__(None, None, None)
        self.prof.stop()
        self.done = True

    def reduce(self) -> None:
        """Read the stopped trace (outside the window: it takes the host
        a while)."""
        from torch.autograd import DeviceType

        if self.prof is None:
            return
        gpu, cpu, window = [], [], None
        for e in self.prof.profiler.kineto_results.events():
            s, d = e.start_ns(), e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                # a host span's image on the device's timeline is no work
                if not e.is_user_annotation():
                    gpu.append((s, s + d, e.name()))
            elif e.name() == WINDOW_SPAN:
                window = (s, s + d)
            else:
                cpu.append((s, s + d, e.name()))
        self.prof = None                    # free the profiler's buffers
        if window is None:
            window = (min((g[0] for g in gpu), default=0),
                      max((g[1] for g in gpu), default=0))
        self.window_s = (window[1] - window[0]) / 1e9
        self.gpu = gpu
        self.cpu = cpu
        self.window = window
        merged = _merge([(s, e) for s, e, _ in gpu])
        self.busy_s = sum(e - s for s, e in merged) / 1e9
        self.merged = merged

    def seconds(self, patterns: Iterable[str]) -> float:
        """Device seconds of the kernels whose names match any of
        ``patterns`` (regular expressions, searched)."""
        rx = [re.compile(p) for p in patterns]
        return sum(e - s for s, e, name in self.gpu
                   if any(r.search(name) for r in rx)) / 1e9

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        """The device operations that took most time, and the longest
        idle gaps summed by what the host was doing meanwhile (the
        innermost host span or operation open at the gap's middle)."""
        ops: Dict[str, int] = {}
        for s, e, name in self.gpu:
            ops[name] = ops.get(name, 0) + (e - s)
        device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        edges = [self.window[0]] + [x for iv in self.merged for x in iv] + [
            self.window[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        named: Dict[str, int] = {}
        long = [(s, e) for s, e in gaps if e - s >= SHORT_GAP_NS]
        short = sum(e - s for s, e in gaps if e - s < SHORT_GAP_NS)
        if short:
            named["between kernels (under 20 us each)"] = short
        if self.cpu and long:
            cs = np.array([c[0] for c in self.cpu], dtype=np.int64)
            ce = np.array([c[1] for c in self.cpu], dtype=np.int64)
            dur = ce - cs
            long.sort(key=lambda g: g[0] - g[1])
            for s, e in long[:4000]:
                mid = (s + e) // 2
                hit = np.nonzero((cs <= mid) & (ce >= mid))[0]
                name = ("host, outside any span" if hit.size == 0 else
                        self.cpu[hit[np.argmin(dur[hit])]][2])
                named[name] = named.get(name, 0) + (e - s)
        idle = sorted(named.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], v / 1e9] for n, v in device_ops],
                "idle_gaps": [[n[:160], v / 1e9] for n, v in idle]}


def span(name: str):
    """A harness span (``record_function``) on the traced timeline."""
    import torch

    return torch.profiler.record_function(name)


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]
