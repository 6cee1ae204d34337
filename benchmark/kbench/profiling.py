"""The device trace of a run's traced window, and what is read from it.

torch.profiler (CUPTI) records every operation the card ran in the window:
kernels, copies and sets.  Busy time is the union of their intervals, so
two overlapping operations count once; the idle share is one less busy
time over the window.  The benchmark's own spans (``kbench.*``, around its
calls into the scheduler's stages) name what the host was doing in each
idle gap.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

SPAN_PREFIX = "kbench."


def union_length(intervals: Sequence[Tuple[float, float]]) -> float:
    """Total length covered by the intervals (start, end)."""
    return sum(e - s for s, e in merged(intervals))


def merged(intervals: Sequence[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_gaps(busy: Sequence[Tuple[float, float]], start: float, end: float
              ) -> List[Tuple[float, float]]:
    """The stretches of [start, end] that no busy interval covers."""
    gaps, t = [], start
    for s, e in merged(busy):
        if s > t:
            gaps.append((t, min(s, end)))
        t = max(t, e)
    if end > t:
        gaps.append((t, end))
    return [(s, e) for s, e in gaps if e > s]


@dataclass
class Trace:
    """A traced window: device operations and host spans, in
    microseconds on the profiler's clock, and the window's wall seconds."""
    window_s: float
    device: List[Tuple[str, float, float]] = field(default_factory=list)
    host: List[Tuple[str, float, float]] = field(default_factory=list)
    rounds: Optional[int] = None
    cycles: Optional[int] = None
    # device operations counted, by the profiler's activity type
    device_kinds: dict = field(default_factory=dict)

    @property
    def busy_s(self) -> float:
        return union_length([(s, e) for _, s, e in self.device]) / 1e6

    def kernel_s(self, needle: str) -> float:
        """Seconds of the device operations whose name holds needle."""
        return sum(e - s for n, s, e in self.device if needle in n) / 1e6

    def top_ops(self, k: int = 10) -> List[list]:
        by = {}
        for n, s, e in self.device:
            by[n] = by.get(n, 0.0) + (e - s) / 1e6
        return [[n[:120], v] for n, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def gaps(self, k: int = 10) -> List[list]:
        """The k longest idle gaps, each named by the innermost benchmark
        span around its midpoint and the innermost host operation there."""
        win = [(s, e) for n, s, e in self.host if n == SPAN_PREFIX + "window"]
        if not win:
            return []
        start, end = win[0]
        gaps = sorted(idle_gaps([(s, e) for _, s, e in self.device],
                                start, end), key=lambda g: g[0] - g[1])[:k]
        out = []
        for s, e in gaps:
            mid = (s + e) / 2
            around = [(he - hs, n) for n, hs, he in self.host
                      if hs <= mid <= he]
            spans = sorted(x for x in around if x[1].startswith(SPAN_PREFIX)
                           and x[1] != SPAN_PREFIX + "window")
            ops = sorted(x for x in around
                         if not x[1].startswith(SPAN_PREFIX))
            name = spans[0][1] if spans else "kbench.window"
            if ops:
                name += " / " + ops[0][1][:60]
            out.append([name, (e - s) / 1e6])
        return out


def _event_fields(e):
    """(name, start_us, end_us, kind, on_device) of a kineto event.  A
    span (record_function) shows on the device's timeline too, as an
    annotation: it is no operation of the card."""
    import torch
    if hasattr(e, "start_ns"):
        s, d = e.start_ns() / 1e3, e.duration_ns() / 1e3
    else:
        s, d = float(e.start_us()), float(e.duration_us())
    kind = e.activity_type() if hasattr(e, "activity_type") else ""
    annotation = ("annotation" in kind
                  or (hasattr(e, "is_user_annotation")
                      and e.is_user_annotation())
                  or e.name().startswith(SPAN_PREFIX))
    on_device = (e.device_type() == torch.autograd.DeviceType.CUDA
                 and not annotation)
    return e.name(), s, s + d, kind, on_device


class Profiler:
    """torch.profiler over a window that opens at start() and closes at
    stop(), each after a device synchronize."""

    def __init__(self, cuda: bool = True):
        from torch.profiler import ProfilerActivity, profile
        self.cuda = cuda
        self.prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else []))
        self._span = None
        self.t0 = self.window_s = None

    def _sync(self) -> None:
        if self.cuda:
            import torch
            torch.cuda.synchronize()

    def start(self) -> None:
        import torch
        self._sync()
        self.prof.start()
        self._span = torch.profiler.record_function(SPAN_PREFIX + "window")
        self._span.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self._sync()
        self.window_s = time.perf_counter() - self.t0
        self._span.__exit__(None, None, None)
        self.prof.stop()

    def trace(self) -> Trace:
        import torch
        tr = Trace(window_s=self.window_s)
        for e in self.prof.profiler.kineto_results.events():
            name, s, end, kind, dev = _event_fields(e)
            if dev:
                tr.device.append((name, s, end))
                tr.device_kinds[kind] = tr.device_kinds.get(kind, 0) + 1
            elif e.device_type() != torch.autograd.DeviceType.CUDA:
                tr.host.append((name, s, end))
        return tr


def span(name: str, fn):
    """fn, run inside a benchmark span of the given name."""
    import torch

    def wrapped(*a, **kw):
        with torch.profiler.record_function(SPAN_PREFIX + name):
            return fn(*a, **kw)
    return wrapped
