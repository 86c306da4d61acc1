"""Reading ``torch.profiler`` over a traced window: the device's operations
with their times, the busy share, the idle gaps named by what the host was
doing, and the benchmark's own host spans.

The harness marks its steps with ``torch.profiler.record_function`` under
names that start with :data:`SPAN`; those CPU events share the device
events' clock, so a gap in the device's work is named by the innermost
span around its middle.
"""
from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

SPAN = "mpcbench."
WINDOW = SPAN + "window"


@dataclass
class Trace:
    """A traced window: device operations (name, start µs, duration µs),
    the harness's spans (name, start µs, end µs), the window's bounds (µs)
    and the ticks it held."""

    ops: List[Tuple[str, float, float]]
    spans: List[Tuple[str, float, float]]
    window: Tuple[float, float]
    ticks: int

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device's operations inside the window."""
        w0, w1 = self.window
        merged: List[List[float]] = []
        for _, start, dur in sorted(self.ops, key=lambda o: o[1]):
            a, b = max(start, w0), min(start + dur, w1)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def op_seconds(self, contains: Optional[str] = None) -> Tuple[float, int]:
        """(seconds, count) of the operations whose name holds ``contains``
        (all of them with None)."""
        sel = [d for n, _, d in self.ops if contains is None or contains in n]
        return sum(sel) * 1e-6, len(sel)

    def spans_named(self, name: str) -> List[Tuple[float, float]]:
        return [(a, b) for n, a, b in self.spans if n == name]

    def device_ops(self, top: int = 10) -> List[list]:
        """The operations that took most device time, by name, [name, s]."""
        by: Dict[str, float] = {}
        for n, _, d in self.ops:
            by[n] = by.get(n, 0.0) + d * 1e-6
        return [[n[:200], s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The device's idle time inside the window, summed by the span the
        host was in at each gap's middle (``host`` outside every span)."""
        w0, w1 = self.window
        busy = self.busy_intervals()
        edges = [w0] + [t for iv in busy for t in iv] + [w1]
        inner = [s for s in self.spans if s[0] != WINDOW]
        by: Dict[str, float] = {}
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            around = [s for s in inner if s[1] <= mid <= s[2]]
            name = min(around, key=lambda s: s[2] - s[1])[0] if around else "host"
            by[name] = by.get(name, 0.0) + (b - a) * 1e-6
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def ops_in(self, a: float, b: float) -> List[Tuple[str, float, float]]:
        """The operations that start inside [a, b]."""
        starts = [o[1] for o in self.ops]
        return self.ops[bisect.bisect_left(starts, a):bisect.bisect_right(starts, b)]


@contextlib.contextmanager
def span(name: str, on: bool):
    """``record_function(SPAN + name)`` where tracing is on."""
    if not on:
        yield
        return
    import torch

    with torch.profiler.record_function(SPAN + name):
        yield


def traced(fn, ticks: int) -> Trace:
    """Run ``fn()`` (which synchronizes the device before it returns) under
    the profiler, inside the span :data:`WINDOW`, and read the trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        with torch.profiler.record_function(WINDOW):
            fn()
    ops, spans = [], []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.name.startswith(SPAN):  # also on the device's timeline, as annotations
            if e.device_type == DeviceType.CPU:
                spans.append((e.name[len(SPAN):] if e.name != WINDOW else WINDOW, start, end))
        elif e.device_type == DeviceType.CUDA:
            ops.append((e.name, start, end - start))
    ops.sort(key=lambda o: o[1])
    windows = [(a, b) for n, a, b in spans if n == WINDOW]
    if not windows:
        raise RuntimeError("the profiler recorded no window span")
    return Trace(ops, spans, windows[0], ticks)
