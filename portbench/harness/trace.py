"""The traced window: ``torch.profiler`` over the window, reduced to the
device's kernels, its busy time (the union of the kernels' intervals),
idle gaps named after the harness span the host was in, and the
harness's own spans.

Spans are ``torch.profiler.record_function`` ranges named ``pb.<layer>``
that the harness opens around its calls into the program, only in a traced
run; ``pb.window`` spans the whole window and sets its bounds in the
trace's clock.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

PREFIX = "pb."
WINDOW = PREFIX + "window"


def union(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals, lo, hi) -> list[tuple[float, float]]:
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


@dataclass
class Trace:
    """A traced window, times in seconds from the window's start."""

    window_s: float
    kernels: list[tuple[str, float, float]]       # (name, start, end)
    spans: list[tuple[str, float, float]] = field(default_factory=list)

    @property
    def busy_s(self) -> float:
        return union((s, e) for _, s, e in self.kernels)

    def kernel_seconds(self, patterns) -> float:
        """Device seconds of the kernels whose name holds a pattern."""
        return sum(e - s for n, s, e in self.kernels
                   if any(p in n for p in patterns))

    def kernel_count(self, patterns) -> int:
        return sum(1 for n, _, _ in self.kernels
                   if any(p in n for p in patterns))

    def device_ops(self, top: int = 10) -> list[list]:
        by: dict[str, float] = {}
        for n, s, e in self.kernels:
            by[n] = by.get(n, 0.0) + (e - s)
        return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])
                [:top]]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """Idle seconds by the innermost harness span open on the host at
        each gap's middle ("outside" when none is)."""
        by: dict[str, float] = {}
        spans = sorted(self.spans, key=lambda x: x[2] - x[1])
        for s, e in gaps([(a, b) for _, a, b in self.kernels], 0.0,
                         self.window_s):
            mid = 0.5 * (s + e)
            name = next((n for n, a, b in spans if a <= mid <= b), "outside")
            by[name] = by.get(name, 0.0) + (e - s)
        return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])
                [:top]]


class Tracer:
    """``with tracer.window(): ...`` profiles when ``on``; ``span(name)``
    marks a harness span (a no-op when off)."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(PREFIX + name)

    @contextlib.contextmanager
    def window(self):
        if not self.on:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(WINDOW):
                yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        self.prof = prof

    def reduce(self) -> Trace:
        """The window from the profiler's raw events (building its event
        tree would take minutes over a window of thousands of batches)."""
        events = self.prof.profiler.kineto_results.events()
        win = next(e for e in events if e.name() == WINDOW
                   and e.device_type().name == "CPU")
        lo, hi = win.start_ns(), win.end_ns()
        kernels, spans = [], []
        for e in events:
            s, t, dev = e.start_ns(), e.end_ns(), e.device_type().name
            if dev == "CUDA" and not e.is_user_annotation():
                s, t = max(s, lo), min(t, hi)
                if t > s:
                    kernels.append((e.name(), (s - lo) / 1e9, (t - lo) / 1e9))
            elif (dev == "CPU" and e.name().startswith(PREFIX)
                  and e.name() != WINDOW):
                spans.append((e.name()[len(PREFIX):], (s - lo) / 1e9,
                              (t - lo) / 1e9))
        return Trace((hi - lo) / 1e9, kernels, spans)
