"""The program's own spans read against the device trace, on the trace's one
clock.

The port opens ``torch.profiler.record_function`` ranges named ``tts.*``
at its layer boundaries whenever a profiler records
(``smart_nar_fast_tts_tpu_torch/tracing.py``): ``tts.synthesize``,
``tts.stage_a`` and its ``tts.acoustic.*`` sub-layers, ``tts.bucket``,
``tts.stage_b``, ``tts.step`` and its phases.  Here each device kernel (or
copy) carries its **host launch time**, the start of the CUDA API call
with the kernel's correlation id, and belongs to the innermost
program span open on the host when it was launched, not when it ran: the
card lags the host.  Spans are matched by time, not by thread: autograd
launches the backward's kernels from its own thread while the main thread
sits inside ``tts.step.backward``.

A reader gets the reduced ``trace.Trace``, which keeps neither the
program's spans nor launch times.  ``of(run)`` reduces the traced window's
raw events again, once per profiler, from the ``trace.Tracer`` whose
window made ``run.trace``, found on the stack of the call that reads the
metrics.  It returns None when that window holds no program span or no
device kernel (the program before its spans, a run on the CPU).
"""

from __future__ import annotations

import bisect
import sys
import weakref
from dataclasses import dataclass, field
from typing import Optional

from .trace import WINDOW, Tracer, gaps

PROGRAM = "tts."
# the host calls that launch device work: the CUDA API's cudaLaunchKernel,
# cudaMemcpyAsync, cuLaunchKernel, ...
LAUNCH_CALL = "cu"


def merged(intervals) -> list[tuple[float, float]]:
    """Sorted, disjoint (start, end) intervals covering the same time."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def innermost(spans, points) -> list[Optional[int]]:
    """For each time in ``points``, the index in ``spans`` ((name, start,
    end) triples) of the shortest span holding it (ends included), or
    None."""
    ev = [(a, 0, i) for i, (_, a, _) in enumerate(spans)]
    ev += [(t, 1, j) for j, t in enumerate(points)]
    ev += [(b, 2, i) for i, (_, _, b) in enumerate(spans)]
    ev.sort()
    out: list[Optional[int]] = [None] * len(points)
    open_: list[int] = []
    for _, kind, i in ev:
        if kind == 0:
            open_.append(i)
        elif kind == 2:
            open_.remove(i)
        elif open_:
            out[i] = min(open_, key=lambda k: spans[k][2] - spans[k][1])
    return out


@dataclass
class ProgramTrace:
    """A traced window, times in seconds from its start: the device's
    kernels with their launch times (None where the trace holds no launch
    call for one), the program's spans and the harness's."""

    window_s: float
    kernels: list[tuple[str, float, float, Optional[float]]]
    spans: list[tuple[str, float, float]]
    harness: list[tuple[str, float, float]] = field(default_factory=list)

    def calls(self, name: str) -> list[tuple[float, float]]:
        """The host intervals of the program span ``name``, in order."""
        return sorted((a, b) for n, a, b in self.spans if n == name)

    def launched_in(self, name: str) -> list[tuple[str, float, float]]:
        """The kernels launched inside any ``name`` span (its sub-spans
        included), as (name, start, end)."""
        calls = self.calls(name)
        starts = [a for a, _ in calls]
        out = []
        for k, s, e, t in self.kernels:
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= calls[i][1]:
                out.append((k, s, e))
        return out

    def idle_s(self, name: str) -> list[float]:
        """Per ``name`` span: its host interval less the union of the
        device's kernel intervals within it."""
        busy = merged((s, e) for _, s, e, _ in self.kernels)
        ends = [e for _, e in busy]
        out = []
        for a, b in self.calls(name):
            covered = 0.0
            i = bisect.bisect_right(ends, a)
            while i < len(busy) and busy[i][0] < b:
                covered += min(b, busy[i][1]) - max(a, busy[i][0])
                i += 1
            out.append((b - a) - covered)
        return out

    def mean_idle_ms(self, name: str) -> Optional[float]:
        idle = self.idle_s(name)
        return 1e3 * sum(idle) / len(idle) if idle else None

    def launches_per_call(self, name: str) -> Optional[float]:
        n = len(self.calls(name))
        return len(self.launched_in(name)) / n if n else None

    def device_ms_per(self, name: str, per: str) -> Optional[float]:
        """Device ms of the kernels launched inside ``name`` spans, over the
        number of ``per`` spans (a step's phase, per step)."""
        n = len(self.calls(per))
        if not n:
            return None
        return 1e3 * sum(e - s for _, s, e in self.launched_in(name)) / n

    def idle_gaps(self, top: Optional[int] = None) -> list[list]:
        """Idle seconds by the innermost span of either kind open on the
        host at each gap's middle: program spans by their ``tts.`` names,
        harness spans by theirs, "outside" when none is.  On a window with
        no program span, ``Trace.idle_gaps``'s attribution."""
        both = self.spans + self.harness
        idle = gaps([(s, e) for _, s, e, _ in self.kernels], 0.0,
                    self.window_s)
        at = innermost(both, [0.5 * (s + e) for s, e in idle])
        by: dict[str, float] = {}
        for (s, e), i in zip(idle, at):
            name = "outside" if i is None else both[i][0]
            by[name] = by.get(name, 0.0) + (e - s)
        out = [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])]
        return out if top is None else out[:top]

    def by_span(self) -> dict[str, dict[str, float]]:
        """Per program span name, a call's mean: host ms, idle ms, launches
        and their device ms, each kernel counted to the innermost span open
        at its launch (so a parent's launches exclude its sub-spans')."""
        launched = [k for k in self.kernels if k[3] is not None]
        owner = innermost(self.spans, [k[3] for k in launched])
        counts: dict[str, list[float]] = {}
        for (_, s, e, _), i in zip(launched, owner):
            if i is not None:
                c = counts.setdefault(self.spans[i][0], [0, 0.0])
                c[0] += 1
                c[1] += e - s
        out = {}
        for name in sorted({n for n, _, _ in self.spans}):
            calls = self.calls(name)
            n = len(calls)
            c = counts.get(name, [0, 0.0])
            out[name] = {"calls": n,
                         "host_ms": 1e3 * sum(b - a for a, b in calls) / n,
                         "idle_ms": self.mean_idle_ms(name),
                         "launches": c[0] / n,
                         "device_ms": 1e3 * c[1] / n}
        return out


def reduce(events, harness=()) -> ProgramTrace:
    """The window of raw profiler events (``kineto_results.events()``):
    kernels clipped to the window as ``Tracer.reduce`` clips them, each with
    its launch time, and the program's spans."""
    win = next(e for e in events if e.name() == WINDOW
               and e.device_type().name == "CPU")
    lo, hi = win.start_ns(), win.end_ns()
    launch: dict[int, int] = {}
    raw, spans = [], []
    for e in events:
        dev, name = e.device_type().name, e.name()
        if dev == "CUDA" and not e.is_user_annotation():
            s, t = max(e.start_ns(), lo), min(e.end_ns(), hi)
            if t > s:
                raw.append((name, s, t, e.correlation_id()))
        elif dev != "CPU":
            continue
        elif name.startswith(PROGRAM):
            spans.append((name, (e.start_ns() - lo) / 1e9,
                          (e.end_ns() - lo) / 1e9))
        elif name.startswith(LAUNCH_CALL) and not e.is_user_annotation():
            cid, s = e.correlation_id(), e.start_ns()
            launch[cid] = min(s, launch.get(cid, s))
    kernels = [(n, (s - lo) / 1e9, (t - lo) / 1e9,
                None if c not in launch else (launch[c] - lo) / 1e9)
               for n, s, t, c in raw]
    return ProgramTrace((hi - lo) / 1e9, kernels, spans, list(harness))


_views: "weakref.WeakKeyDictionary[object, ProgramTrace]" = \
    weakref.WeakKeyDictionary()


def _tracer_of(trace) -> Optional[Tracer]:
    """The ``Tracer`` beside ``trace`` in a frame of the current stack (the
    harness's call that reduced it and now reads the metrics)."""
    f = sys._getframe(1)
    while f is not None:
        values = list(f.f_locals.values())
        if any(v is trace for v in values):
            for v in values:
                if isinstance(v, Tracer) and v.prof is not None:
                    return v
        f = f.f_back
    return None


def of(run) -> Optional[ProgramTrace]:
    """The program's spans against the device trace of ``run`` (a
    ``cell.MetricInput``), or None without program spans or kernels."""
    tracer = _tracer_of(run.trace)
    if tracer is None:
        return None
    view = _views.get(tracer.prof)
    if view is None:
        view = reduce(tracer.prof.profiler.kineto_results.events(),
                      run.trace.spans)
        _views[tracer.prof] = view
    if not view.spans or not view.kernels:
        return None
    return view
