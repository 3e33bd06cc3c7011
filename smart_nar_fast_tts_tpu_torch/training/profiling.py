"""Profiling and step-rate observability, as
``smart_nar_fast_tts_tpu/training/profiling.py``.

- ``StepProfiler``: one ``torch.profiler`` trace window during training:
  armed at a configured step, stopped ``num_steps`` later, exported as a
  Chrome trace (``chrome://tracing``, Perfetto) under
  ``<log_dir>/profile/``.
- ``Throughput``: wall-clock steps/s and mel frames/s between log points,
  logged beside the losses; frames/s per chip divides by the ranks.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch


class StepProfiler:
    """Traces steps ``start_step + 1 … start_step + num_steps`` (those that
    run after ``step(start_step)`` is reported); ``start_step = 0``
    disables.  ``cuda`` adds the CUDA activities (kernels, copies) to the
    CPU ones."""

    def __init__(self, log_dir: str, start_step: int = 0,
                 num_steps: int = 5, cuda: bool = False):
        self.log_dir = os.path.join(log_dir, "profile")
        self.start_step = start_step
        self.num_steps = num_steps
        self.cuda = cuda
        self.trace_path: Optional[str] = None
        self._prof = None

    def step(self, step: int) -> None:
        if self.start_step <= 0:
            return
        if self._prof is None and step == self.start_step:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
        elif self._prof is not None and (
                step >= self.start_step + self.num_steps):
            self._stop(step)

    def _stop(self, step: int) -> None:
        prof, self._prof = self._prof, None
        if self.cuda:
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        self.trace_path = os.path.join(
            self.log_dir, f"trace_steps_{self.start_step + 1}-{step}.json")
        prof.export_chrome_trace(self.trace_path)

    def close(self, step: Optional[int] = None) -> None:
        """Stop a window that ran past the end of training."""
        if self._prof is not None:
            self._stop(self.start_step + self.num_steps
                       if step is None else step)


class Throughput:
    """Rolling steps/s + mel frames/s between log points."""

    def __init__(self, n_chips: int = 1) -> None:
        self.n_chips = n_chips
        self._t0: Optional[float] = None
        self._steps = 0
        self._frames = 0

    def update(self, n_frames: int) -> None:
        if self._t0 is None:
            self._t0 = time.perf_counter()   # first update excluded (warm-up)
            return
        self._steps += 1
        self._frames += n_frames

    def snapshot(self) -> Optional[dict]:
        """Rates since the last snapshot; None until 2+ updates seen.  The
        tags are the JAX writer's (one chip)."""
        if self._t0 is None or self._steps == 0:
            return None
        dt = time.perf_counter() - self._t0
        out = {"steps_per_sec": self._steps / dt,
               "mel_frames_per_sec_per_chip": (self._frames / dt
                                               / self.n_chips)}
        self._t0 = time.perf_counter()
        self._steps = 0
        self._frames = 0
        return out
