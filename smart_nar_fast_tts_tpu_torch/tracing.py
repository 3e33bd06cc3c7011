"""Spans at the layer boundaries of serving, the acoustic model and the
train step, on the ``torch.profiler`` timeline.

``with span("stage_a"): ...`` opens the ``torch.profiler.record_function``
range ``tts.stage_a`` while a profiler records, and does nothing otherwise:
one check of the profiler's own state, then a shared null context, so the
spans cost nothing outside a profiling window and ``torch.export`` traces
none of them.  There is no switch of its own: the spans are on exactly
when someone profiles (a ``torch.profiler.profile`` block, the trainer's
``profile_start_step`` window, ``portbench/run.py --trace 1``).

A span's parent is the span that encloses it in time on the host.  The
kernels a span launches run later on the card, so a reader of the trace
matches a kernel to the span open when it was launched (its CUDA runtime
call, by correlation id), not when it ran.  ``args``, the call's number
and batch shape on ``tts.synthesize`` and ``tts.step``, is the range's
one input: torch's execution trace (``ExecutionTraceObserver``) keeps it
beside the range's parent; a kineto trace keeps the range and its times.

Spans (all under ``tts.``): ``synthesize`` ⊃ ``stage_a`` ⊃
``acoustic.text_encoder``, ``acoustic.variance`` ⊃ ``acoustic.upsample``,
``acoustic.decoder``, ``acoustic.postnet``; then ``bucket`` and
``stage_b``.  ``step`` ⊃ ``step.forward`` (⊃ the ``acoustic.*`` spans and
``acoustic.mel_encoder``), ``step.backward``, ``step.reduce``,
``step.optimizer``.  The vocoder GAN step: ``gan.input_mel``,
``gan.d_update``, ``gan.g_update``.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

PREFIX = "tts."

_OFF = contextlib.nullcontext()


def span(name: str, args: Optional[str] = None):
    """The range ``PREFIX + name`` while a profiler records, else a shared
    null context."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(PREFIX + name, args)


def call_args(call: int, batch: int, text_len: int, frame_cap: int) -> str:
    """``args`` of a call's outer span: its number and (B, L, frame cap)."""
    return f"call={call} B={batch} L={text_len} T={frame_cap}"
