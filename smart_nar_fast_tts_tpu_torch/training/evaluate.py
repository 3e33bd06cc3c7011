"""Validation, as ``smart_nar_fast_tts_tpu/training/evaluate.py`` (the
reference's missing ``evaluate.py`` rebuilt from its call site,
``train.py:142``): run the whole val split, average the 7 losses, log
them, return the formatted message.

Averaging is element-weighted: each loss term is ``Σ_b loss_b · w_b /
Σ_b w_b``, where ``w_b`` is that term's count of valid elements in batch
``b`` (:func:`..training.step.make_eval_step`), so the result is the
corpus-level mean, whatever the batches, up to the padded-compute boundary
of the variance predictors' convolutions (``tests/test_trainer.py``'s
partition-invariance test states it).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np

from .logging import MetricWriter, format_losses
from .state import TrainState


def weighted_average(eval_step: Callable, state: TrainState,
                     batches: Iterable):
    """Element-weighted LossBreakdown (Python floats) over ``batches`` (an
    iterable of ``(Batch, ids, raw_texts)`` or bare ``Batch``), or None
    when empty.  ``eval_step(state, batch) → (LossBreakdown, weights)``."""
    sums = wsums = losses = None
    for item in batches:
        batch = item[0] if isinstance(item, tuple) and not hasattr(
            item, "_fields") else item
        losses, weights = eval_step(state, batch)
        vals = np.asarray([float(x) for x in losses])
        w = np.asarray([float(x) for x in weights])
        sums = vals * w if sums is None else sums + vals * w
        wsums = w if wsums is None else wsums + w
    if sums is None:
        return None
    mean = sums / np.maximum(wsums, 1.0)
    mean[0] = mean[1:].sum()        # total = recombined weighted term means
    return type(losses)(*[float(v) for v in mean])


def evaluate(eval_step: Callable, state: TrainState,
             batches: Iterable, step: int, total_step: int,
             writer: Optional[MetricWriter] = None) -> str:
    """Run the val split, log the weighted-average losses, return the
    reference-format message."""
    losses = weighted_average(eval_step, state, batches)
    if losses is not None and writer is not None:
        writer.scalars(step, losses)
    return validation_message(step, total_step, losses)


def validation_message(step: int, total_step: int, losses) -> str:
    if losses is None:
        return "Validation: no batches"
    return format_losses(step, total_step, losses).replace(
        f"Step {step}/{total_step}", f"Validation Step {step}")
