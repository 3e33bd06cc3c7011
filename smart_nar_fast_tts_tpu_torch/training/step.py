"""Train and eval steps.

A train step is ``(state, batch, generator) → LossBreakdown``: forward and
backward over ``grad_acc_steps`` microbatches in turn, with the gradients
averaged, the BatchNorm running statistics carried from one microbatch to
the next and the loss terms averaged; then one clipped Noam-Adam update.
``generator`` (a ``torch.Generator`` on the state's device) draws the
dropout masks; ``None`` means no dropout.  PyTorch runs eagerly, so the JAX
package's ``make_multi_step`` (a ``lax.scan`` of steps in one dispatch) has
no counterpart here.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..data.batch import Batch
from ..models import FastSpeech2Loss, LossBreakdown, ModelOutput
from .state import TrainState


def _forward(model, loss_fn, batch: Batch,
             generator: Optional[torch.Generator]
             ) -> tuple[LossBreakdown, ModelOutput]:
    out = model(batch.texts, batch.src_lens, speakers=batch.speakers,
                mels=batch.mels, mel_lens=batch.mel_lens,
                p_targets=batch.pitch, e_targets=batch.energy,
                generator=generator)
    return loss_fn(out, batch.mels, batch.pitch, batch.energy), out


def _mean(losses: list[LossBreakdown]) -> LossBreakdown:
    return LossBreakdown(*(torch.stack([getattr(l, f).detach()
                                        for l in losses]).mean()
                           for f in LossBreakdown._fields))


def compute_gradients(state: TrainState, loss_fn: FastSpeech2Loss,
                      batch: Batch, grad_acc_steps: int = 1,
                      generator: Optional[torch.Generator] = None
                      ) -> tuple[LossBreakdown, list[ModelOutput]]:
    """Leave in each parameter's ``.grad`` the gradient of the total loss
    averaged over ``grad_acc_steps`` microbatches (train mode: batch
    statistics, running statistics updated).  Returns the averaged loss
    terms and each microbatch's output, detached."""
    model = state.model.train()
    for p in state.params:
        p.grad = None
    losses, outputs = [], []
    for mb in batch.to(state.device).split(grad_acc_steps):
        lb, out = _forward(model, loss_fn, mb, generator)
        lb.total.backward()
        losses.append(lb)
        outputs.append(ModelOutput(*(None if t is None else t.detach()
                                     for t in out)))
    if grad_acc_steps > 1:
        grads = [p.grad for p in state.params if p.grad is not None]
        torch._foreach_div_(grads, float(grad_acc_steps))
    return _mean(losses), outputs


def make_train_step(loss_fn: FastSpeech2Loss, grad_acc_steps: int = 1,
                    keep_outputs: bool = False) -> Callable:
    """``step(state, batch, generator=None) → LossBreakdown`` (with
    ``keep_outputs``, ``(LossBreakdown, [ModelOutput per microbatch])``),
    updating ``state`` in place."""

    def step(state: TrainState, batch: Batch,
             generator: Optional[torch.Generator] = None):
        losses, outputs = compute_gradients(state, loss_fn, batch,
                                            grad_acc_steps, generator)
        state.apply_gradients()
        return (losses, outputs) if keep_outputs else losses

    return step


def make_eval_step(loss_fn: FastSpeech2Loss) -> Callable:
    """``step(state, batch) → (LossBreakdown, weights)``: the loss terms in
    eval mode (running statistics, no dropout), and for each term the count
    of valid elements its masked mean was taken over (frames, phonemes or
    (frame, phoneme) pairs; 1 for the total), so that ``Σ loss·w / Σ w``
    over batches does not depend on how a split is cut into batches."""

    @torch.no_grad()
    def step(state: TrainState, batch: Batch):
        batch = batch.to(state.device)
        losses, _ = _forward(state.model.eval(), loss_fn, batch, None)
        src = batch.src_lens.float().sum()
        mel = batch.mel_lens.float().sum()
        pairs = (batch.src_lens.float() * batch.mel_lens.float()).sum()
        pv = src if loss_fn.pitch_level == "phoneme_level" else mel
        ev = src if loss_fn.energy_level == "phoneme_level" else mel
        weights = LossBreakdown(
            total=torch.ones((), device=src.device), mel=mel,
            postnet_mel=mel, pitch=pv, energy=ev, duration=src,
            attention=pairs)
        return losses, weights

    return step
