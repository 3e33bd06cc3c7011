"""Train state: the model, its optimizer and the count of updates applied."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import OptimizerConfig
from ..device import resolve_device
from ..models import FastSpeech2Align
from .schedule import clip_by_global_norm, noam_schedule


@dataclass
class TrainState:
    model: FastSpeech2Align
    optimizer: torch.optim.Optimizer
    cfg: OptimizerConfig
    device: torch.device
    step: int = 0                     # updates applied

    @property
    def params(self) -> list[torch.nn.Parameter]:
        return self.optimizer.param_groups[0]["params"]

    def lr(self, step: int) -> float:
        """The Noam learning rate of 1-based update ``step``."""
        return noam_schedule(step, self.model.cfg.transformer.encoder_hidden,
                             self.cfg.warm_up_step, self.cfg.anneal_steps,
                             self.cfg.anneal_rate)

    def apply_gradients(self) -> torch.Tensor:
        """One update from the parameters' ``.grad`` (a parameter with none
        counts as a zero gradient): clip by global norm, then Adam at the
        Noam rate of the next step.  Returns the norm before clipping."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = clip_by_global_norm([p.grad for p in self.params],
                                   self.cfg.grad_clip_thresh)
        self.optimizer.param_groups[0]["lr"] = self.lr(self.step + 1)
        self.optimizer.step()
        self.step += 1
        return norm


def create_train_state(model: FastSpeech2Align,
                       cfg: OptimizerConfig = OptimizerConfig(),
                       device: str | torch.device | None = None
                       ) -> TrainState:
    """Move ``model`` to ``device`` (CUDA unless the caller asks for the
    CPU; raises without a card) in train mode, with a fresh Adam.  AdamW's
    decoupled decay is optax's ``scale_by_adam → add_decayed_weights →
    scale_by_learning_rate``; :meth:`TrainState.apply_gradients` sets the
    learning rate before each update."""
    device = resolve_device(device)
    model = model.to(device).train()
    optimizer = torch.optim.AdamW(model.parameters(), lr=0.0, betas=cfg.betas,
                                  eps=cfg.eps, weight_decay=cfg.weight_decay)
    return TrainState(model=model, optimizer=optimizer, cfg=cfg,
                      device=device)
