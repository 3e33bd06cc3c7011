"""Noam learning-rate schedule and global-norm clipping.

``lr = d_model^-0.5 · min(step^-0.5, step · warmup^-1.5)``, times
``anneal_rate`` once past each of ``anneal_steps``, at the 1-based step: the
first update uses ``noam(1)``.  The gradients' global norm is clipped at
``grad_clip_thresh`` (1.0) before Adam (``state.py``).
"""

from __future__ import annotations

import torch


def noam_schedule(step: int, d_model: int, warmup: int,
                  anneal_steps: tuple[int, ...] = (),
                  anneal_rate: float = 1.0) -> float:
    """The learning rate at 1-based ``step``."""
    step = max(float(step), 1.0)
    scale = min(step ** -0.5, step * float(warmup) ** -1.5)
    for s in anneal_steps:
        if step > s:
            scale *= anneal_rate
    return float(d_model) ** -0.5 * scale


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float
                        ) -> torch.Tensor:
    """Scale ``grads`` in place as optax's ``clip_by_global_norm``: left as
    they are when their global norm is below ``max_norm``, else ``g / ‖g‖ ·
    max_norm``.  (``torch.nn.utils.clip_grad_norm_`` divides by ‖g‖ + 1e-6
    instead.)  Returns the norm before clipping; no host sync."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    clip = norm >= max_norm
    torch._foreach_div_(grads, torch.where(clip, norm, 1.0))
    torch._foreach_mul_(grads, torch.where(clip, max_norm, 1.0))
    return norm

