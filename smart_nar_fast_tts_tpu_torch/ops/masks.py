"""Validity masks: ``True`` marks a real (non-padded) position."""

from __future__ import annotations

import torch


def length_to_valid(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) int lengths → (B, max_len) bool, True where position < length."""
    pos = torch.arange(max_len, device=lengths.device)
    return pos[None, :] < lengths[:, None]
