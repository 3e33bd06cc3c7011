"""Validity masks: ``True`` marks a real (non-padded) position."""

from __future__ import annotations

import torch
import torch.distributed as dist


def length_to_valid(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) int lengths → (B, max_len) bool, True where position < length."""
    pos = torch.arange(max_len, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def masked_mean(x: torch.Tensor, valid: torch.Tensor,
                group=None) -> torch.Tensor:
    """Mean of ``x`` over the positions where ``valid`` (broadcastable to
    x) is True; 0 when none is.  Under a data ``group`` (each rank holding
    its rows) the count is the whole batch's: summed over the group, the
    ranks' results make the whole batch's mean."""
    valid = torch.broadcast_to(valid, x.shape)
    count = valid.sum()
    if group is not None:
        dist.all_reduce(count, group=group)
    denom = torch.clamp(count, min=1)
    return torch.where(valid, x, 0.0).sum() / denom
