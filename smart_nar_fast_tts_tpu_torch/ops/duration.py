"""Duration targets from the alignment attention: frames counted per
phoneme, with no host sync.

- ``intended``: the head-reduced (B, T, L) map, argmax over valid phonemes
  of each frame below ``mel_len``; Σ durations = mel_len.
- ``soft``: each valid frame spreads one vote over the valid phonemes in
  proportion to its renormalised attention row; the cumulative sums are
  rounded, so Σ durations = mel_len exactly.
- ``buggy``: the reference's literal computation, which counts the argmax
  of every head over the first ``src_len`` frames against the unmasked text
  axis.

Every argmax takes the first index among equal maxima.
"""

from __future__ import annotations

import torch


def _head_reduce(attn: torch.Tensor, head_reduce: str) -> torch.Tensor:
    if head_reduce == "mean":
        return attn.mean(dim=1)
    if head_reduce == "first":
        return attn[:, 0]
    raise ValueError(f"unknown head reduction: {head_reduce}")


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Argmax over the last axis, the first index among equal maxima."""
    n = x.shape[-1]
    pos = torch.arange(n, device=x.device)
    hit = x == x.amax(dim=-1, keepdim=True)
    return torch.where(hit, pos, n).amin(dim=-1)


def _count(idx: torch.Tensor, frame_valid: torch.Tensor, L: int
           ) -> torch.Tensor:
    """(..., T) indices → (B, L) counts of the valid frames that pick each
    position, summed over every axis between B and L."""
    onehot = idx[..., None] == torch.arange(L, device=idx.device)
    counts = (onehot & frame_valid[..., None]).sum(dim=-2)
    while counts.dim() > 2:
        counts = counts.sum(dim=1)
    return counts


def durations_from_attention(attn: torch.Tensor, src_lens: torch.Tensor,
                             mel_lens: torch.Tensor, mode: str = "intended",
                             head_reduce: str = "first") -> torch.Tensor:
    """(B, H, T, L) attention → (B, L) int32 durations.  The caller
    detaches the attention: no gradient reaches the aligner from here."""
    B, H, T, L = attn.shape
    frames = torch.arange(T, device=attn.device)
    text_valid = torch.arange(L, device=attn.device)[None, :] \
        < src_lens[:, None]                                       # (B, L)
    frame_valid = frames[None, :] < mel_lens[:, None]             # (B, T)

    if mode == "intended":
        a = _head_reduce(attn, head_reduce)
        a = torch.where(text_valid[:, None, :], a, -torch.inf)
        return _count(_first_argmax(a), frame_valid, L).to(torch.int32)

    if mode == "soft":
        a = _head_reduce(attn, head_reduce)
        a = torch.where(text_valid[:, None, :], a, 0.0)
        a = a / torch.clamp(a.sum(dim=-1, keepdim=True), min=1e-9)
        soft = (a * frame_valid[:, :, None]).sum(dim=1)           # (B, L)
        r = torch.round(torch.cumsum(soft, dim=-1))
        counts = torch.diff(r, dim=-1, prepend=torch.zeros_like(r[:, :1]))
        return counts.to(torch.int32)

    if mode == "buggy":
        idx = _first_argmax(attn)                                 # (B, H, T)
        valid = (frames[None, :] < src_lens[:, None])[:, None, :]
        counts = _count(idx, valid.expand(B, H, T), L)
        return torch.where(text_valid, counts, 0).to(torch.int32)

    raise ValueError(f"unknown duration extraction mode: {mode}")


def durations_from_argmax(idx: torch.Tensor, src_lens: torch.Tensor,
                          mel_lens: torch.Tensor, L: int) -> torch.Tensor:
    """(B, T) per-frame argmax indices (the alignment kernel's) → (B, L)
    int32 frame counts, with the ``intended`` semantics: frames below
    ``mel_len`` count, padded phonemes get zero."""
    T = idx.shape[1]
    frame_valid = torch.arange(T, device=idx.device)[None, :] \
        < mel_lens[:, None]
    counts = _count(idx, frame_valid, L)
    text_valid = torch.arange(L, device=idx.device)[None, :] \
        < src_lens[:, None]
    return torch.where(text_valid, counts, 0).to(torch.int32)
