"""Training losses: mel L1 before and after the PostNet, MSE on
log-duration, pitch and energy, and the guided-attention diagonal prior on
head 0 of every MelEncoder layer.  Every reduction is a masked mean over the
valid positions.

Under a data ``group`` (each rank holding its rows of the batch) each mean
divides the rank's numerator by the whole batch's count, so the ranks'
losses sum to the whole batch's and so do their gradients: the JAX step's
losses are per global batch, and a mean of per-rank means differs from it
wherever the ranks' valid counts differ.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import PreprocessConfig
from ..kernels.alignment import guided_weight
from ..ops.masks import masked_mean
from ..parallel import all_reduce
from .fastspeech2_align import ModelOutput


class LossBreakdown(NamedTuple):
    total: torch.Tensor
    mel: torch.Tensor
    postnet_mel: torch.Tensor
    pitch: torch.Tensor
    energy: torch.Tensor
    duration: torch.Tensor
    attention: torch.Tensor


def guided_attention_loss(attn: torch.Tensor, src_lens: torch.Tensor,
                          mel_lens: torch.Tensor, sigma: float = 0.2,
                          alpha: float = 10.0, group=None) -> torch.Tensor:
    """``alpha`` times the mean of ``W·attn`` over the valid (frame,
    phoneme) pairs, attn (B, T, L) one head of one layer.  The grid
    divisors are clamped at 1, so an item of length 0 gives a finite grid
    (it has no valid pair)."""
    B, T, L = attn.shape
    w, _ = guided_weight(T, L, torch.clamp(src_lens.float(), min=1.0),
                         torch.clamp(mel_lens.float(), min=1.0), sigma)
    t = torch.arange(T, device=attn.device)[None, :, None]
    n = torch.arange(L, device=attn.device)[None, None, :]
    valid = (t < mel_lens[:, None, None]) & (n < src_lens[:, None, None])
    return alpha * masked_mean(w * attn, valid, group)


class FastSpeech2Loss:
    """The seven loss terms of one batch."""

    def __init__(self, preprocess_cfg: PreprocessConfig = PreprocessConfig(),
                 guided_sigma: float = 0.2, guided_alpha: float = 10.0):
        self.pitch_level = preprocess_cfg.pitch_feature
        self.energy_level = preprocess_cfg.energy_feature
        self.sigma = guided_sigma
        self.alpha = guided_alpha

    def __call__(self, output: ModelOutput, mel_targets: torch.Tensor,
                 pitch_targets: torch.Tensor, energy_targets: torch.Tensor,
                 group=None) -> LossBreakdown:
        src_valid, mel_valid = output.src_valid, output.mel_valid
        # targets carry no gradient
        log_d_targets = torch.log(output.duration_targets.float() + 1.0)

        pv = src_valid if self.pitch_level == "phoneme_level" else mel_valid
        ev = src_valid if self.energy_level == "phoneme_level" else mel_valid
        pitch = masked_mean((output.pitch_prediction - pitch_targets) ** 2,
                            pv, group)
        energy = masked_mean(
            (output.energy_prediction - energy_targets) ** 2, ev, group)
        duration = masked_mean(
            (output.log_duration_prediction - log_d_targets) ** 2, src_valid,
            group)
        mel = masked_mean((output.mel - mel_targets).abs(),
                          mel_valid[:, :, None], group)
        postnet_mel = masked_mean((output.postnet_mel - mel_targets).abs(),
                                  mel_valid[:, :, None], group)

        attention = torch.zeros((), device=mel.device)
        if output.alignments is not None:
            for layer in output.alignments:
                attention = attention + guided_attention_loss(
                    layer[:, 0], output.src_lens, output.mel_lens,
                    self.sigma, self.alpha, group)
        elif output.guided_numerators is not None:
            # the alignment kernel already summed W·p per layer and item;
            # each layer's loss is its batch sum over the batch's pair
            # count, so the layers may be summed first
            pairs = all_reduce((output.src_lens.float()
                                * output.mel_lens.float()).sum(), group)
            attention = (self.alpha * output.guided_numerators.sum()
                         / torch.clamp(pairs, min=1.0))

        total = mel + postnet_mel + duration + pitch + energy + attention
        return LossBreakdown(total=total, mel=mel, postnet_mel=postnet_mel,
                             pitch=pitch, energy=energy, duration=duration,
                             attention=attention)
