"""HiFi-GAN training objectives, as ``smart_nar_fast_tts_tpu/vocoder/
losses.py``: least-squares adversarial terms, feature matching over every
discriminator feature map (×2 by the caller) and log-mel L1 between the
generated and the real waveform (×45 by the caller)."""

from __future__ import annotations

import torch

from ..audio.stft import MelSpectrogramConfig, mel_spectrogram
from ..kernels import fused_log_mel
from .discriminators import DiscOutput

FM_WEIGHT = 2.0
MEL_WEIGHT = 45.0


def discriminator_loss(real: DiscOutput, fake: DiscOutput) -> torch.Tensor:
    """Σ_k mean((1 − D_k(y))²) + mean(D_k(ŷ)²)."""
    loss = 0.0
    for (r, _), (f, _) in zip(real, fake):
        loss = loss + torch.mean((1.0 - r) ** 2) + torch.mean(f ** 2)
    return loss


def generator_adversarial_loss(fake: DiscOutput) -> torch.Tensor:
    """Σ_k mean((1 − D_k(ŷ))²)."""
    loss = 0.0
    for f, _ in fake:
        loss = loss + torch.mean((1.0 - f) ** 2)
    return loss


def feature_matching_loss(real: DiscOutput, fake: DiscOutput
                          ) -> torch.Tensor:
    """Σ_k Σ_l mean(|feat_real − feat_fake|)."""
    loss = 0.0
    for (_, rf), (_, ff) in zip(real, fake):
        for r, f in zip(rf, ff):
            loss = loss + torch.mean(torch.abs(r - f))
    return loss


def mel_l1_loss(wav_fake: torch.Tensor, wav_real: torch.Tensor,
                cfg: MelSpectrogramConfig) -> torch.Tensor:
    """L1 between the log-mels of the generated and the real waveform.  The
    generated branch goes through the differentiable
    :func:`~..audio.stft.mel_spectrogram`; the real branch, which takes no
    gradient, through the ``fused_log_mel`` kernel."""
    mel_f, _ = mel_spectrogram(wav_fake, cfg)
    with torch.no_grad():
        mel_r, _ = fused_log_mel(wav_real.contiguous(), cfg)
    return torch.mean(torch.abs(mel_f - mel_r))
