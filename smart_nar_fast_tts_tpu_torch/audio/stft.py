"""STFT → log-mel feature extraction in PyTorch: the forward half of
``smart_nar_fast_tts_tpu/audio/stft.py``.

- reflect-pad the waveform by ``n_fft//2`` on both sides,
- frame with hop ``hop_length`` and window length ``n_fft`` (the periodic
  Hann window of ``win_length`` zero-padded centred to ``n_fft``),
- magnitude of the windowed rFFT,
- mel = Slaney filterbank @ magnitude, log-compressed with
  ``log(clamp(x, 1e-5))``,
- energy = L2 norm of the magnitude spectrum per frame.

Frame count is ``T//hop + 1`` for input length T.  Everything is
differentiable (``torch.fft.rfft``): the generated branch of the vocoder's
mel loss takes its gradient through :func:`mel_spectrogram`.  It is also the
plain version of the ``fused_log_mel`` kernel (``kernels/stft.py``).  It
computes in the waveform's dtype: a float64 waveform gives the float64
features that measure how far an f32 run is from exact.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .mel import hann_window, mel_filterbank, pad_center


@dataclass(frozen=True)
class MelSpectrogramConfig:
    sampling_rate: int = 22050
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mels: int = 80
    mel_fmin: float = 0.0
    mel_fmax: float | None = 8000.0
    compression_clip: float = 1e-5

    @functools.cached_property
    def window(self) -> np.ndarray:
        return pad_center(hann_window(self.win_length), self.n_fft)

    @functools.cached_property
    def mel_basis(self) -> np.ndarray:
        return mel_filterbank(self.sampling_rate, self.n_fft, self.n_mels,
                              self.mel_fmin, self.mel_fmax)


def frame_signal(y: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(B, T) → (B, F, n_fft) frames of the reflect-padded signal."""
    pad = n_fft // 2
    y = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
    return y.unfold(-1, n_fft, hop)


def stft_magnitude(y: torch.Tensor, cfg: MelSpectrogramConfig
                   ) -> torch.Tensor:
    """(B, T) waveform in [-1, 1] → (B, n_fft//2+1, F) magnitude."""
    frames = frame_signal(y, cfg.n_fft, cfg.hop_length)
    window = torch.from_numpy(cfg.window).to(y.device, y.dtype)
    spec = torch.fft.rfft(frames * window, dim=-1)
    return spec.abs().transpose(-1, -2)


def mel_spectrogram(y: torch.Tensor, cfg: MelSpectrogramConfig
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T) waveform → (log-mel (B, n_mels, F), energy (B, F))."""
    mag = stft_magnitude(y, cfg)
    basis = torch.from_numpy(cfg.mel_basis).to(y.device, y.dtype)
    mel = torch.einsum("mf,bft->bmt", basis, mag)
    mel = torch.log(torch.clamp(mel, min=cfg.compression_clip))
    energy = torch.linalg.vector_norm(mag, dim=1)
    return mel, energy
