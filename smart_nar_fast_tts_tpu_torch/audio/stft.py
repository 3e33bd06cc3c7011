"""STFT → log-mel feature extraction in PyTorch, and the inverse STFT and
Griffin-Lim, of ``smart_nar_fast_tts_tpu/audio/stft.py``.

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

:func:`istft_matmul` is the inverse STFT of the Vocos head: the inverse
real DFT as two real matrix products (no complex dtype), then the same
overlap-add as :func:`istft`.
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


# ---------------------------------------------------------------------------
# Inverse STFT and Griffin-Lim (the debug vocoder of the synthesize CLI;
# reference audio/stft.py:83-124, audio/audio_processing.py:66-81)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _window_sumsquare(cfg: MelSpectrogramConfig, n_frames: int) -> np.ndarray:
    """Sum-squared window envelope (reference audio/audio_processing.py:7-63):
    the overlap-add of win² at every hop, cached per (config, frames): a
    Vocos forward needs it at every call, and a streaming window at one
    length."""
    n = cfg.n_fft + cfg.hop_length * (n_frames - 1)
    win_sq = pad_center(hann_window(cfg.win_length) ** 2, cfg.n_fft)
    out = np.zeros(n, dtype=np.float64)
    for i in range(n_frames):
        s = i * cfg.hop_length
        out[s:min(n, s + cfg.n_fft)] += win_sq[:max(0, min(cfg.n_fft,
                                                           n - s))]
    return out.astype(np.float32)


def _overlap_add(frames: torch.Tensor, cfg: MelSpectrogramConfig
                 ) -> torch.Tensor:
    """(B, F, n_fft) time frames → (B, hop·(F−1)) signal: synthesis window,
    overlap-add at every hop (``F.fold``), window-sumsquare normalisation,
    centre trim."""
    window = torch.from_numpy(cfg.window).to(frames.device, frames.dtype)
    frames = frames * window
    b, f, n_fft = frames.shape
    hop = cfg.hop_length
    n = n_fft + hop * (f - 1)
    sig = F.fold(frames.transpose(1, 2), output_size=(1, n),
                 kernel_size=(1, n_fft), stride=(1, hop)).reshape(b, n)
    wss = torch.from_numpy(_window_sumsquare(cfg, f)).to(frames.device,
                                                         frames.dtype)
    sig = torch.where(wss > 1e-11, sig / torch.clamp(wss, min=1e-11), sig)
    pad = n_fft // 2
    return sig[:, pad:n - pad]


def istft(magnitude: torch.Tensor, phase: torch.Tensor,
          cfg: MelSpectrogramConfig) -> torch.Tensor:
    """(B, n_bins, F) magnitude and phase → (B, T) by windowed
    overlap-add."""
    spec = torch.polar(magnitude, phase)
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=cfg.n_fft, dim=-1)
    return _overlap_add(frames, cfg)


@functools.lru_cache(maxsize=8)
def _irdft_bases(n_fft: int, device: torch.device = torch.device("cpu")
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The inverse real DFT as two real (n_bins, n_fft) bases, ``x = Re(X)
    @ C + Im(X) @ S`` = ``irfft(X, n_fft)``: conjugate-symmetry weights
    count bins 0 and n_fft/2 once and the interior bins twice.  Built in
    float64, stored as f32 on ``device``, cached per (n_fft, device)."""
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[:, None]
    n = np.arange(n_fft, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * k * n / n_fft
    w = np.full((n_fft // 2 + 1, 1), 2.0)
    w[0, 0] = w[-1, 0] = 1.0
    c = (w * np.cos(ang) / n_fft).astype(np.float32)
    s = (-w * np.sin(ang) / n_fft).astype(np.float32)
    return (torch.from_numpy(c).to(device), torch.from_numpy(s).to(device))


def istft_matmul(magnitude: torch.Tensor, phase: torch.Tensor,
                 cfg: MelSpectrogramConfig,
                 bases: tuple[torch.Tensor, torch.Tensor] | None = None
                 ) -> torch.Tensor:
    """(B, n_bins, F) magnitude and phase → (B, hop·(F−1)): the inverse
    rDFT as two real matrix products (``bases``, default
    :func:`_irdft_bases` on the input's device), then :func:`istft`'s
    overlap-add.  The serving path of the Vocos head."""
    c, s = bases if bases is not None else _irdft_bases(
        cfg.n_fft, magnitude.device)
    re = (magnitude * torch.cos(phase)).transpose(-1, -2)   # (B, F, bins)
    im = (magnitude * torch.sin(phase)).transpose(-1, -2)
    return _overlap_add(re @ c + im @ s, cfg)


def griffin_lim(magnitude: torch.Tensor, cfg: MelSpectrogramConfig,
                n_iters: int = 30, generator: torch.Generator | None = None,
                phase: torch.Tensor | None = None) -> torch.Tensor:
    """Phase reconstruction by alternating projections (reference
    audio/audio_processing.py:66-81): (B, n_bins, F) magnitude → (B, T).

    The starting phase is ``phase`` when given (the tests pass the JAX
    package's draw), else uniform in [-π, π) from ``generator`` (a fresh
    one seeded 0 when None), on the magnitude's device.  Needs ≥ 4 frames,
    so that the reflect pad of the re-analysis framing is valid."""
    if magnitude.shape[-1] < 4:
        raise ValueError(
            f"griffin_lim needs ≥4 frames, got {magnitude.shape[-1]}")
    if phase is None:
        if generator is None:
            generator = torch.Generator(magnitude.device).manual_seed(0)
        phase = (torch.rand(magnitude.shape, generator=generator,
                            device=magnitude.device, dtype=magnitude.dtype)
                 * 2.0 - 1.0) * np.pi
    window = torch.from_numpy(cfg.window).to(magnitude.device,
                                             magnitude.dtype)
    for _ in range(n_iters):
        sig = istft(magnitude, phase, cfg)
        frames = frame_signal(sig, cfg.n_fft, cfg.hop_length)
        spec = torch.fft.rfft(frames * window, dim=-1)
        phase = torch.angle(spec).transpose(-1, -2)
    return istft(magnitude, phase, cfg)
