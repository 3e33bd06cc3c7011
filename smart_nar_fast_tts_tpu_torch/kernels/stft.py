"""Fused STFT → log-mel: the CUDA kernel ``csrc/log_mel.cu`` and its plain
version, :func:`~..audio.stft.mel_spectrogram`.

The kernel replaces the TPU kernel ``fused_log_mel`` of
``smart_nar_fast_tts_tpu/ops/pallas/stft.py``: the DFT as two products
against the Hann-windowed cos and −sin bases, then magnitude, the mel
product and ``log(max(·, clip))``, and the frame energy, in f32 FMA.  The
plain version computes the magnitude by ``torch.fft.rfft`` instead, so the
two agree to f32 rounding of the DFT sums, not bit for bit.

Forward only, as the TPU kernel (no ``custom_vjp``): both call sites of the
GAN step take no gradient through it.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..audio.stft import MelSpectrogramConfig, mel_spectrogram
from . import _build

# pointers and the stream as c_void_p: ctypes would pass a bare int as 32 bits
_SIGNATURES = {
    "log_mel_forward": (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
    "log_mel_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def dft_mel_constants(cfg: MelSpectrogramConfig
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(windowed cos basis, windowed −sin basis, melᵀ) as f32 numpy arrays
    of shapes (n_fft, n_bins), (n_fft, n_bins), (n_bins, n_mels): the bases
    in float64, then cast, as the TPU kernel's ``_dft_mel_constants``."""
    n = cfg.n_fft
    k = np.arange(n)[:, None] * np.arange(n // 2 + 1)[None, :]
    ang = 2.0 * np.pi * k / n
    win = np.asarray(cfg.window, np.float64)[:, None]
    cos_b = (np.cos(ang) * win).astype(np.float32)
    sin_b = (-np.sin(ang) * win).astype(np.float32)
    mel_t = np.ascontiguousarray(np.asarray(cfg.mel_basis, np.float32).T)
    return cos_b, sin_b, mel_t


@functools.lru_cache(maxsize=8)
def _constants_on(cfg: MelSpectrogramConfig, device: torch.device
                  ) -> tuple[torch.Tensor, ...]:
    return tuple(torch.from_numpy(a).to(device)
                 for a in dft_mel_constants(cfg))


def num_frames(n_samples: int, cfg: MelSpectrogramConfig) -> int:
    """Frames of a centred STFT of ``n_samples`` samples."""
    return 1 + (n_samples + 2 * (cfg.n_fft // 2) - cfg.n_fft) \
        // cfg.hop_length


def fused_log_mel(y: torch.Tensor, cfg: MelSpectrogramConfig
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S) waveform → (log-mel (B, n_mels, F), energy (B, F)), as
    :func:`~..audio.stft.mel_spectrogram`.

    A CPU tensor takes that plain version.  A CUDA tensor launches the
    kernel: y contiguous float32, n_fft a multiple of 4, S > n_fft/2.  No
    gradient flows through the kernel."""
    if y.device.type == "cpu":
        return mel_spectrogram(y, cfg)
    if y.device.type != "cuda":
        raise ValueError(f"fused_log_mel: unsupported device {y.device}")
    if y.ndim != 2 or y.dtype != torch.float32 or not y.is_contiguous():
        raise ValueError("fused_log_mel: y must be contiguous (B, S) "
                         f"float32, got {tuple(y.shape)} {y.dtype}")
    B, S = y.shape
    if cfg.n_fft % 4 or S <= cfg.n_fft // 2:
        raise ValueError(f"fused_log_mel: n_fft {cfg.n_fft} must be a "
                         f"multiple of 4 with n_fft/2 below S = {S}")
    F = num_frames(S, cfg)
    cos_b, sin_b, mel_t = _constants_on(cfg, y.device)
    mel = torch.empty((B, cfg.n_mels, F), dtype=torch.float32,
                      device=y.device)
    energy = torch.empty((B, F), dtype=torch.float32, device=y.device)
    lib = _build.load("log_mel", _SIGNATURES)
    with torch.cuda.device(y.device):
        status = lib.log_mel_forward(
            y.data_ptr(), cos_b.data_ptr(), sin_b.data_ptr(),
            mel_t.data_ptr(), mel.data_ptr(), energy.data_ptr(), B, S, F,
            cfg.n_fft, cfg.hop_length, cfg.n_mels,
            float(cfg.compression_clip),
            torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError("fused_log_mel: launch failed: "
                           + lib.log_mel_error_string(status).decode())
    fused_log_mel.launches += 1
    return mel, energy


fused_log_mel.launches = 0
