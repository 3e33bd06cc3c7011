"""Mel filterbank and window construction (host-side numpy constants).

The port's own copy of ``smart_nar_fast_tts_tpu/audio/mel.py``, line for
line: the Slaney mel scale, triangular filters with Slaney area
normalisation (``librosa.filters.mel`` defaults), the periodic Hann window
(``scipy.signal.get_window('hann', n)``) and librosa's ``pad_center``.
"""

from __future__ import annotations

import numpy as np

# Slaney mel scale constants: linear below 1 kHz (200/3 Hz per mel),
# logarithmic above (27 mels per factor of 6.4).
_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP           # 15.0
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(freq):
    """Slaney (a.k.a. 'htk=False') Hz → mel."""
    freq = np.asanyarray(freq, dtype=np.float64)
    mel = freq / _F_SP
    log_region = freq >= _MIN_LOG_HZ
    mel = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(freq, _MIN_LOG_HZ) / _MIN_LOG_HZ)
        / _LOGSTEP,
        mel,
    )
    return mel


def mel_to_hz(mel):
    """Slaney mel → Hz."""
    mel = np.asanyarray(mel, dtype=np.float64)
    freq = _F_SP * mel
    log_region = mel >= _MIN_LOG_MEL
    freq = np.where(
        log_region,
        _MIN_LOG_HZ * np.exp(_LOGSTEP * (mel - _MIN_LOG_MEL)),
        freq,
    )
    return freq


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: float | None) -> np.ndarray:
    """(n_mels, 1 + n_fft//2) float32 triangular Slaney filterbank.

    Matches ``librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax)`` with
    defaults htk=False, norm='slaney' as used at reference
    ``audio/stft.py:145-147``.
    """
    if fmax is None:
        fmax = sr / 2.0
    n_bins = 1 + n_fft // 2
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax),
                                    n_mels + 2))
    # Triangles: rise from mel_pts[i] to mel_pts[i+1], fall to mel_pts[i+2].
    fdiff = np.diff(mel_pts)                              # (n_mels+1,)
    ramps = mel_pts[:, None] - fft_freqs[None, :]          # (n_mels+2, n_bins)
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney area normalization: each filter integrates to ~constant energy.
    enorm = 2.0 / (mel_pts[2:] - mel_pts[:-2])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def hann_window(win_length: int, periodic: bool = True) -> np.ndarray:
    """Periodic ('fftbins') Hann window, as scipy get_window('hann', n)."""
    n = win_length if periodic else win_length - 1
    k = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)).astype(np.float32)


def pad_center(window: np.ndarray, size: int) -> np.ndarray:
    """Zero-pad a window symmetrically to ``size`` (librosa pad_center)."""
    lpad = (size - len(window)) // 2
    out = np.zeros(size, dtype=window.dtype)
    out[lpad:lpad + len(window)] = window
    return out
