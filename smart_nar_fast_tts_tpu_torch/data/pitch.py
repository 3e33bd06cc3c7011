"""Frame-rate F0 estimation (replaces the PyWORLD ``dio``+``stonemask``
dependency, reference ``preprocessor/preprocessor.py:181-186``).

Normalized-autocorrelation pitch tracker with parabolic lag interpolation,
NCCF voicing decision, and median continuity smoothing.  Output contract
matches PyWORLD at the same frame period: ``len(wav)//hop + 1`` values in
Hz, exactly 0.0 where unvoiced — so downstream interpolation of unvoiced
gaps, phoneme averaging, and z-normalization (reference ``:197-227``) see
the same structure.  Fully vectorized host-side numpy (offline path).

The port's copy of ``smart_nar_fast_tts_tpu/data/pitch.py``: the plain
version of the native ``nccf`` tracker (``data/native_f0.py``), run when
``SMART_TTS_NATIVE_F0=off``.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import median_filter


def estimate_f0(wav: np.ndarray, sampling_rate: int, hop_length: int,
                f0_floor: float = 71.0, f0_ceil: float = 800.0,
                nccf_threshold: float = 0.30) -> np.ndarray:
    """(T,) float wav → (T//hop + 1,) F0 in Hz (0 = unvoiced)."""
    wav = np.asarray(wav, np.float64)
    n_frames = len(wav) // hop_length + 1
    lag_min = max(2, int(sampling_rate / f0_ceil))
    lag_max = int(np.ceil(sampling_rate / f0_floor))
    # window: ≥ 2 periods of f0_floor for a reliable lag_max correlation
    win = int(2 ** np.ceil(np.log2(2 * lag_max)))

    half = win // 2
    padded = np.pad(wav, (half, half + win))
    centers = np.arange(n_frames) * hop_length
    idx = centers[:, None] + np.arange(win)[None, :]
    frames = padded[idx]                               # (F, win)
    frames = frames - frames.mean(axis=1, keepdims=True)

    # autocorrelation via rFFT, normalized per lag (NCCF-style):
    # r[k] = sum x_t x_{t+k} / sqrt(e0 * e_k)
    nfft = 2 * win
    spec = np.fft.rfft(frames, nfft, axis=1)
    ac = np.fft.irfft(spec * np.conj(spec), nfft, axis=1)[:, :lag_max + 1]
    csum = np.cumsum(frames ** 2, axis=1)
    e_total = csum[:, -1]
    lags = np.arange(lag_max + 1)
    # energy of the k-shifted segment: sum_{t=k}^{win-1} x_t^2
    e_lag = e_total[:, None] - np.concatenate(
        [np.zeros((len(frames), 1)), csum[:, :-1]], axis=1)[:, lags]
    denom = np.sqrt(np.maximum(e_total[:, None] * e_lag, 1e-12))
    nccf = ac / denom                                  # (F, lag_max+1)

    band = nccf[:, lag_min:lag_max + 1]
    best = np.argmax(band, axis=1)
    peak = band[np.arange(len(band)), best]

    # parabolic interpolation around the winning lag
    k = best + lag_min
    k_c = np.clip(k, lag_min + 1, lag_max - 1)
    ym = nccf[np.arange(len(nccf)), k_c - 1]
    y0 = nccf[np.arange(len(nccf)), k_c]
    yp = nccf[np.arange(len(nccf)), k_c + 1]
    denom2 = ym - 2 * y0 + yp
    delta = np.where(np.abs(denom2) > 1e-12,
                     0.5 * (ym - yp) / np.where(np.abs(denom2) > 1e-12,
                                                denom2, 1.0), 0.0)
    delta = np.clip(delta, -0.5, 0.5)
    lag = np.where(k == k_c, k + delta, k.astype(np.float64))

    f0 = sampling_rate / lag
    voiced = (peak > nccf_threshold) & (f0 >= f0_floor) & (f0 <= f0_ceil)
    # silence gate: frames far below the utterance's active level are
    # unvoiced regardless of correlation shape
    frame_rms = np.sqrt(frames.var(axis=1) + 1e-12)
    voiced &= frame_rms > 0.03 * (np.max(frame_rms) + 1e-12)
    f0 = np.where(voiced, f0, 0.0)

    # continuity: median-filter voiced runs, kill single-frame islands
    vf = median_filter(f0, size=3, mode="nearest")
    f0 = np.where((f0 > 0) & (vf > 0), f0, np.where(vf > 0, vf, 0.0))
    isolated = ((f0 > 0)
                & (np.roll(f0, 1) == 0) & (np.roll(f0, -1) == 0))
    f0[isolated] = 0.0
    return f0[:n_frames]
