"""Waveform IO and resampling: ``load_wav`` and ``save_wav`` of
``smart_nar_fast_tts_tpu/data/wavio.py`` (reference
``preprocessor/preprocessor.py:171``, ``utils/tools.py:197-199``).

``load_wav`` returns float32 in [-1, 1] at the requested rate (polyphase
resampling, like librosa's default for integer rate ratios); the vocoder
training CLI reads its corpus with it.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

_PCM_SCALE = {np.dtype(np.int16): 32768.0,
              np.dtype(np.int32): 2147483648.0,
              np.dtype(np.uint8): 128.0}


def load_wav(path: str, sampling_rate: int | None = None
             ) -> tuple[np.ndarray, int]:
    """→ (mono float32 waveform in [-1, 1], rate): PCM int16, int32 and
    uint8 scaled to [-1, 1], float files as they are, channels averaged,
    resampled by the ratio's nearest fraction of denominator ≤ 1000."""
    sr, data = wavfile.read(path)
    if data.ndim > 1:
        data = data.mean(axis=1)
    if data.dtype in _PCM_SCALE:
        scale = _PCM_SCALE[data.dtype]
        offset = scale if data.dtype == np.dtype(np.uint8) else 0.0
        wav = (data.astype(np.float32) - offset) / scale
    else:
        wav = data.astype(np.float32)
    if sampling_rate is not None and sr != sampling_rate:
        frac = Fraction(sampling_rate, sr).limit_denominator(1000)
        wav = resample_poly(wav, frac.numerator, frac.denominator)
        wav = wav.astype(np.float32)
        sr = sampling_rate
    return wav, sr


def save_wav(path: str, wav: np.ndarray, sampling_rate: int,
             max_wav_value: float = 32768.0) -> None:
    """float wav (any scale) → int16 PCM file (reference
    ``utils/tools.py:197-199``: wavfile.write of int16)."""
    wav = np.asarray(wav, np.float32)
    peak = np.max(np.abs(wav)) or 1.0
    if peak > 1.0:                     # already in int16-ish scale
        wav = wav / peak
    wav = (wav * (max_wav_value - 1)).astype(np.int16)
    wavfile.write(path, sampling_rate, wav)
