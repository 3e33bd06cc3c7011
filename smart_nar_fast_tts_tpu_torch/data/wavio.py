"""Waveform output: ``save_wav`` of ``smart_nar_fast_tts_tpu/data/wavio.py``
(reference ``utils/tools.py:197-199``).  Reading and resampling wavs waits
for the port's preprocessing."""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile


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
