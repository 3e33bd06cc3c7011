"""MFA alignment → per-phoneme frame durations: the port's copy of
``smart_nar_fast_tts_tpu/data/alignment.py``.

Parity target: reference ``preprocessor/preprocessor.py:249-287``
(``get_alignment``): leading/trailing silences trimmed, interior silences
kept, durations from hop-rounded boundary frames.
"""

from __future__ import annotations

import numpy as np

from .textgrid import Tier

SILENCE_PHONES = ("sil", "sp", "spn")


def get_alignment(tier: Tier, sampling_rate: int, hop_length: int
                  ) -> tuple[list[str], list[int], float, float]:
    """Returns (phones, durations, start_time, end_time).

    ``durations[i]`` is ``round(e_i·sr/hop) − round(s_i·sr/hop)`` frames
    (reference ``:276-281``); phones and durations are truncated after the
    last non-silence phone, and leading silences are skipped entirely.
    """
    phones: list[str] = []
    durations: list[int] = []
    start_time = 0.0
    end_time = 0.0
    end_idx = 0
    for iv in tier._objects:
        s, e, p = iv.start_time, iv.end_time, iv.text
        if not phones:
            if p in SILENCE_PHONES:
                continue           # trim leading silence
            start_time = s
        phones.append(p)
        if p not in SILENCE_PHONES:
            end_time = e
            end_idx = len(phones)
        durations.append(int(
            np.round(e * sampling_rate / hop_length)
            - np.round(s * sampling_rate / hop_length)))
    return phones[:end_idx], durations[:end_idx], start_time, end_time
