"""LJSpeech corpus preparation, as ``smart_nar_fast_tts_tpu/data/
ljspeech.py``: ``metadata.csv`` → per-utterance cleaned ``.lab`` and
peak-normalised int16 ``.wav`` under ``data_path/<speaker>/``.

Parity target: reference ``preprocessor/ljspeech.py:11-40``
(``prepare_align`` — orphaned there, wired to the CLI here).
"""

from __future__ import annotations

import os

import numpy as np

from ..config import PreprocessConfig
from ..text import clean_text
from .wavio import load_wav, save_wav


def prepare_align(corpus_path: str, cfg: PreprocessConfig,
                  speaker: str = "LJSpeech") -> int:
    """Returns the number of utterances written; a metadata line whose wav
    is missing is skipped."""
    out_dir = os.path.join(cfg.data_path, speaker)
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    with open(os.path.join(corpus_path, "metadata.csv"),
              encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("|")
            base_name, text = parts[0], parts[2]
            text = clean_text(text, list(cfg.text_cleaners))
            wav_path = os.path.join(corpus_path, "wavs",
                                    f"{base_name}.wav")
            if not os.path.exists(wav_path):
                continue
            wav, _ = load_wav(wav_path, cfg.audio.sampling_rate)
            wav = wav / np.max(np.abs(wav))
            save_wav(os.path.join(out_dir, f"{base_name}.wav"), wav,
                     cfg.audio.sampling_rate, cfg.audio.max_wav_value)
            with open(os.path.join(out_dir, f"{base_name}.lab"), "w") as g:
                g.write(text)
            count += 1
    return count
