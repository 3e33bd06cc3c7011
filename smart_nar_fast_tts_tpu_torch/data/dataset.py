"""Synthesis-time items from a metadata file: ``TextOnlyDataset`` of
``smart_nar_fast_tts_tpu/data/dataset.py`` (reference ``TextDataset``,
``dataset.py:142-191``).  The training datasets and the bucket batcher wait
for the port's fit loop."""

from __future__ import annotations

import numpy as np

from ..config import PreprocessConfig
from ..text import text_to_sequence


def _parse_meta(path: str) -> list[tuple[str, str, str, str]]:
    """metadata lines ``name|speaker|{phones}|raw_text``
    (reference ``dataset.py:72-86``)."""
    rows = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip("\n")
            if not line:
                continue
            n, s, t, r = line.split("|")
            rows.append((n, s, t, r))
    return rows


class TextOnlyDataset:
    """Synthesis-time items (reference ``TextDataset``,
    ``dataset.py:142-191``)."""

    def __init__(self, metadata_path: str, cfg: PreprocessConfig):
        self.cfg = cfg
        self.rows = _parse_meta(metadata_path)

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, idx: int) -> dict:
        name, speaker, t, raw_text = self.rows[idx]
        return {
            "id": name,
            "speaker": int(speaker) if speaker.isdigit() else 0,
            "text": np.asarray(
                text_to_sequence(t, list(self.cfg.text_cleaners)), np.int32),
            "raw_text": raw_text,
        }
