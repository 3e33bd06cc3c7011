"""Online data pipeline: metadata → padded static-shape batches, as
``smart_nar_fast_tts_tpu/data/dataset.py`` (reference ``dataset.py:12-191``).

``AcousticDataset`` reads the preprocessed corpus (phone ids + mel, pitch
and energy ``.npy`` features), ``TextOnlyDataset`` a synthesis metadata
file.  ``BucketBatcher`` pads each batch to fixed ``(text_cap, mel_cap)``
length buckets and walks the JAX package's schedule draw for draw: the same
``default_rng((seed, epoch))``, the same shuffle per bucket, permutation of
batches and ``skip``, so a checkpoint's ``(epoch, in_epoch)`` position means
the same batch in either package.  Batches are the port's
:class:`~.batch.Batch` of CPU tensors; the trainer moves them to its device.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np
import torch

from ..config import PreprocessConfig
from ..text import text_to_sequence
from .batch import Batch


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


class AcousticDataset:
    """Training/eval items: phone ids + mel/pitch/energy features
    (reference ``dataset.py:12-118``)."""

    def __init__(self, metadata_filename: str, cfg: PreprocessConfig):
        self.cfg = cfg
        root = cfg.preprocessed_path
        self.rows = _parse_meta(os.path.join(root, metadata_filename))
        with open(os.path.join(root, "speakers.json")) as f:
            self.speaker_map = json.load(f)
        self.root = root
        self._text_cache: dict[int, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.rows)

    def feature_path(self, idx: int, kind: str) -> str:
        name, speaker, _, _ = self.rows[idx]
        return os.path.join(self.root, kind, f"{speaker}-{kind}-{name}.npy")

    def text_ids(self, idx: int) -> np.ndarray:
        if idx not in self._text_cache:
            _, _, t, _ = self.rows[idx]
            self._text_cache[idx] = np.asarray(
                text_to_sequence(t, list(self.cfg.text_cleaners)), np.int32)
        return self._text_cache[idx]

    def __getitem__(self, idx: int) -> dict:
        name, speaker, _, raw_text = self.rows[idx]
        feats = {kind: np.load(self.feature_path(idx, kind)).astype(
            np.float32) for kind in ("mel", "pitch", "energy")}
        return {"id": name, "speaker": self.speaker_map[speaker],
                "text": self.text_ids(idx), "raw_text": raw_text, **feats}


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


@dataclass(frozen=True)
class BucketSpec:
    text_cap: int
    mel_cap: int


class BucketBatcher:
    """Deterministic length-bucketed batching with static shapes.

    Each item goes to the smallest ``(text_cap, mel_cap)`` pair that fits
    (items beyond the largest caps are truncated to them, as the reference
    truncates decoder sequences to ``max_seq_len``,
    ``transformer/Models.py:159,227``).  ``batches(epoch)`` yields
    ``(Batch, ids, raw_texts)`` with every array padded to the bucket caps.
    """

    def __init__(self, dataset: AcousticDataset, batch_size: int,
                 text_buckets: Sequence[int], mel_buckets: Sequence[int],
                 seed: int = 1234,
                 host_id: int = 0, num_hosts: int = 1,
                 pad_short: str = "repeat"):
        if batch_size % num_hosts:
            raise ValueError(f"batch {batch_size} does not split over "
                             f"{num_hosts} hosts")
        if pad_short not in ("repeat", "mask"):
            raise ValueError(f"pad_short {pad_short!r}")
        self.ds = dataset
        self.global_batch = batch_size
        self.local_batch = batch_size // num_hosts
        self.host_id = host_id
        self.text_buckets = tuple(sorted(text_buckets))
        self.mel_buckets = tuple(sorted(mel_buckets))
        self.seed = seed
        self.pad_short = pad_short
        self._assignments = self._assign()

    def _item_lengths(self, idx: int) -> tuple[int, int]:
        # the mel's frame count from the .npy header alone
        mel = np.load(self.ds.feature_path(idx, "mel"), mmap_mode="r")
        return len(self.ds.text_ids(idx)), mel.shape[0]

    def _bucket_of(self, text_len: int, mel_len: int) -> BucketSpec:
        t_cap = next((b for b in self.text_buckets if text_len <= b),
                     self.text_buckets[-1])
        m_cap = next((b for b in self.mel_buckets if mel_len <= b),
                     self.mel_buckets[-1])
        return BucketSpec(t_cap, m_cap)

    def _assign(self) -> dict[BucketSpec, list[int]]:
        buckets: dict[BucketSpec, list[int]] = {}
        for idx in range(len(self.ds)):
            tl, ml = self._item_lengths(idx)
            buckets.setdefault(self._bucket_of(tl, ml), []).append(idx)
        return buckets

    def steps_per_epoch(self) -> int:
        total = 0
        for items in self._assignments.values():
            n, r = divmod(len(items), self.global_batch)
            total += n + (r > 0)
        return total

    def batches(self, epoch: int = 0, skip: int = 0) -> Iterator[tuple]:
        """The epoch's schedule, which depends only on (seed, epoch);
        ``skip`` resumes mid-epoch after a checkpoint restore."""
        rng = np.random.default_rng((self.seed, epoch))
        schedule: list[tuple[BucketSpec, np.ndarray]] = []
        for spec in sorted(self._assignments,
                           key=lambda s: (s.text_cap, s.mel_cap)):
            items = np.asarray(self._assignments[spec])
            rng.shuffle(items)
            for i in range(0, len(items), self.global_batch):
                schedule.append((spec, items[i:i + self.global_batch]))
        order = rng.permutation(len(schedule))
        for k in order[skip:]:
            spec, chunk = schedule[k]
            yield self._collate(spec, chunk)

    def _collate(self, spec: BucketSpec, chunk: np.ndarray):
        # Short batches: ``repeat`` tiles real items (training: identical
        # shapes, repeats only perturb batch statistics under mean losses);
        # ``mask`` fills the tail with fully-masked slots (src_len =
        # mel_len = 0, excluded from every masked loss) so that eval counts
        # each item once, as ``training/evaluate.py``'s weighting needs.
        if len(chunk) < self.global_batch:
            if self.pad_short == "repeat":
                reps = -(-self.global_batch // len(chunk))
                chunk = np.tile(chunk, reps)[:self.global_batch]
            else:
                pad = np.full(self.global_batch - len(chunk), -1,
                              chunk.dtype)
                chunk = np.concatenate([chunk, pad])
        lo = self.host_id * self.local_batch
        chunk = chunk[lo:lo + self.local_batch]

        B, L, T = self.local_batch, spec.text_cap, spec.mel_cap
        n_mels = self.ds.cfg.audio.n_mels
        texts = np.zeros((B, L), np.int32)
        src_lens = np.zeros((B,), np.int32)
        mels = np.zeros((B, T, n_mels), np.float32)
        mel_lens = np.zeros((B,), np.int32)
        frame_pitch = self.ds.cfg.pitch_feature == "frame_level"
        frame_energy = self.ds.cfg.energy_feature == "frame_level"
        pitch = np.zeros((B, T if frame_pitch else L), np.float32)
        energy = np.zeros((B, T if frame_energy else L), np.float32)
        speakers = np.zeros((B,), np.int32)
        ids, raws = [], []
        for j, idx in enumerate(chunk):
            if idx < 0:             # masked padding slot (pad_short="mask")
                ids.append("")
                raws.append("")
                continue
            item = self.ds[int(idx)]
            t = item["text"][:L]
            m = item["mel"][:T]
            texts[j, :len(t)] = t
            src_lens[j] = len(t)
            mels[j, :len(m)] = m
            mel_lens[j] = len(m)
            p = item["pitch"][:pitch.shape[1]]
            e = item["energy"][:energy.shape[1]]
            pitch[j, :len(p)] = p
            energy[j, :len(e)] = e
            speakers[j] = item["speaker"]
            ids.append(item["id"])
            raws.append(item["raw_text"])
        batch = Batch(*(torch.from_numpy(a) for a in (
            texts, src_lens, mels, mel_lens, pitch, energy, speakers)))
        return batch, ids, raws
