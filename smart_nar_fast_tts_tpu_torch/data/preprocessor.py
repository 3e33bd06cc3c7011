"""Offline corpus → feature-store preprocessing, as
``smart_nar_fast_tts_tpu/data/preprocessor.py`` (reference
``preprocessor/preprocessor.py:16-309``).

The on-disk contract is the JAX package's, byte for byte in layout: per
utterance ``mel/ pitch/ energy/`` ``.npy`` files named
``{speaker}-{kind}-{basename}.npy`` (mel stored time-major ``(T, n_mels)``),
``speakers.json``, ``stats.json`` with ``{pitch,energy}: [min, max, mean,
std]``, and the shuffled ``train.txt`` / ``val.txt`` metadata
(``name|speaker|{phones}|raw_text``), so either package trains on a store
the other wrote.

The mel and energy come from the port's ``audio.stft.mel_spectrogram`` of
the unpadded ``(1, T)`` waveform on the preprocessor's device (cuFFT on a
card).  The JAX package calls ``mel_spectrogram_bucketed``, its TPU lowering
of the same function (one XLA program per length bucket, identical
numbers); neither calls the log-mel kernel.  F0 is the host's native
DIO + StoneMask (``data/native_f0.py``).
"""

from __future__ import annotations

import json
import os
import random

import numpy as np
import torch

from ..audio.stft import MelSpectrogramConfig, mel_spectrogram
from ..config import PreprocessConfig
from ..device import resolve_device
from . import native_f0
from .alignment import get_alignment
from .textgrid import read_textgrid
from .wavio import load_wav


class RunningScaler:
    """Streaming mean/std — sklearn ``StandardScaler.partial_fit`` math
    (sum/sumsq accumulation, population std)."""

    def __init__(self):
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0

    def partial_fit(self, values: np.ndarray) -> None:
        values = np.asarray(values, np.float64).reshape(-1)
        if values.size == 0:
            return
        n_b, mean_b = values.size, values.mean()
        m2_b = ((values - mean_b) ** 2).sum()
        n = self.n + n_b
        delta = mean_b - self.mean
        self.m2 += m2_b + delta ** 2 * self.n * n_b / n
        self.mean += delta * n_b / n
        self.n = n

    @property
    def scale(self) -> float:
        return float(np.sqrt(self.m2 / self.n)) if self.n else 1.0


def remove_outlier(values: np.ndarray) -> np.ndarray:
    """IQR-1.5 filter (reference ``preprocessor.py:289-297``)."""
    values = np.asarray(values)
    p25, p75 = np.percentile(values, 25), np.percentile(values, 75)
    lower = p25 - 1.5 * (p75 - p25)
    upper = p75 + 1.5 * (p75 - p25)
    return values[(values > lower) & (values < upper)]


class Preprocessor:
    """``device`` goes through ``resolve_device``: CUDA unless the caller
    asks for another, raising without a card."""

    def __init__(self, cfg: PreprocessConfig,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        a = cfg.audio
        self.sr = a.sampling_rate
        self.hop = a.hop_length
        self.mel_cfg = MelSpectrogramConfig(
            sampling_rate=a.sampling_rate, n_fft=a.n_fft,
            hop_length=a.hop_length, win_length=a.win_length,
            n_mels=a.n_mels, mel_fmin=a.mel_fmin, mel_fmax=a.mel_fmax)
        self.in_dir = cfg.data_path
        self.out_dir = cfg.preprocessed_path

    # ---- per-utterance --------------------------------------------------
    def mel_energy(self, wav: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(T,) waveform → (log-mel (n_mels, T//hop + 1), energy), float32
        numpy, computed on the preprocessor's device."""
        y = torch.from_numpy(np.asarray(wav, np.float32)).to(self.device)
        with torch.no_grad():
            mel, energy = mel_spectrogram(y[None], self.mel_cfg)
        return mel[0].cpu().numpy(), energy[0].cpu().numpy()

    def process_utterance(self, speaker: str, basename: str):
        wav_path = os.path.join(self.in_dir, speaker, f"{basename}.wav")
        text_path = os.path.join(self.in_dir, speaker, f"{basename}.lab")
        tg_path = os.path.join(self.out_dir, "TextGrid", speaker,
                               f"{basename}.TextGrid")

        textgrid = read_textgrid(tg_path)
        phones, durations, start, end = get_alignment(
            textgrid.get_tier_by_name("phones"), self.sr, self.hop)
        text = "{" + " ".join(phones) + "}"
        if start >= end:
            return None
        total = sum(durations)

        wav, _ = load_wav(wav_path, self.sr)
        wav = wav[int(self.sr * start):int(self.sr * end)]

        with open(text_path) as f:
            raw_text = f.readline().strip("\n")

        pitch = native_f0.estimate_f0_native(wav, self.sr, self.hop)[:total]
        if np.sum(pitch != 0) <= 1:
            return None

        mel, energy = self.mel_energy(wav)
        mel = mel[:, :total]                           # (n_mels, T)
        energy = energy[:total]

        if self.cfg.pitch_feature == "phoneme_level":
            pitch = _phoneme_average(pitch, durations, interpolate=True)
        if self.cfg.energy_feature == "phoneme_level":
            energy = _phoneme_average(energy, durations, interpolate=False)

        for kind in ("pitch", "energy", "mel"):
            os.makedirs(os.path.join(self.out_dir, kind), exist_ok=True)
        np.save(os.path.join(self.out_dir, "pitch",
                             f"{speaker}-pitch-{basename}.npy"), pitch)
        np.save(os.path.join(self.out_dir, "energy",
                             f"{speaker}-energy-{basename}.npy"), energy)
        np.save(os.path.join(self.out_dir, "mel",
                             f"{speaker}-mel-{basename}.npy"),
                np.ascontiguousarray(mel.T))             # C order, as JAX's

        return ("|".join([basename, speaker, text, raw_text]),
                remove_outlier(pitch), remove_outlier(energy), mel.shape[1])

    # ---- corpus ---------------------------------------------------------
    def _tasks(self) -> tuple[dict[str, int], list[tuple[str, str]]]:
        speakers: dict[str, int] = {}
        tasks: list[tuple[str, str]] = []
        for i, speaker in enumerate(sorted(os.listdir(self.in_dir))):
            spk_dir = os.path.join(self.in_dir, speaker)
            if not os.path.isdir(spk_dir):
                continue
            speakers[speaker] = i
            for wav_name in sorted(os.listdir(spk_dir)):
                if not wav_name.endswith(".wav"):
                    continue
                basename = wav_name[:-4]
                tg_path = os.path.join(self.out_dir, "TextGrid", speaker,
                                       f"{basename}.TextGrid")
                if os.path.exists(tg_path):
                    tasks.append((speaker, basename))
        return speakers, tasks

    def build_from_path(self, seed: int = 1234,
                        num_workers: int = 1) -> list[str]:
        """Offline pass over the corpus.  ``num_workers > 1`` fans
        utterances out over a ``spawn`` process pool whose workers run on
        the CPU (the reference is strictly serial, ``preprocessor.py:
        66-89``); the corpus-wide statistics are accumulated in task order
        either way, so parallel and serial runs write the same
        ``stats.json``."""
        out: list[str] = []
        n_frames = 0
        pitch_scaler, energy_scaler = RunningScaler(), RunningScaler()
        speakers, tasks = self._tasks()

        if num_workers > 1:
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor
            if not native_f0.native_off():
                native_f0.load()           # build once, before the workers
            ctx = mp.get_context("spawn")
            with ProcessPoolExecutor(
                    max_workers=num_workers, mp_context=ctx,
                    initializer=_init_worker,
                    initargs=(self.cfg, num_workers)) as ex:
                results = list(ex.map(_run_task, tasks, chunksize=4))
        else:
            results = [self.process_utterance(s, b) for s, b in tasks]

        for ret in results:
            if ret is None:
                continue
            info, pitch, energy, n = ret
            out.append(info)
            pitch_scaler.partial_fit(pitch)
            energy_scaler.partial_fit(energy)
            n_frames += n

        pitch_mean = pitch_scaler.mean if self.cfg.pitch_normalization else 0.0
        pitch_std = pitch_scaler.scale if self.cfg.pitch_normalization else 1.0
        energy_mean = (energy_scaler.mean
                       if self.cfg.energy_normalization else 0.0)
        energy_std = (energy_scaler.scale
                      if self.cfg.energy_normalization else 1.0)

        pitch_min, pitch_max = self._normalize_dir(
            os.path.join(self.out_dir, "pitch"), pitch_mean, pitch_std)
        energy_min, energy_max = self._normalize_dir(
            os.path.join(self.out_dir, "energy"), energy_mean, energy_std)

        with open(os.path.join(self.out_dir, "speakers.json"), "w") as f:
            json.dump(speakers, f)
        with open(os.path.join(self.out_dir, "stats.json"), "w") as f:
            json.dump({
                "pitch": [float(pitch_min), float(pitch_max),
                          float(pitch_mean), float(pitch_std)],
                "energy": [float(energy_min), float(energy_max),
                           float(energy_mean), float(energy_std)],
            }, f)

        rng = random.Random(seed)
        rng.shuffle(out)
        val_size = min(self.cfg.val_size, max(0, len(out) - 1))
        with open(os.path.join(self.out_dir, "train.txt"), "w",
                  encoding="utf-8") as f:
            f.write("".join(m + "\n" for m in out[val_size:]))
        with open(os.path.join(self.out_dir, "val.txt"), "w",
                  encoding="utf-8") as f:
            f.write("".join(m + "\n" for m in out[:val_size]))
        return out

    @staticmethod
    def _normalize_dir(dirname: str, mean: float, std: float
                       ) -> tuple[float, float]:
        vmin, vmax = np.inf, -np.inf
        for filename in sorted(os.listdir(dirname)):
            path = os.path.join(dirname, filename)
            values = (np.load(path) - mean) / std
            np.save(path, values)
            vmin = min(vmin, values.min())
            vmax = max(vmax, values.max())
        return float(vmin), float(vmax)


def _phoneme_average(values: np.ndarray, durations: list[int],
                     interpolate: bool) -> np.ndarray:
    """Frame values → per-phoneme means; for pitch, unvoiced gaps are first
    linearly interpolated (reference ``preprocessor.py:197-227``)."""
    values = np.asarray(values, np.float64).copy()
    if interpolate:
        nz = np.nonzero(values)[0]
        if len(nz):
            values = np.interp(np.arange(len(values)), nz, values[nz])
    out = np.zeros(len(durations), dtype=values.dtype)
    pos = 0
    for i, d in enumerate(durations):
        if d > 0 and pos < len(values):
            out[i] = values[pos:pos + d].mean()
        pos += d
    return out


# ---------------------------------------------------------------------------
# process-pool workers (module-level for spawn pickling)
# ---------------------------------------------------------------------------

_WORKER_PRE: "Preprocessor | None" = None


def _init_worker(cfg: PreprocessConfig, num_workers: int) -> None:
    """One CPU Preprocessor per worker, as the JAX package pins its workers
    to the CPU backend (N workers sharing one card would contend), with
    torch's intra-op threads split among the workers."""
    global _WORKER_PRE
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // num_workers))
    _WORKER_PRE = Preprocessor(cfg, device="cpu")


def _run_task(task: tuple[str, str]):
    speaker, basename = task
    return _WORKER_PRE.process_utterance(speaker, basename)
