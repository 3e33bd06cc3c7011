"""Two-stage bucketed serving: token ids → mel → waveform.

Stage A runs the acoustic model at the full frame capacity ``t_cap`` (the
output length is unknown before the model runs).  The host then reads
``max(mel_lens)`` and picks the smallest mel bucket that holds it, and stage
B runs the vocoder on ``postnet_mel[:, :bucket]`` only, as ``bench.py`` serves
the JAX package.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from .config import FeatureStats, ModelConfig, PreprocessConfig
from .device import resolve_device
from .models import FastSpeech2Align, ModelOutput
from .vocoder import HiFiGANConfig, HiFiGANGenerator
from .weights import (FLAGSHIP_INDEX, HIFIGAN_INDEX, jax_to_torch_acoustic,
                      jax_to_torch_hifigan, load_committed)

RESULTS_DIR = Path(__file__).resolve().parent.parent / "benchmarks" / "results"
MEL_BUCKETS = (128, 256, 384, 512, 640, 768, 1000)
T_CAP = 1000


def bucket(n: int) -> int:
    """The smallest mel bucket that holds n frames (the largest if none
    does)."""
    return next((b for b in MEL_BUCKETS if n <= b), MEL_BUCKETS[-1])


def committed_flagship(cfg: ModelConfig = ModelConfig(),
                       results_dir: str | Path = RESULTS_DIR
                       ) -> FastSpeech2Align:
    """The committed flagship acoustic model (``flagship_params.npz``, with
    the feature stats of ``flagship_meta.json``) on the CPU, built with
    ``cfg``: the flagship's widths with any duration extraction."""
    results = Path(results_dir)
    meta = json.loads((results / "flagship_meta.json").read_text())
    model = FastSpeech2Align(
        cfg, PreprocessConfig(stats=FeatureStats(**meta["stats"])))
    model.load_state_dict(jax_to_torch_acoustic(load_committed(
        results / "flagship_params.npz", FLAGSHIP_INDEX), cfg))
    return model


def committed_vocoder(results_dir: str | Path = RESULTS_DIR
                      ) -> HiFiGANGenerator:
    """The committed HiFi-GAN V1 generator (``vocoder_params.npz``, with the
    config of ``vocoder_meta.json``) on the CPU."""
    results = Path(results_dir)
    meta = json.loads((results / "vocoder_meta.json").read_text())
    config = HiFiGANConfig.from_dict(meta["config"])
    vocoder = HiFiGANGenerator(config)
    vocoder.load_state_dict(jax_to_torch_hifigan(load_committed(
        results / "vocoder_params.npz", HIFIGAN_INDEX), config))
    return vocoder


class Synthesizer:
    """Acoustic model + vocoder on one device, in eval mode."""

    def __init__(self, model: FastSpeech2Align, vocoder: HiFiGANGenerator,
                 device: str | torch.device | None = None,
                 t_cap: int = T_CAP):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.vocoder = vocoder.to(self.device).eval()
        self.t_cap = t_cap

    @classmethod
    def from_committed(cls, device: str | torch.device | None = None,
                       results_dir: str | Path = RESULTS_DIR
                       ) -> "Synthesizer":
        """The committed flagship acoustic model and HiFi-GAN V1, read from
        ``flagship_params.npz`` / ``vocoder_params.npz`` and their meta
        files (feature stats, vocoder config)."""
        device = resolve_device(device)
        return cls(committed_flagship(results_dir=results_dir),
                   committed_vocoder(results_dir), device)

    @property
    def hop_length(self) -> int:
        return self.vocoder.config.hop_length

    @property
    def sampling_rate(self) -> int:
        return self.vocoder.config.sampling_rate

    def audio_seconds(self, mel_lens: torch.Tensor) -> float:
        """Seconds of audio in the valid frames of a batch."""
        return float(mel_lens.sum()) * self.hop_length / self.sampling_rate

    @torch.inference_mode()
    def stage_a(self, token_ids: torch.Tensor, src_lens: torch.Tensor
                ) -> ModelOutput:
        """Text → mel at the full frame capacity."""
        return self.model(token_ids.to(self.device), src_lens.to(self.device),
                          max_mel_len=self.t_cap)

    @torch.inference_mode()
    def stage_b(self, mel: torch.Tensor) -> torch.Tensor:
        """Mel (B, T, n_mels) → waveform (B, T·hop)."""
        return self.vocoder(mel.to(self.device))

    def synthesize(self, token_ids, src_lens
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """token_ids (B, L) and src_lens (B,) → (waveform (B, bucket·hop)
        in [-1, 1], mel_lens (B,) int32).  Item i's audio is its first
        ``mel_lens[i]·hop`` samples."""
        token_ids = torch.as_tensor(token_ids, dtype=torch.long)
        src_lens = torch.as_tensor(src_lens, dtype=torch.long)
        out = self.stage_a(token_ids, src_lens)
        cap = bucket(int(out.mel_lens.max()))
        wav = self.stage_b(out.postnet_mel[:, :cap])
        return wav, out.mel_lens
