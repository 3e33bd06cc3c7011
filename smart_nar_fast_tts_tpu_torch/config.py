"""Configuration of the ported paths: serving and acoustic-model training.

A copy of the fields of ``smart_nar_fast_tts_tpu/config.py`` that these paths
read, with the same names and defaults (the committed flagship is the default
``ModelConfig()``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

# Phone-symbol vocabulary: len(SYMBOLS) + 1 of the JAX text frontend
# (``text/symbols.py``); the embedding row count of every checkpoint.
VOCAB_SIZE = 361


@dataclass(frozen=True)
class FeatureStats:
    """Corpus z-norm statistics of pitch and energy: min, max, mean, std."""

    pitch_min: float = -2.0
    pitch_max: float = 6.5
    pitch_mean: float = 200.0
    pitch_std: float = 50.0
    energy_min: float = -1.5
    energy_max: float = 8.5
    energy_mean: float = 20.0
    energy_std: float = 15.0


@dataclass(frozen=True)
class PreprocessConfig:
    """Where pitch and energy are predicted, and the corpus stats."""

    pitch_feature: str = "frame_level"     # 'phoneme_level' | 'frame_level'
    energy_feature: str = "frame_level"
    stats: FeatureStats | None = None

    def __post_init__(self):
        for level in (self.pitch_feature, self.energy_feature):
            if level not in ("phoneme_level", "frame_level"):
                raise ValueError(f"unknown feature level {level!r}")


@dataclass(frozen=True)
class TransformerConfig:
    encoder_layer: int = 4
    encoder_head: int = 2
    encoder_hidden: int = 256
    decoder_layer: int = 4
    decoder_head: int = 2
    decoder_hidden: int = 256
    conv_filter_size: int = 1024
    conv_kernel_size: tuple[int, int] = (9, 1)
    encoder_dropout: float = 0.2
    decoder_dropout: float = 0.2


@dataclass(frozen=True)
class VariancePredictorConfig:
    filter_size: int = 256
    kernel_size: int = 3
    dropout: float = 0.5


@dataclass(frozen=True)
class VarianceEmbeddingConfig:
    pitch_quantization: str = "linear"     # 'linear' | 'log'
    energy_quantization: str = "linear"
    n_bins: int = 256


@dataclass(frozen=True)
class ModelConfig:
    transformer: TransformerConfig = field(default_factory=TransformerConfig)
    variance_predictor: VariancePredictorConfig = field(
        default_factory=VariancePredictorConfig)
    variance_embedding: VarianceEmbeddingConfig = field(
        default_factory=VarianceEmbeddingConfig)
    multi_speaker: bool = False
    n_speakers: int = 1
    max_seq_len: int = 1000
    n_mel_channels: int = 80
    # Length regulator.  On a CUDA tensor 'gaussian' and 'gaussian_banded'
    # both run the banded CUDA kernel (one function); on the CPU both run
    # the dense plain version.  'hard' repeats each phoneme d times.
    upsampling: str = "gaussian"
    gaussian_sigma: float = 10.0
    # Duration targets from the MelEncoder's last-layer attention
    # (ops/duration.py).  'intended' + 'first' runs the alignment kernel,
    # which returns only the per-frame argmax and the guided-attention
    # numerator of head 0; every other pair keeps the full attention maps.
    duration_extraction: str = "soft"     # 'intended' | 'soft' | 'buggy'
    duration_head_reduce: str = "mean"    # 'first' | 'mean'
    guided_sigma: float = 0.2

    def __post_init__(self):
        if self.upsampling not in ("hard", "gaussian", "gaussian_banded"):
            raise ValueError(f"unknown upsampling {self.upsampling!r}")
        if self.duration_extraction not in ("intended", "soft", "buggy"):
            raise ValueError(
                f"unknown duration extraction {self.duration_extraction!r}")
        if self.duration_head_reduce not in ("first", "mean"):
            raise ValueError(
                f"unknown head reduction {self.duration_head_reduce!r}")


@dataclass(frozen=True)
class OptimizerConfig:
    """Noam-Adam with global-norm clipping and gradient accumulation."""

    batch_size: int = 48
    betas: tuple[float, float] = (0.9, 0.98)
    eps: float = 1e-9
    weight_decay: float = 0.0
    grad_clip_thresh: float = 1.0
    grad_acc_step: int = 1
    warm_up_step: int = 4000
    anneal_steps: tuple[int, ...] = ()
    anneal_rate: float = 1.0
