"""Typed configuration: a copy of ``smart_nar_fast_tts_tpu/config.py``.

The same frozen dataclasses, field names and defaults (the committed
flagship is the default ``ModelConfig()``), the same loaders of the
reference's YAML triplet (``Config.from_yaml_triplet``, ``from_dicts``) and
the same validation, with ``ValueError`` where the JAX package asserts.  The
YAML files are read by :mod:`.yaml_subset`, not PyYAML, which the card's
machine lacks.  The mesh (``TrainConfig.mesh_shape``, ``mesh_axis_names``)
and ``ModelConfig.sequence_parallel`` run over ``torch.distributed`` under
torchrun (``parallel/``, ``training/trainer.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Mapping

from . import yaml_subset

# Phone-symbol vocabulary: len(SYMBOLS) + 1 of the text frontend
# (``text/symbols.py``); the embedding row count of every checkpoint.
VOCAB_SIZE = 361


@dataclass(frozen=True)
class AudioConfig:
    """Audio/STFT/mel constants (reference ``preprocess.yaml:17-28``)."""

    sampling_rate: int = 22050
    max_wav_value: float = 32768.0
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mels: int = 80
    mel_fmin: float = 0.0
    mel_fmax: float | None = 8000.0


@dataclass(frozen=True)
class FeatureStats:
    """Corpus z-norm statistics (reference ``stats.json`` written by
    ``preprocessor/preprocessor.py:114-133``): [min, max, mean, std]."""

    pitch_min: float = -2.0
    pitch_max: float = 6.5
    pitch_mean: float = 200.0
    pitch_std: float = 50.0
    energy_min: float = -1.5
    energy_max: float = 8.5
    energy_mean: float = 20.0
    energy_std: float = 15.0

    @classmethod
    def from_stats_json(cls, path: str) -> "FeatureStats":
        with open(path) as f:
            s = json.load(f)
        p, e = s["pitch"], s["energy"]
        return cls(
            pitch_min=p[0], pitch_max=p[1], pitch_mean=p[2], pitch_std=p[3],
            energy_min=e[0], energy_max=e[1], energy_mean=e[2], energy_std=e[3],
        )


@dataclass(frozen=True)
class PreprocessConfig:
    """Mirrors reference ``config/LJSpeech/preprocess.yaml``."""

    dataset: str = "LJSpeech"
    # paths
    lexicon_path: str = "lexicon/librispeech-lexicon.txt"
    data_path: str = "data/LJSpeech"
    preprocessed_path: str = "./preprocessed_data/LJSpeech"
    # text
    text_cleaners: tuple[str, ...] = ("english_cleaners",)
    language: str = "en"
    # split
    val_size: int = 512
    audio: AudioConfig = field(default_factory=AudioConfig)
    # variance features (reference ``preprocess.yaml:29-34``)
    pitch_feature: str = "frame_level"     # 'phoneme_level' | 'frame_level'
    pitch_normalization: bool = True
    energy_feature: str = "frame_level"
    energy_normalization: bool = True
    stats: FeatureStats | None = None

    def __post_init__(self):
        for level in (self.pitch_feature, self.energy_feature):
            if level not in ("phoneme_level", "frame_level"):
                raise ValueError(f"unknown feature level {level!r}")


@dataclass(frozen=True)
class TransformerConfig:
    """FFT-stack hyperparameters (reference ``model.yaml:1-11``)."""

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
    """Reference ``model.yaml:13-16``."""

    filter_size: int = 256
    kernel_size: int = 3
    dropout: float = 0.5


@dataclass(frozen=True)
class VarianceEmbeddingConfig:
    """Reference ``model.yaml:18-21``.

    Default pitch quantization is ``linear`` — NOT the reference's shipped
    ``log``: the reference pairs log-pitch with *normalized* pitch stats,
    which makes ``torch.linspace(log(negative), ...)`` produce NaN bin
    edges (its own model.yaml comment forbids the combination).  ``log`` is
    still fully supported for unnormalized (positive-Hz) pitch;
    :class:`Config` rejects the log+normalized combination with a clear
    error instead of NaNs (VERDICT.md Missing #5).
    """

    pitch_quantization: str = "linear"  # 'linear' | 'log'
    energy_quantization: str = "linear"
    n_bins: int = 256

    def __post_init__(self):
        for quant in (self.pitch_quantization, self.energy_quantization):
            if quant not in ("linear", "log"):
                raise ValueError(f"unknown quantization {quant!r}")


@dataclass(frozen=True)
class ModelConfig:
    """Mirrors reference ``config/LJSpeech/model.yaml`` plus the JAX
    package's additions."""

    transformer: TransformerConfig = field(default_factory=TransformerConfig)
    variance_predictor: VariancePredictorConfig = field(
        default_factory=VariancePredictorConfig)
    variance_embedding: VarianceEmbeddingConfig = field(
        default_factory=VarianceEmbeddingConfig)
    multi_speaker: bool = False
    n_speakers: int = 1
    max_seq_len: int = 1000
    vocoder_model: str = "HiFi-GAN"     # 'HiFi-GAN' | 'MelGAN'
    vocoder_speaker: str = "LJSpeech"
    n_mel_channels: int = 80

    # ---- extensions of the JAX package (no reference counterpart) ----
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
    # the FFT stacks' compute dtype: the port runs 'float32' only
    compute_dtype: str = "float32"
    # ring sequence-parallel self-attention of the MelDecoder, the frame
    # axis split over mesh axis ``sp_axis`` (parallel/sequence.py)
    sequence_parallel: bool = False
    sp_axis: str = "data"

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
    """Reference ``train.yaml:5-16`` (Noam-Adam, model/optimizer.py:5-51)."""

    batch_size: int = 48
    betas: tuple[float, float] = (0.9, 0.98)
    eps: float = 1e-9
    weight_decay: float = 0.0
    grad_clip_thresh: float = 1.0
    grad_acc_step: int = 1
    warm_up_step: int = 4000
    anneal_steps: tuple[int, ...] = ()
    anneal_rate: float = 1.0


@dataclass(frozen=True)
class StepConfig:
    """Reference ``train.yaml:17-20``."""

    total_step: int = 160000
    log_step: int = 100
    synth_step: int = 100
    val_step: int = 100
    save_step: int = 10000


@dataclass(frozen=True)
class TrainConfig:
    """Mirrors reference ``config/LJSpeech/train.yaml`` plus TPU additions."""

    ckpt_path: str = "./output/ckpt/LJSpeech"
    log_path: str = "./output/log/LJSpeech"
    result_path: str = "./output/result/LJSpeech"
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    step: StepConfig = field(default_factory=StepConfig)

    # ---- TPU-native extensions ----
    # Static-shape length buckets (text_len, mel_len) caps; generalizes the
    # reference's sort-by-length group batching (dataset.py:120-139,
    # group_size=4 at train.py:31) into fixed XLA-friendly shapes.
    text_buckets: tuple[int, ...] = (32, 64, 128, 192)
    mel_buckets: tuple[int, ...] = (256, 512, 768, 1000)
    # Serving-side mel frame capacities: synthesis runs at the smallest cap,
    # reads the predicted total duration, and re-runs at the smallest cap
    # that fits — so utterances past max_seq_len keep their speech instead
    # of being cut at 1000 frames (~11.6 s) like the reference, which
    # regenerates PE beyond max_seq_len but still truncates the regulator
    # output (transformer/Models.py:218-225, model/modules.py:228).
    serving_mel_caps: tuple[int, ...] = (1000, 2048, 4096, 8192)
    # Mesh axes: data-parallel size is filled at runtime from the mesh.
    mesh_shape: tuple[int, ...] = (-1, 1)          # (data, model)
    mesh_axis_names: tuple[str, ...] = ("data", "model")
    seed: int = 1234
    # the trainer's profiler window: steps after this one are traced
    # (0 = off)
    profile_start_step: int = 0
    profile_num_steps: int = 5
    # HiFi-GAN generator checkpoint for in-training audio logging
    # (reference synth_one_sample vocodes the sample, utils/tools.py:96-150)
    vocoder_ckpt: str | None = None
    # the JAX trainer's optimizer steps per compiled dispatch; the port's
    # trainer runs them as single steps, with the cadences after each group
    steps_per_dispatch: int = 1


@dataclass(frozen=True)
class Config:
    preprocess: PreprocessConfig = field(default_factory=PreprocessConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def __post_init__(self):
        # Validated config error (VERDICT.md Missing #5): the reference's
        # shipped LJSpeech model.yaml pairs log quantization with
        # *normalized* (negative-min) features, which silently produces NaN
        # bin edges in the reference (torch.linspace(log(negative), ...);
        # its own model.yaml comment forbids it).  Fail loudly instead.
        ve = self.model.variance_embedding
        for name, quant, normed in (
                ("pitch", ve.pitch_quantization,
                 self.preprocess.pitch_normalization),
                ("energy", ve.energy_quantization,
                 self.preprocess.energy_normalization)):
            if quant == "log" and normed:
                raise ValueError(
                    f"{name}_quantization='log' requires unnormalized "
                    f"(positive) {name} values, but preprocessing."
                    f"{name}.normalization is true.  This combination "
                    "produces NaN quantization bins (reference "
                    "config/LJSpeech/model.yaml:18-21 forbids it in its "
                    "own comment).  Use 'linear' quantization or disable "
                    f"{name} normalization.")

    # ------------------------------------------------------------------
    # Reference-YAML interop
    # ------------------------------------------------------------------
    @classmethod
    def from_yaml_triplet(cls, preprocess_yaml: str, model_yaml: str,
                          train_yaml: str) -> "Config":
        """Load from the reference's three YAML files
        (``train.py:188-194`` passes them as a positional tuple)."""
        return cls.from_dicts(*(yaml_subset.load(path) or {} for path in (
            preprocess_yaml, model_yaml, train_yaml)))

    @classmethod
    def from_dicts(cls, p: Mapping[str, Any], m: Mapping[str, Any],
                   t: Mapping[str, Any]) -> "Config":
        pp = p.get("preprocessing", {})
        audio = AudioConfig(
            sampling_rate=pp.get("audio", {}).get("sampling_rate", 22050),
            max_wav_value=pp.get("audio", {}).get("max_wav_value", 32768.0),
            n_fft=pp.get("stft", {}).get("filter_length", 1024),
            hop_length=pp.get("stft", {}).get("hop_length", 256),
            win_length=pp.get("stft", {}).get("win_length", 1024),
            n_mels=pp.get("mel", {}).get("n_mel_channels", 80),
            mel_fmin=pp.get("mel", {}).get("mel_fmin", 0.0),
            mel_fmax=pp.get("mel", {}).get("mel_fmax", 8000.0),
        )
        stats = None
        stats_path = os.path.join(
            p.get("path", {}).get("preprocessed_path", ""), "stats.json")
        if os.path.exists(stats_path):
            stats = FeatureStats.from_stats_json(stats_path)
        pre = PreprocessConfig(
            dataset=p.get("dataset", "LJSpeech"),
            lexicon_path=p.get("path", {}).get("lexicon_path", ""),
            data_path=p.get("path", {}).get("data_path", ""),
            preprocessed_path=p.get("path", {}).get("preprocessed_path", ""),
            text_cleaners=tuple(pp.get("text", {}).get(
                "text_cleaners", ("english_cleaners",))),
            language=pp.get("text", {}).get("language", "en"),
            val_size=pp.get("val_size", 512),
            audio=audio,
            pitch_feature=pp.get("pitch", {}).get("feature", "frame_level"),
            pitch_normalization=pp.get("pitch", {}).get("normalization", True),
            energy_feature=pp.get("energy", {}).get("feature", "frame_level"),
            energy_normalization=pp.get("energy", {}).get(
                "normalization", True),
            stats=stats,
        )
        tr = m.get("transformer", {})
        transformer = TransformerConfig(
            encoder_layer=tr.get("encoder_layer", 4),
            encoder_head=tr.get("encoder_head", 2),
            encoder_hidden=tr.get("encoder_hidden", 256),
            decoder_layer=tr.get("decoder_layer", 4),
            decoder_head=tr.get("decoder_head", 2),
            decoder_hidden=tr.get("decoder_hidden", 256),
            conv_filter_size=tr.get("conv_filter_size", 1024),
            conv_kernel_size=tuple(tr.get("conv_kernel_size", (9, 1))),
            encoder_dropout=tr.get("encoder_dropout", 0.2),
            decoder_dropout=tr.get("decoder_dropout", 0.2),
        )
        vp = m.get("variance_predictor", {})
        ve = m.get("variance_embedding", {})
        model = ModelConfig(
            transformer=transformer,
            variance_predictor=VariancePredictorConfig(
                filter_size=vp.get("filter_size", 256),
                kernel_size=vp.get("kernel_size", 3),
                dropout=vp.get("dropout", 0.5),
            ),
            variance_embedding=VarianceEmbeddingConfig(
                pitch_quantization=ve.get("pitch_quantization", "linear"),
                energy_quantization=ve.get("energy_quantization", "linear"),
                n_bins=ve.get("n_bins", 256),
            ),
            multi_speaker=m.get("multi_speaker", False),
            # not a reference key (the reference hardcodes single-speaker
            # despite its multi_speaker flag); needed for real
            # multi-speaker corpora
            n_speakers=m.get("n_speakers", 1),
            max_seq_len=m.get("max_seq_len", 1000),
            vocoder_model=m.get("vocoder", {}).get("model", "HiFi-GAN"),
            vocoder_speaker=m.get("vocoder", {}).get("speaker", "LJSpeech"),
            n_mel_channels=audio.n_mels,
            # optional TPU-native keys (duration_extraction, upsampling,
            # compute_dtype, ...) — absent section keeps reference YAMLs
            **{k: tuple(v) if isinstance(v, list) else v
               for k, v in m.get("tpu", {}).items()},
        )
        opt = t.get("optimizer", {})
        stp = t.get("step", {})
        train = TrainConfig(
            ckpt_path=t.get("path", {}).get("ckpt_path", "./output/ckpt"),
            log_path=t.get("path", {}).get("log_path", "./output/log"),
            result_path=t.get("path", {}).get(
                "result_path", "./output/result"),
            optimizer=OptimizerConfig(
                batch_size=opt.get("batch_size", 48),
                betas=tuple(opt.get("betas", (0.9, 0.98))),
                eps=opt.get("eps", 1e-9),
                weight_decay=opt.get("weight_decay", 0.0),
                grad_clip_thresh=opt.get("grad_clip_thresh", 1.0),
                grad_acc_step=opt.get("grad_acc_step", 1),
                warm_up_step=opt.get("warm_up_step", 4000),
                anneal_steps=tuple(opt.get("anneal_steps", ())),
                anneal_rate=opt.get("anneal_rate", 1.0),
            ),
            step=StepConfig(
                total_step=stp.get("total_step", 160000),
                log_step=stp.get("log_step", 100),
                synth_step=stp.get("synth_step", 100),
                val_step=stp.get("val_step", 100),
                save_step=stp.get("save_step", 10000),
            ),
            # optional TPU-native keys (no reference counterpart): an
            # omitted ``tpu:`` section keeps reference YAMLs loading
            **{k: tuple(v) if isinstance(v, list) else v
               for k, v in t.get("tpu", {}).items()},
        )
        return cls(preprocess=pre, model=model, train=train)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def with_stats(self, stats: FeatureStats) -> "Config":
        return dataclasses.replace(
            self, preprocess=dataclasses.replace(self.preprocess, stats=stats))

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)


def check_ported(model: ModelConfig) -> None:
    """Raise for a compute dtype the port does not run."""
    if model.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError("compute_dtype must be float32 or bfloat16, got "
                         f"{model.compute_dtype!r}")
