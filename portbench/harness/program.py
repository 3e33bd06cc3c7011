"""The system under test: ``smart_nar_fast_tts_tpu_torch`` objects built from a
configuration file and loaded with the benchmark's weights.  The only
module of the benchmark that imports the port."""

from __future__ import annotations

import torch


def acoustic_config(cfg: dict):
    from smart_nar_fast_tts_tpu_torch.config import (
        ModelConfig, TransformerConfig, VarianceEmbeddingConfig,
        VariancePredictorConfig)
    a = cfg["acoustic"]
    t = dict(a["transformer"])
    t["conv_kernel_size"] = tuple(t["conv_kernel_size"])
    return ModelConfig(
        transformer=TransformerConfig(**t),
        variance_predictor=VariancePredictorConfig(**a["variance_predictor"]),
        variance_embedding=VarianceEmbeddingConfig(**a["variance_embedding"]),
        max_seq_len=a["max_seq_len"], n_mel_channels=a["n_mel_channels"],
        upsampling=a["upsampling"], gaussian_sigma=a["gaussian_sigma"],
        duration_extraction=a["duration_extraction"],
        duration_head_reduce=a["duration_head_reduce"],
        guided_sigma=a["guided_sigma"],
        compute_dtype=cfg["precision"]["dtype"])


def preprocess_config(cfg: dict):
    from smart_nar_fast_tts_tpu_torch.config import (FeatureStats,
                                                     PreprocessConfig)
    return PreprocessConfig(stats=FeatureStats(**cfg["acoustic"]["stats"]))


def acoustic(cfg: dict, weights: dict) -> torch.nn.Module:
    """The port's ``FastSpeech2Align`` with ``weights`` (on their device)."""
    from smart_nar_fast_tts_tpu_torch.models import FastSpeech2Align
    dev = next(iter(weights.values())).device
    with torch.device(dev):
        model = FastSpeech2Align(acoustic_config(cfg), preprocess_config(cfg))
    model.to(dev)
    model.load_state_dict(weights, strict=True)
    return model


def vocoder(cfg: dict, weights: dict) -> torch.nn.Module:
    v = dict(cfg["vocoder"])
    family = v.pop("family")
    v.pop("hop_length", None)
    dev = next(iter(weights.values())).device
    if family == "hifigan":
        from smart_nar_fast_tts_tpu_torch.vocoder.hifigan import (
            HiFiGANConfig, HiFiGANGenerator)
        with torch.device(dev):
            model = HiFiGANGenerator(HiFiGANConfig(**v))
    elif family == "vocos":
        from smart_nar_fast_tts_tpu_torch.vocoder.vocos import (
            VocosConfig, VocosGenerator)
        with torch.device(dev):
            model = VocosGenerator(VocosConfig(**v))
    else:
        raise ValueError(f"unknown vocoder family {family!r}")
    model.to(dev)
    model.load_state_dict(weights, strict=True)
    return model
