"""Variance adaptor: duration, pitch and energy prediction, quantized
pitch/energy embeddings, and length regulation.

At inference the predictions drive the embeddings and the upsampling; in
training the ground-truth pitch and energy targets drive the embeddings, the
extracted duration targets drive the upsampling, and the frame masks come
from the ground-truth mel lengths.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..config import FeatureStats, ModelConfig
from ..kernels import gaussian_upsample_banded
from ..ops.upsample import hard_upsample
from ..tracing import span
from .layers import LN_EPS, ConvNorm, dropout, zero_where_not


def quantization_bins(vmin: float, vmax: float, n_bins: int,
                      log_scale: bool) -> np.ndarray:
    """(n_bins - 1,) float32 bucket boundaries, linear or log spaced."""
    if log_scale:
        if vmin <= 0:
            raise ValueError(
                f"log quantization requires positive stats, got vmin={vmin}; "
                "normalized features need 'linear' quantization")
        return np.exp(np.linspace(np.log(vmin), np.log(vmax),
                                  n_bins - 1)).astype(np.float32)
    return np.linspace(vmin, vmax, n_bins - 1).astype(np.float32)


def bucketize(values: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """Index of the first boundary >= value (searchsorted side 'left')."""
    return torch.bucketize(values, bins, right=False)


class VariancePredictor(nn.Module):
    """2× (conv → ReLU → LayerNorm → dropout) → linear → one scalar per
    position, 0 where not ``valid``."""

    def __init__(self, d_in: int, filter_size: int, kernel_size: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.conv_layer = nn.ModuleDict({
            "conv1d_1": ConvNorm(d_in, filter_size, kernel_size),
            "layer_norm_1": nn.LayerNorm(filter_size, eps=LN_EPS),
            "conv1d_2": ConvNorm(filter_size, filter_size, kernel_size),
            "layer_norm_2": nn.LayerNorm(filter_size, eps=LN_EPS),
        })
        self.linear_layer = nn.Linear(filter_size, 1)

    def forward(self, x: torch.Tensor, valid: torch.Tensor,
                cap_valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        c = self.conv_layer
        h = c["layer_norm_1"](torch.relu(c["conv1d_1"](x)))
        h = dropout(h, self.dropout_rate, generator)
        if cap_valid is not None:
            # conv2 sees zeros past the batch capacity, as the reference's
            # tensors end at the batch's longest item
            h = zero_where_not(cap_valid, h)
        h = c["layer_norm_2"](torch.relu(c["conv1d_2"](h)))
        h = dropout(h, self.dropout_rate, generator)
        out = self.linear_layer(h)[..., 0]
        return torch.where(valid, out, 0.0)


class VarianceAdaptorOutput(NamedTuple):
    x: torch.Tensor                        # (B, T, D) frame-rate features
    pitch_prediction: torch.Tensor
    energy_prediction: torch.Tensor
    log_duration_prediction: torch.Tensor  # (B, L)
    duration_rounded: torch.Tensor         # (B, L)
    mel_len: torch.Tensor                  # (B,) int32
    mel_valid: torch.Tensor                # (B, T)
    mel_cap: torch.Tensor                  # (T,) batch-level frame capacity


class VarianceAdaptor(nn.Module):
    def __init__(self, cfg: ModelConfig, stats: FeatureStats,
                 pitch_feature_level: str = "frame_level",
                 energy_feature_level: str = "frame_level"):
        super().__init__()
        self.cfg = cfg
        self.pitch_feature_level = pitch_feature_level
        self.energy_feature_level = energy_feature_level
        ve, vp = cfg.variance_embedding, cfg.variance_predictor
        d = cfg.transformer.encoder_hidden
        for name in ("duration_predictor", "pitch_predictor",
                     "energy_predictor"):
            self.add_module(name, VariancePredictor(
                d, vp.filter_size, vp.kernel_size, vp.dropout))
        self.register_buffer("pitch_bins", torch.from_numpy(quantization_bins(
            stats.pitch_min, stats.pitch_max, ve.n_bins,
            ve.pitch_quantization == "log")), persistent=False)
        self.register_buffer("energy_bins", torch.from_numpy(
            quantization_bins(stats.energy_min, stats.energy_max, ve.n_bins,
                              ve.energy_quantization == "log")),
            persistent=False)
        self.pitch_embedding = nn.Embedding(ve.n_bins, d)
        self.energy_embedding = nn.Embedding(ve.n_bins, d)

    def _variance(self, predictor, embedding, bins, x, target, valid,
                  control, cap_valid, generator):
        """Prediction and the embedding of the target (training) or of the
        scaled prediction (inference), zeroed past the capacity (positions
        between an item's length and the capacity keep
        ``embedding[bucketize(0)]``, as the reference's padded compute)."""
        prediction = predictor(x, valid, cap_valid, generator)
        if target is not None:
            emb = embedding(bucketize(target, bins))
        else:
            prediction = prediction * control
            emb = embedding(bucketize(prediction, bins))
        if cap_valid is not None:
            emb = zero_where_not(cap_valid, emb)
        return prediction, emb

    def forward(self, x: torch.Tensor, src_valid: torch.Tensor, max_len: int,
                mel_valid: Optional[torch.Tensor] = None,
                pitch_target: Optional[torch.Tensor] = None,
                energy_target: Optional[torch.Tensor] = None,
                duration_target: Optional[torch.Tensor] = None,
                p_control: float = 1.0, e_control: float = 1.0,
                d_control: float = 1.0,
                src_cap: Optional[torch.Tensor] = None,
                mel_cap: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> VarianceAdaptorOutput:
        log_d_pred = self.duration_predictor(x, src_valid, src_cap, generator)

        pitch_pred = energy_pred = None
        if self.pitch_feature_level == "phoneme_level":
            pitch_pred, emb = self._variance(
                self.pitch_predictor, self.pitch_embedding, self.pitch_bins,
                x, pitch_target, src_valid, p_control, src_cap, generator)
            x = x + emb
        if self.energy_feature_level == "phoneme_level":
            energy_pred, emb = self._variance(
                self.energy_predictor, self.energy_embedding,
                self.energy_bins, x, energy_target, src_valid, e_control,
                src_cap, generator)
            x = x + emb

        if duration_target is not None:
            duration = duration_target
        else:
            # round(exp(logd) - 1) * d_control, clamped at 0
            duration = torch.clamp(
                torch.round(torch.exp(log_d_pred) - 1.0) * d_control,
                min=0.0)
            duration = duration * src_valid

        with span("acoustic.upsample"):
            if self.cfg.upsampling == "hard":
                x, mel_len = hard_upsample(x, duration, max_len)
            else:
                x, mel_len = gaussian_upsample_banded(
                    x.contiguous(), duration, max_len, src_valid.to(x.dtype),
                    sigma=self.cfg.gaussian_sigma)

        frames = torch.arange(max_len, device=x.device)
        if duration_target is None or mel_valid is None:
            mel_valid = frames[None, :] < mel_len[:, None]
        if mel_cap is None:
            # the batch-level frame capacity: where the reference's inference
            # tensors end (the batch's longest predicted item); in training
            # the caller passes it from the ground-truth mel lengths
            mel_cap = frames < mel_len.max()

        if self.pitch_feature_level == "frame_level":
            pitch_pred, emb = self._variance(
                self.pitch_predictor, self.pitch_embedding, self.pitch_bins,
                x, pitch_target, mel_valid, p_control, mel_cap, generator)
            x = x + emb
        if self.energy_feature_level == "frame_level":
            energy_pred, emb = self._variance(
                self.energy_predictor, self.energy_embedding,
                self.energy_bins, x, energy_target, mel_valid, e_control,
                mel_cap, generator)
            x = x + emb

        return VarianceAdaptorOutput(
            x=x, pitch_prediction=pitch_pred, energy_prediction=energy_pred,
            log_duration_prediction=log_d_pred, duration_rounded=duration,
            mel_len=mel_len, mel_valid=mel_valid, mel_cap=mel_cap)
