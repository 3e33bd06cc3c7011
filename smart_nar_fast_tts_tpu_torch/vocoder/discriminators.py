"""HiFi-GAN discriminators for vocoder GAN training: the multi-period
discriminator (MPD, periods 2/3/5/7/11, the waveform folded to a
(T/p, p) image) and the multi-scale discriminator (MSD: raw, ×2 and ×4
average-pooled), as ``smart_nar_fast_tts_tpu/vocoder/discriminators.py``.

Layouts are PyTorch's (channels first): the MPD folds NCHW as
(B, 1, T/p, p) where the JAX package folds NHWC as (B, T/p, p, 1), so its
feature maps are (B, C, T/p, p) against JAX's (B, T/p, p, C), and the MSD's
(B, C, T) against (B, T, C).  Scores are flattened in the same (time,
period) order on both sides.

The two reparameterisations are flax's, written out:

- :class:`WNConv` is flax ``nn.WeightNorm`` on a conv: the kernel is
  ``v · rsqrt(Σ v² + 1e-12) · scale`` per output channel; the bias is not
  normalised.
- :class:`SNConv` is flax ``nn.SpectralNorm``: on every call one
  power-iteration step from the stored ``u`` (1, out) over the kernel
  viewed as (−1, out), no gradient through ``u`` and ``v``, and the kernel
  divided by σ = v·W·uᵀ (with its gradient).  The new ``u`` and σ are
  stored only when the call passes ``update_stats=True``.

A new discriminator is initialised from a seed as flax initialises it, in
distribution: lecun-normal (truncated) kernels, zero biases, weight-norm
scales of 1, ``u`` ~ N(0, 1) and σ = 1.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1
NORM_EPS = 1e-12              # flax's WeightNorm / SpectralNorm epsilon

# score + per-layer feature maps, one entry per sub-discriminator
DiscOutput = list[tuple[torch.Tensor, list[torch.Tensor]]]

SCALE_LAYERS = (                 # (features, kernel, stride, groups)
    (128, 15, 1, 1),
    (128, 41, 2, 4),
    (256, 41, 2, 16),
    (512, 41, 4, 16),
    (1024, 41, 4, 16),
    (1024, 41, 1, 16),
    (1024, 5, 1, 1),
)


def _l2_normalize(x: torch.Tensor, dims=None) -> torch.Tensor:
    """flax's ``_l2_normalize``: x · rsqrt(Σ x² + 1e-12)."""
    sq = (x * x).sum() if dims is None else (x * x).sum(dims, keepdim=True)
    return x * torch.rsqrt(sq + NORM_EPS)


class _Conv(nn.Module):
    """A 1-D or 2-D conv whose raw kernel ``weight`` (out, in/groups,
    *kernel) each subclass reparameterises before :meth:`conv`."""

    def __init__(self, c_in: int, c_out: int, kernel: tuple[int, ...],
                 stride: tuple[int, ...], padding: tuple[int, ...],
                 groups: int = 1):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.weight = nn.Parameter(torch.empty(c_out, c_in // groups,
                                               *kernel))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax ``lecun_normal``: a normal of std √(1/fan_in) truncated at
        ±2 std, rescaled to keep that variance; zero bias."""
        fan_in = self.weight[0].numel()
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, 1.0, -2.0, 2.0,
                                  generator=generator)
            self.weight.mul_(std)
            self.bias.zero_()

    def conv(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        fn = F.conv1d if w.ndim == 3 else F.conv2d
        return fn(x, w, self.bias, self.stride, self.padding, 1, self.groups)


class WNConv(_Conv):
    """Conv under flax ``nn.WeightNorm``: the kernel normalised per output
    channel over its other axes, times ``scale`` (out,)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.scale = nn.Parameter(torch.ones(self.weight.shape[0]))

    def reset_parameters(self, generator: torch.Generator) -> None:
        super().reset_parameters(generator)
        with torch.no_grad():
            self.scale.fill_(1.0)

    def kernel(self) -> torch.Tensor:
        dims = tuple(range(1, self.weight.ndim))
        shape = (-1,) + (1,) * (self.weight.ndim - 1)
        return _l2_normalize(self.weight, dims) * self.scale.view(shape)

    def forward(self, x: torch.Tensor, update_stats: bool = False
                ) -> torch.Tensor:
        return self.conv(x, self.kernel())


class SNConv(_Conv):
    """Conv under flax ``nn.SpectralNorm`` (one power-iteration step per
    call); ``u`` (1, out) and ``sigma`` () are buffers, moved only by a call
    with ``update_stats=True``."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.register_buffer("u", torch.zeros(1, self.weight.shape[0]))
        self.register_buffer("sigma", torch.ones(()))

    def reset_parameters(self, generator: torch.Generator) -> None:
        super().reset_parameters(generator)
        with torch.no_grad():
            self.u.copy_(torch.randn(self.u.shape, generator=generator,
                                     device=self.u.device))
            self.sigma.fill_(1.0)

    def forward(self, x: torch.Tensor, update_stats: bool = False
                ) -> torch.Tensor:
        # (out, in/g, k) → (in/g·k, out): the rows are ordered otherwise
        # than flax's (k, in/g), which changes neither u, v nor σ
        w = self.weight.reshape(self.weight.shape[0], -1).t()
        with torch.no_grad():
            v = _l2_normalize(self.u @ w.t())
            u = _l2_normalize(v @ w)
        sigma = (v @ w @ u.t())[0, 0]
        kernel = self.weight / torch.where(sigma != 0, sigma, 1.0)
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        return self.conv(x, kernel)


class PeriodDiscriminator(nn.Module):
    """One MPD branch: the waveform reflect-padded to a multiple of p and
    folded to (B, 1, T/p, p); weight-normed 2-D convs with kernel (5, 1),
    stride (3, 1) over the folded time, then a (5, 1) conv to 1024 channels
    (``conv_4``) and a (3, 1) conv to 1 (``conv_post``)."""

    def __init__(self, period: int,
                 channels: Sequence[int] = (32, 128, 512, 1024)):
        super().__init__()
        self.period = period
        c_in, convs = 1, []
        for ch in channels:
            convs.append(WNConv(c_in, ch, (5, 1), (3, 1), (2, 0)))
            c_in = ch
        self.convs = nn.ModuleList(convs)
        self.conv_4 = WNConv(c_in, 1024, (5, 1), (1, 1), (2, 0))
        self.conv_post = WNConv(1024, 1, (3, 1), (1, 1), (1, 0))

    def forward(self, wav: torch.Tensor):
        p = self.period
        B, T = wav.shape
        pad = (-T) % p
        x = F.pad(wav[:, None], (0, pad), mode="reflect") if pad else \
            wav[:, None]
        x = x.reshape(B, 1, (T + pad) // p, p)
        feats = []
        for conv in (*self.convs, self.conv_4):
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            feats.append(x)
        x = self.conv_post(x)
        feats.append(x)
        return x.reshape(B, -1), feats


class ScaleDiscriminator(nn.Module):
    """One MSD branch: the paper's 1-D grouped-conv stack, spectral norm on
    the raw scale and weight norm on the pooled ones."""

    def __init__(self, use_spectral_norm: bool = False,
                 layers: Sequence[tuple] = SCALE_LAYERS):
        super().__init__()
        conv = SNConv if use_spectral_norm else WNConv
        c_in, convs = 1, []
        for ch, k, s, g in layers:
            convs.append(conv(c_in, ch, (k,), (s,), (k // 2,), g))
            c_in = ch
        self.convs = nn.ModuleList(convs)
        self.conv_post = conv(c_in, 1, (3,), (1,), (1,))

    def forward(self, wav: torch.Tensor, update_stats: bool = False):
        x = wav[:, None]
        feats = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x, update_stats), LRELU_SLOPE)
            feats.append(x)
        x = self.conv_post(x, update_stats)
        feats.append(x)
        return x.reshape(x.shape[0], -1), feats


class MultiScaleDiscriminator(nn.Module):
    """``n_scales`` scale discriminators, the input average-pooled (window
    4, stride 2, padding 2 counted in the mean) between scales."""

    def __init__(self, n_scales: int = 3,
                 layers: Sequence[tuple] = SCALE_LAYERS):
        super().__init__()
        self.scales = nn.ModuleList(
            ScaleDiscriminator(use_spectral_norm=(i == 0), layers=layers)
            for i in range(n_scales))
        self.pool = nn.AvgPool1d(4, 2, padding=2, count_include_pad=True)

    def forward(self, wav: torch.Tensor, update_stats: bool = False
                ) -> DiscOutput:
        out: DiscOutput = []
        x = wav
        for i, scale in enumerate(self.scales):
            if i > 0:
                x = self.pool(x[:, None])[:, 0]
            out.append(scale(x, update_stats))
        return out


class HiFiGANDiscriminator(nn.Module):
    """MPD + MSD; ``forward(wav (B, T), update_stats)`` returns (MPD
    outputs, MSD outputs).  Initialised from ``seed`` as flax initialises
    the JAX module, in distribution."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 period_channels: Sequence[int] = (32, 128, 512, 1024),
                 n_scales: int = 3,
                 scale_layers: Sequence[tuple] = SCALE_LAYERS,
                 seed: int = 0):
        super().__init__()
        self.mpd = nn.ModuleList(PeriodDiscriminator(p, period_channels)
                                 for p in periods)
        self.msd = MultiScaleDiscriminator(n_scales, scale_layers)
        generator = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, _Conv):
                m.reset_parameters(generator)

    def forward(self, wav: torch.Tensor, update_stats: bool = False
                ) -> tuple[DiscOutput, DiscOutput]:
        return ([d(wav) for d in self.mpd],
                self.msd(wav, update_stats))
