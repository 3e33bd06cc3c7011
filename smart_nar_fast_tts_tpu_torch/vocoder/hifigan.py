"""HiFi-GAN generator: log-mel (B, T, n_mels) → waveform (B, T·hop).

The plain-tail, dilated-transpose math of the JAX generator (its ``grouped``
and ``polyphase`` forms are TPU lowerings of the same function with the same
parameters) as stock ``nn.Conv1d`` / ``nn.ConvTranspose1d``.  V1: conv_pre
80→512 k7; four transposed-conv stages (rates 8, 8, 2, 2, kernels 16, 16, 4,
4, padding (k-u)//2, channels halving); multi-receptive-field ResBlock1s
k ∈ {3, 7, 11} with dilations (1, 3, 5); LeakyReLU 0.1 between stages and
0.01 before conv_post (upstream's torch default); tanh.  V3 (``resblock
"2"``) takes ResBlock2s, one conv per dilation.  Module names follow the
upstream torch generator with weight norm folded.

``compute_dtype="bfloat16"`` runs conv_pre, the upsampling stages and the
resblocks in bf16 (the parameters stay f32 and are rounded per call); the
last LeakyReLU, conv_post and tanh run in f32, as the JAX generator.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1


def _as_tuple(v):
    return tuple(_as_tuple(x) for x in v) if isinstance(v, (list, tuple)) \
        else v


@dataclass(frozen=True)
class HiFiGANConfig:
    resblock: str = "1"
    upsample_rates: Sequence[int] = (8, 8, 2, 2)
    upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5))
    n_mels: int = 80
    sampling_rate: int = 22050
    compute_dtype: str = "float32"      # or "bfloat16"

    def __post_init__(self):
        for name in ("upsample_rates", "upsample_kernel_sizes",
                     "resblock_kernel_sizes", "resblock_dilation_sizes"):
            object.__setattr__(self, name, _as_tuple(getattr(self, name)))
        if str(self.resblock) not in ("1", "2"):
            raise ValueError(f"resblock must be \"1\" or \"2\", got "
                             f"{self.resblock!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError("compute_dtype must be float32 or bfloat16, "
                             f"got {self.compute_dtype!r}")

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def hop_length(self) -> int:
        out = 1
        for u in self.upsample_rates:
            out *= u
        return out

    def to_dict(self) -> dict:
        """The upstream ``config.json`` keys (``num_mels`` for ``n_mels``);
        ``from_dict(to_dict())`` round-trips.  The JAX package's
        ``HiFiGANConfig.to_dict`` adds its TPU lowering keys, which its
        ``from_dict`` defaults when absent."""
        return {
            "resblock": self.resblock,
            "upsample_rates": list(self.upsample_rates),
            "upsample_kernel_sizes": list(self.upsample_kernel_sizes),
            "upsample_initial_channel": self.upsample_initial_channel,
            "resblock_kernel_sizes": list(self.resblock_kernel_sizes),
            "resblock_dilation_sizes": [
                list(d) for d in self.resblock_dilation_sizes],
            "num_mels": self.n_mels,
            "sampling_rate": self.sampling_rate,
            "compute_dtype": self.compute_dtype,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "HiFiGANConfig":
        """From the ``config`` dict of ``vocoder_meta.json`` or an upstream
        ``config.json`` (``num_mels`` for ``n_mels``); the keys that choose
        the JAX package's TPU lowerings are ignored."""
        keep = {k: d[k] for k in (
            "resblock", "upsample_rates", "upsample_kernel_sizes",
            "upsample_initial_channel", "resblock_kernel_sizes",
            "resblock_dilation_sizes", "n_mels", "sampling_rate",
            "compute_dtype") if k in d}
        if "num_mels" in d:
            keep["n_mels"] = d["num_mels"]
        return cls(**keep)


def conv_in(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``conv`` (a Conv1d or ConvTranspose1d) computed in x's dtype: its
    f32 parameters rounded to a bf16 x's dtype for the call."""
    w, b = conv.weight, conv.bias
    if w.dtype == x.dtype:
        return conv(x)
    w, b = w.to(x.dtype), b.to(x.dtype)
    if isinstance(conv, nn.ConvTranspose1d):
        return F.conv_transpose1d(x, w, b, conv.stride, conv.padding,
                                  conv.output_padding, conv.groups,
                                  conv.dilation)
    return conv._conv_forward(x, w, b)


class ResBlock1(nn.Module):
    """Per dilation d: LReLU → conv(k, dil d) → LReLU → conv(k) → +x."""

    def __init__(self, channels: int, kernel_size: int,
                 dilations: Sequence[int]):
        super().__init__()
        self.convs1 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=(kernel_size - 1) * d // 2)
            for d in dilations)
        self.convs2 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size,
                      padding=(kernel_size - 1) // 2)
            for _ in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            h = conv_in(c1, F.leaky_relu(x, LRELU_SLOPE))
            x = x + conv_in(c2, F.leaky_relu(h, LRELU_SLOPE))
        return x


class ResBlock2(nn.Module):
    """HiFi-GAN V3's resblock: per dilation d, LReLU → conv(k, dil d) →
    +x."""

    def __init__(self, channels: int, kernel_size: int,
                 dilations: Sequence[int]):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=(kernel_size - 1) * d // 2)
            for d in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs:
            x = x + conv_in(conv, F.leaky_relu(x, LRELU_SLOPE))
        return x


class HiFiGANGenerator(nn.Module):
    def __init__(self, config: HiFiGANConfig = HiFiGANConfig()):
        super().__init__()
        c = self.config = config
        ch = c.upsample_initial_channel
        block = ResBlock1 if str(c.resblock) == "1" else ResBlock2
        self.conv_pre = nn.Conv1d(c.n_mels, ch, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(c.upsample_rates,
                                       c.upsample_kernel_sizes)):
            ch_out = c.upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(nn.ConvTranspose1d(ch, ch_out, k, u,
                                               padding=(k - u) // 2))
            for rk, rd in zip(c.resblock_kernel_sizes,
                              c.resblock_dilation_sizes):
                self.resblocks.append(block(ch_out, rk, rd))
            ch = ch_out
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        n_kernels = len(self.config.resblock_kernel_sizes)
        x = mel.transpose(1, 2)
        if self.config.compute_dtype != "float32":
            x = x.to(self.config.dtype)
        x = conv_in(self.conv_pre, x)
        for i, up in enumerate(self.ups):
            x = conv_in(up, F.leaky_relu(x, LRELU_SLOPE))
            blocks = self.resblocks[i * n_kernels:(i + 1) * n_kernels]
            acc = blocks[0](x)
            for block in blocks[1:]:
                acc = acc + block(x)
            x = acc / n_kernels
        # the waveform's last linear map in the parameters' dtype (f32),
        # whatever the compute dtype
        x = self.conv_post(F.leaky_relu(x.to(self.conv_post.weight.dtype),
                                        0.01))
        return torch.tanh(x)[:, 0]
