"""HiFi-GAN V1 generator: log-mel (B, T, n_mels) → waveform (B, T·hop).

The plain-tail, dilated-transpose math of the JAX generator (its ``grouped``
and ``polyphase`` forms are TPU lowerings of the same function with the same
parameters) as stock ``nn.Conv1d`` / ``nn.ConvTranspose1d``: conv_pre 80→512
k7; four transposed-conv stages (rates 8, 8, 2, 2, kernels 16, 16, 4, 4,
padding (k-u)//2, channels halving); multi-receptive-field ResBlock1s
k ∈ {3, 7, 11} with dilations (1, 3, 5); LeakyReLU 0.1 between stages and
0.01 before conv_post (upstream's torch default); tanh.  Module names follow
the upstream torch generator with weight norm folded.
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

    def __post_init__(self):
        for name in ("upsample_rates", "upsample_kernel_sizes",
                     "resblock_kernel_sizes", "resblock_dilation_sizes"):
            object.__setattr__(self, name, _as_tuple(getattr(self, name)))
        if str(self.resblock) != "1":
            raise ValueError("only ResBlock1 (HiFi-GAN V1) is ported")

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
        }

    @classmethod
    def from_dict(cls, d: dict) -> "HiFiGANConfig":
        """From the ``config`` dict of ``vocoder_meta.json`` or an upstream
        ``config.json`` (``num_mels`` for ``n_mels``); the keys that choose
        the JAX package's TPU lowerings are ignored."""
        keep = {k: d[k] for k in (
            "resblock", "upsample_rates", "upsample_kernel_sizes",
            "upsample_initial_channel", "resblock_kernel_sizes",
            "resblock_dilation_sizes", "n_mels", "sampling_rate") if k in d}
        if "num_mels" in d:
            keep["n_mels"] = d["num_mels"]
        return cls(**keep)


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
            h = c1(F.leaky_relu(x, LRELU_SLOPE))
            x = x + c2(F.leaky_relu(h, LRELU_SLOPE))
        return x


class HiFiGANGenerator(nn.Module):
    def __init__(self, config: HiFiGANConfig = HiFiGANConfig()):
        super().__init__()
        c = self.config = config
        ch = c.upsample_initial_channel
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
                self.resblocks.append(ResBlock1(ch_out, rk, rd))
            ch = ch_out
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        n_kernels = len(self.config.resblock_kernel_sizes)
        x = self.conv_pre(mel.transpose(1, 2))
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            blocks = self.resblocks[i * n_kernels:(i + 1) * n_kernels]
            acc = blocks[0](x)
            for block in blocks[1:]:
                acc = acc + block(x)
            x = acc / n_kernels
        x = self.conv_post(F.leaky_relu(x, 0.01))
        return torch.tanh(x)[:, 0]
