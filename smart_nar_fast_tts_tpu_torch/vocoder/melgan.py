"""MelGAN generator: log10-mel (B, T, n_mels) → waveform (B, T·hop) in
[-1, 1].

The port of ``smart_nar_fast_tts_tpu/vocoder/melgan.py`` (descript's
melgan-neurips generator, which the reference pulls from torch.hub):
reflect-pad conv 7 → per ratio r [LReLU 0.2 → transposed conv (k 2r, stride
r, padding r/2) → ``n_residual_layers`` resnet blocks of dilation 3ʲ] →
LReLU → reflect-pad conv 7 → tanh.  A resnet block is LReLU → reflect-pad
dilated conv 3 → LReLU → conv 1, plus a 1×1 shortcut.

The modules keep descript's ``nn.Sequential`` layout (``model.<idx>``, a
block's convs at ``block.2`` and ``block.4``, ``shortcut``), so a torch.hub
state dict loads with weight norm folded and ``load_state_dict``
(``vocoder.convert.load_melgan``).  Even ratios only, as the JAX
generator: an odd one would need torch's ``output_padding`` asymmetry.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Sequence

import numpy as np
import torch
from torch import nn

MELGAN_LRELU = 0.2


@dataclass(frozen=True)
class MelGANConfig:
    n_mels: int = 80
    ngf: int = 32
    n_residual_layers: int = 3
    ratios: Sequence[int] = (8, 8, 2, 2)
    sampling_rate: int = 22050

    def __post_init__(self):
        object.__setattr__(self, "ratios", tuple(int(r) for r in self.ratios))

    @property
    def hop_length(self) -> int:
        out = 1
        for r in self.ratios:
            out *= r
        return out

    def to_dict(self) -> dict:
        return {**asdict(self), "ratios": list(self.ratios)}

    @classmethod
    def from_dict(cls, d: dict) -> "MelGANConfig":
        return cls(**d)


class ResnetBlock(nn.Module):
    """descript's ``ResnetBlock``: ``shortcut(x) + block(x)``."""

    def __init__(self, dim: int, dilation: int):
        super().__init__()
        self.block = nn.Sequential(
            nn.LeakyReLU(MELGAN_LRELU),
            nn.ReflectionPad1d(dilation),
            nn.Conv1d(dim, dim, 3, dilation=dilation),
            nn.LeakyReLU(MELGAN_LRELU),
            nn.Conv1d(dim, dim, 1))
        self.shortcut = nn.Conv1d(dim, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.shortcut(x) + self.block(x)


class MelGANGenerator(nn.Module):
    """log10-mel (B, T, n_mels) → waveform (B, T·hop) in [-1, 1]."""

    def __init__(self, config: MelGANConfig = MelGANConfig()):
        super().__init__()
        c = self.config = config
        if any(r % 2 for r in c.ratios):
            raise ValueError("MelGANGenerator supports even ratios only, got "
                             f"{c.ratios}")
        mult = 2 ** len(c.ratios)
        layers: list[nn.Module] = [nn.ReflectionPad1d(3),
                                   nn.Conv1d(c.n_mels, mult * c.ngf, 7)]
        for r in c.ratios:
            ch = mult * c.ngf // 2
            layers += [nn.LeakyReLU(MELGAN_LRELU),
                       nn.ConvTranspose1d(mult * c.ngf, ch, 2 * r, stride=r,
                                          padding=r // 2)]
            layers += [ResnetBlock(ch, 3 ** j)
                       for j in range(c.n_residual_layers)]
            mult //= 2
        layers += [nn.LeakyReLU(MELGAN_LRELU), nn.ReflectionPad1d(3),
                   nn.Conv1d(c.ngf, 1, 7), nn.Tanh()]
        self.model = nn.Sequential(*layers)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return self.model(mel.transpose(1, 2))[:, 0]


@torch.inference_mode()
def melgan_inverse(generator: MelGANGenerator, log_mels, mel_lens=None,
                   max_wav_value: float = 32768.0) -> list[np.ndarray]:
    """The reference's MelGAN branch on the generator's device:
    natural-log mels rescaled to log10 (``/ ln 10``), inverted, scaled by
    ``max_wav_value`` and cut to ``mel_lens·hop`` samples per item."""
    device = next(generator.parameters()).device
    mels = torch.as_tensor(np.asarray(log_mels, np.float32)).to(device)
    wavs = (generator(mels / float(np.log(10.0)))
            * max_wav_value).float().cpu().numpy()
    if mel_lens is None:
        return list(wavs)
    hop = generator.config.hop_length
    return [w[:int(n) * hop] for w, n in zip(wavs, np.asarray(mel_lens))]
