"""Vocos generator: log-mel (B, T, n_mels) → waveform (B, T·hop) through a
ConvNeXt backbone at mel frame rate and an inverse-STFT head.

The port of ``smart_nar_fast_tts_tpu/vocoder/vocos.py``: ``embed`` (conv 7)
→ LayerNorm → ``n_layers`` ConvNeXt blocks (depthwise conv → LayerNorm →
``pw1`` → tanh-GELU → ``pw2`` → ``x + gamma·h``) → LayerNorm → ``head``, a
Linear to log-magnitude and phase per frame, in f32 → :func:`istft_matmul`.
The head's T frames are edge-padded by one frame, so the overlap-add
renders exactly T·hop samples.

Two flax defaults are kept: LayerNorm's epsilon is 1e-6 (torch's is 1e-5)
and ``nn.gelu`` is the tanh approximation.  The depthwise conv is a grouped
``nn.Conv1d`` (the JAX module's shifted multiply-adds are a TPU lowering of
the same sum), padded ``((k-1)//2, k//2)``.  Module names follow the JAX
tree (``blocks.<i>`` for ``block_<i>``), so ``weights.vocos_rules`` maps
one onto the other.

``compute_dtype="bfloat16"`` runs ``embed``, the norms and the blocks in
bf16 with the f32 parameters rounded per call; the head and the iSTFT run
in f32, as the JAX generator.
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..audio.stft import MelSpectrogramConfig, _irdft_bases, istft_matmul
from ..models.layers import conv_last, layer_norm_in, linear_in

# flax nn.LayerNorm's epsilon
LN_EPS = 1e-6
# the magnitude cap (linear scale): exp stays finite for a wild head
_MAX_MAG = 1e2


@dataclass(frozen=True)
class VocosConfig:
    n_mels: int = 80
    dim: int = 512
    intermediate: int = 1536
    n_layers: int = 8
    dw_kernel: int = 7
    n_fft: int = 1024
    hop: int = 256
    win_length: int = 1024
    sampling_rate: int = 22050
    compute_dtype: str = "float32"      # or "bfloat16"

    def __post_init__(self):
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError("compute_dtype must be float32 or bfloat16, "
                             f"got {self.compute_dtype!r}")

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def hop_length(self) -> int:
        """Samples per mel frame."""
        return self.hop

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1

    def stft_config(self) -> MelSpectrogramConfig:
        return MelSpectrogramConfig(
            sampling_rate=self.sampling_rate, n_fft=self.n_fft,
            hop_length=self.hop, win_length=self.win_length,
            n_mels=self.n_mels)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "VocosConfig":
        return cls(**d)


class ConvNeXtBlock1d(nn.Module):
    """Depthwise k-tap frame mixing + pointwise MLP, layer-scaled
    residual, on feature-last (B, T, dim) input in its own dtype."""

    def __init__(self, dim: int, intermediate: int, kernel: int,
                 layer_scale_init: float):
        super().__init__()
        r = (kernel - 1) // 2
        self.dwconv = nn.Conv1d(dim, dim, kernel, groups=dim, padding=r)
        # an even kernel pads one more frame on the right: (r, k // 2)
        self.right = kernel // 2 - r
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.pw1 = nn.Linear(dim, intermediate)
        self.pw2 = nn.Linear(intermediate, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = conv_last(self.dwconv,
                      F.pad(x, (0, 0, 0, self.right)) if self.right else x)
        h = layer_norm_in(self.norm, h)
        h = F.gelu(linear_in(self.pw1, h), approximate="tanh")
        h = linear_in(self.pw2, h)
        return x + self.gamma.to(x.dtype) * h


class VocosGenerator(nn.Module):
    """log-mel (B, T, n_mels) → waveform (B, T·hop)."""

    def __init__(self, config: VocosConfig = VocosConfig()):
        super().__init__()
        c = self.config = config
        self.embed = nn.Conv1d(c.n_mels, c.dim, 7, padding=3)
        self.norm_in = nn.LayerNorm(c.dim, eps=LN_EPS)
        self.blocks = nn.ModuleList(
            ConvNeXtBlock1d(c.dim, c.intermediate, c.dw_kernel,
                            1.0 / c.n_layers) for _ in range(c.n_layers))
        self.norm_out = nn.LayerNorm(c.dim, eps=LN_EPS)
        self.head = nn.Linear(c.dim, 2 * c.n_bins)
        # the inverse-rDFT bases as buffers (not in the state dict): they
        # move with the module and are leaves of an exported program
        cos, sin = _irdft_bases(c.n_fft)
        self.register_buffer("irdft_cos", cos.clone(), persistent=False)
        self.register_buffer("irdft_sin", sin.clone(), persistent=False)
        self._stft = c.stft_config()

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        c = self.config
        x = conv_last(self.embed, mel.to(c.dtype))
        x = layer_norm_in(self.norm_in, x)
        for block in self.blocks:
            x = block(x)
        x = layer_norm_in(self.norm_out, x)
        # the head and the iSTFT in f32: the last linear map sets the SNR
        logm, phase = self.head(x.float()).chunk(2, dim=-1)
        mag = torch.exp(torch.clamp(logm, max=math.log(_MAX_MAG)))
        # (B, T, bins) → (B, bins, T+1): the last frame replicated, so the
        # overlap-add (hop·(F−1) samples) renders T·hop
        mag = torch.cat([mag, mag[:, -1:]], dim=1).transpose(1, 2)
        phase = torch.cat([phase, phase[:, -1:]], dim=1).transpose(1, 2)
        return istft_matmul(mag, phase, self._stft,
                            (self.irdft_cos, self.irdft_sin))


@torch.inference_mode()
def vocos_infer(generator: VocosGenerator, mels, mel_lens=None,
                max_wav_value: float = 32768.0) -> list[np.ndarray]:
    """Batched mel → waveform list on the generator's device: clipped to
    [-1, 1], scaled by ``max_wav_value`` and cut to ``mel_lens·hop``
    samples per item (the JAX package's ``vocos_infer``)."""
    device = next(generator.parameters()).device
    mels = torch.as_tensor(np.asarray(mels, np.float32)).to(device)
    wavs = (torch.clamp(generator(mels), -1.0, 1.0)
            * max_wav_value).float().cpu().numpy()
    if mel_lens is None:
        return list(wavs)
    hop = generator.config.hop_length
    return [w[:int(n) * hop] for w, n in zip(wavs, np.asarray(mel_lens))]
