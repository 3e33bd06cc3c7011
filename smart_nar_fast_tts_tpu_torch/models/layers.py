"""Transformer building blocks: post-LN multi-head self-attention, conv FFN,
FFT block, masked BatchNorm (eval) and PostNet.

Module and attribute names follow the reference PyTorch state dict
(``slf_attn.w_qs``, ``pos_ffn.w_1``, ``postnet.convolutions.{i}.0.conv``,
…), the key space ``smart_nar_fast_tts_tpu/models/convert.py`` maps; tensors
are feature-last (B, L, C) at every module boundary, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..kernels import flash_attention

# torch nn.LayerNorm eps, as the JAX package's LN_EPS
LN_EPS = 1e-5


def conv_last(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """Apply a Conv1d to feature-last (B, T, C) input."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


def zero_where_not(valid: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x with rows where ``valid`` (B, T) or (T,) is False set to 0."""
    return torch.where(valid[..., None], x, 0.0)


class ConvNorm(nn.Module):
    """A Conv1d with "same" padding under the name ``conv``."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, kernel_size, padding="same")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_last(self.conv, x)


class MultiHeadAttention(nn.Module):
    """Post-LN multi-head self-attention: projections → masked attention
    (the flash kernel on CUDA) → head concat → fc → LayerNorm(out + x)."""

    def __init__(self, d_model: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.d_k = d_model // n_head
        width = n_head * self.d_k
        self.w_qs = nn.Linear(d_model, width)
        self.w_ks = nn.Linear(d_model, width)
        self.w_vs = nn.Linear(d_model, width)
        self.fc = nn.Linear(width, d_model)
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x: torch.Tensor, key_valid: torch.Tensor
                ) -> torch.Tensor:
        B, L, _ = x.shape

        def heads(lin):
            return (lin(x).view(B, L, self.n_head, self.d_k)
                    .transpose(1, 2).contiguous())

        out = flash_attention(heads(self.w_qs), heads(self.w_ks),
                              heads(self.w_vs), key_valid)
        out = out.transpose(1, 2).reshape(B, L, self.n_head * self.d_k)
        return self.layer_norm(self.fc(out) + x)


class ConvFFN(nn.Module):
    """Position-wise conv feed-forward, post-LN.  ``cap_valid`` (T,) zeroes
    the hidden activations beyond the batch's longest item, where the
    reference's tensors end, before a second conv wider than 1."""

    def __init__(self, d_model: int, d_inner: int,
                 kernel_sizes: tuple[int, int]):
        super().__init__()
        self.kernel_sizes = tuple(kernel_sizes)
        self.w_1 = nn.Conv1d(d_model, d_inner, kernel_sizes[0],
                             padding="same")
        self.w_2 = nn.Conv1d(d_inner, d_model, kernel_sizes[1],
                             padding="same")
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x: torch.Tensor,
                cap_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = torch.relu(conv_last(self.w_1, x))
        if cap_valid is not None and self.kernel_sizes[1] > 1:
            h = zero_where_not(cap_valid, h)
        h = conv_last(self.w_2, h)
        return self.layer_norm(h + x)


class FFTBlock(nn.Module):
    """Self-attention + conv FFN, with padded positions zeroed after each."""

    def __init__(self, d_model: int, n_head: int, d_inner: int,
                 kernel_sizes: tuple[int, int]):
        super().__init__()
        self.slf_attn = MultiHeadAttention(d_model, n_head)
        self.pos_ffn = ConvFFN(d_model, d_inner, kernel_sizes)

    def forward(self, x: torch.Tensor, valid: torch.Tensor,
                cap_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = zero_where_not(valid, self.slf_attn(x, valid))
        return zero_where_not(valid, self.pos_ffn(out, cap_valid))


class MaskedBatchNorm(nn.Module):
    """Inference BatchNorm over the channel axis of (B, C, T) input, from
    the running statistics: ``(x - mean) / sqrt(var + eps) * weight + bias``.
    Training statistics (masked to the batch capacity) come with training."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = torch.rsqrt(self.running_var + self.eps)
        y = (x - self.running_mean[:, None]) * scale[:, None]
        return y * self.weight[:, None] + self.bias[:, None]


class PostNet(nn.Module):
    """Five conv1d(k=5) + BatchNorm layers over mels, tanh on all but the
    last.  The caller adds the residual.  ``cap_valid`` (T,) zeroes each
    conv's input beyond the batch capacity."""

    def __init__(self, n_mels: int = 80, d_hidden: int = 512,
                 kernel_size: int = 5, n_convs: int = 5):
        super().__init__()
        dims = [n_mels] + [d_hidden] * (n_convs - 1) + [n_mels]
        self.convolutions = nn.ModuleList(
            nn.ModuleList([ConvNorm(dims[i], dims[i + 1], kernel_size),
                           MaskedBatchNorm(dims[i + 1])])
            for i in range(n_convs))

    def forward(self, x: torch.Tensor,
                cap_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = x.transpose(1, 2)                                  # (B, C, T)
        last = len(self.convolutions) - 1
        for i, (conv, bn) in enumerate(self.convolutions):
            if cap_valid is not None:
                h = torch.where(cap_valid[None, None, :], h, 0.0)
            h = bn(conv.conv(h))
            if i != last:
                h = torch.tanh(h)
        return h.transpose(1, 2)
