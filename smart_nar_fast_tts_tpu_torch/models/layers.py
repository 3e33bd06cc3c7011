"""Transformer building blocks: post-LN multi-head attention (self, cross,
and the alignment mode), conv FFN, FFT block, Prenet, masked BatchNorm and
PostNet.

Module and attribute names follow the reference PyTorch state dict
(``slf_attn.w_qs``, ``crs_attn.w_qs``, ``pos_ffn.w_1``,
``postnet.convolutions.{i}.0.conv``, …), the key space
``smart_nar_fast_tts_tpu/models/convert.py`` maps; tensors are feature-last
(B, L, C) at every module boundary, as in the JAX package.

Two switches, kept apart: ``module.train()`` makes BatchNorm use batch
statistics (and update its running ones); a ``torch.Generator`` passed as
``generator`` turns dropout on, its masks drawn from that generator.
``generator=None`` means no dropout.

An FFT block computes in the dtype of its input (the bf16 policy of
``ModelConfig.compute_dtype``): its f32 parameters are rounded to a bf16
input's dtype for each call, as flax's ``dtype=bfloat16`` modules do; the
attention scores, softmax and the products with the probabilities are f32
sums of bf16 operands (JAX's ``preferred_element_type=float32``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import alignment_attention, einsum_attention, flash_attention
from ..parallel import all_reduce, all_reduce_sum
from ..parallel.sequence import sequence_parallel_self_attention

# torch nn.LayerNorm eps, as the JAX package's LN_EPS
LN_EPS = 1e-5

# self-attention runs the flash kernel only past this many frames, as the
# JAX model does (smart_nar_fast_tts_tpu/models/layers.py:106-107); shorter
# self-attention takes the model's f32 einsum branch
FLASH_MIN_LEN = 2048


def conv_last(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """Apply a Conv1d to feature-last (B, T, C) input, in x's dtype."""
    x = x.transpose(1, 2)
    if conv.weight.dtype != x.dtype:
        y = conv._conv_forward(x, conv.weight.to(x.dtype),
                               conv.bias.to(x.dtype))
    else:
        y = conv(x)
    return y.transpose(1, 2)


def linear_in(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``lin(x)`` in x's dtype."""
    if lin.weight.dtype == x.dtype:
        return lin(x)
    return F.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))


def layer_norm_in(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """``norm(x)`` in x's dtype."""
    if norm.weight.dtype == x.dtype:
        return norm(x)
    return F.layer_norm(x, norm.normalized_shape, norm.weight.to(x.dtype),
                        norm.bias.to(x.dtype), norm.eps)


def zero_where_not(valid: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x with rows where ``valid`` (B, T) or (T,) is False set to 0."""
    return torch.where(valid[..., None], x, 0.0)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout as flax's ``nn.Dropout``: keep with probability
    1 - rate and scale by 1 / (1 - rate); x itself when ``generator`` is
    None or the rate is 0."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class ConvNorm(nn.Module):
    """A Conv1d with "same" padding under the name ``conv``."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, kernel_size, padding="same")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_last(self.conv, x)


class MultiHeadAttention(nn.Module):
    """Post-LN multi-head attention: projections → masked attention → head
    concat → fc → dropout → LayerNorm(out + x).

    - Given ``lens = (src_lens, mel_lens)``, the cross-attention runs the
      alignment kernel and returns only ``{"argmax": (B, Lq) int32,
      "guided_num": (B,)}`` of head 0.
    - Self-attention (``kv`` None) with ``sp_mesh`` runs ring attention,
      the time axis split over ``sp_axis`` (the MelDecoder's under
      ``ModelConfig.sequence_parallel``), and returns no maps.
    - Other self-attention with ``max(Lq, Lk) > FLASH_MIN_LEN`` runs the
      flash kernel on CUDA and returns no maps.
    - Shorter self-attention, and cross-attention over ``kv``, run the f32
      einsum branch (on a bf16 input: f32 products of the bf16 q, k, and
      of the bf16-rounded probabilities with v) and return the full
      (B, H, Lq, Lk) ``masked_softmax`` maps (self-attention's are
      discarded by the caller).

    The order is the JAX model's (``models/layers.py:87-117`` there).
    """

    def __init__(self, d_model: int, n_head: int, dropout_rate: float = 0.0,
                 guided_sigma: float = 0.2):
        super().__init__()
        self.n_head = n_head
        self.d_k = d_model // n_head
        self.dropout_rate = dropout_rate
        self.guided_sigma = guided_sigma
        width = n_head * self.d_k
        self.w_qs = nn.Linear(d_model, width)
        self.w_ks = nn.Linear(d_model, width)
        self.w_vs = nn.Linear(d_model, width)
        self.fc = nn.Linear(width, d_model)
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x: torch.Tensor, key_valid: torch.Tensor,
                kv: Optional[torch.Tensor] = None,
                lens: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                sp_mesh=None, sp_axis: str = "data"):
        B, Lq, _ = x.shape
        src = x if kv is None else kv
        Lk = src.shape[1]

        def heads(lin, inp, L):
            return (linear_in(lin, inp).view(B, L, self.n_head, self.d_k)
                    .transpose(1, 2).contiguous())

        q = heads(self.w_qs, x, Lq)
        k = heads(self.w_ks, src, Lk)
        v = heads(self.w_vs, src, Lk)
        if lens is not None:
            out, idx, gnum = alignment_attention(
                q, k, v, key_valid, lens[0], lens[1], self.guided_sigma)
            attn = {"argmax": idx, "guided_num": gnum}
        elif kv is None and sp_mesh is not None:
            # the einsum branch below on this rank's query rows
            attn = None
            out = sequence_parallel_self_attention(sp_mesh, q, k, v,
                                                   key_valid, sp_axis)
        elif kv is None and max(Lq, Lk) > FLASH_MIN_LEN:
            attn = None
            out = flash_attention(q, k, v, key_valid)
        else:
            out, attn = einsum_attention(q, k, v, key_valid)
        out = out.transpose(1, 2).reshape(B, Lq, self.n_head * self.d_k)
        out = dropout(linear_in(self.fc, out.to(x.dtype)), self.dropout_rate,
                      generator)
        return layer_norm_in(self.layer_norm, out + x), attn


class ConvFFN(nn.Module):
    """Position-wise conv feed-forward, post-LN.  ``cap_valid`` (T,) zeroes
    the hidden activations beyond the batch's longest item, where the
    reference's tensors end, before a second conv wider than 1."""

    def __init__(self, d_model: int, d_inner: int,
                 kernel_sizes: tuple[int, int], dropout_rate: float = 0.0):
        super().__init__()
        self.kernel_sizes = tuple(kernel_sizes)
        self.dropout_rate = dropout_rate
        self.w_1 = nn.Conv1d(d_model, d_inner, kernel_sizes[0],
                             padding="same")
        self.w_2 = nn.Conv1d(d_inner, d_model, kernel_sizes[1],
                             padding="same")
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x: torch.Tensor,
                cap_valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = torch.relu(conv_last(self.w_1, x))
        if cap_valid is not None and self.kernel_sizes[1] > 1:
            h = zero_where_not(cap_valid, h)
        h = dropout(conv_last(self.w_2, h), self.dropout_rate, generator)
        return layer_norm_in(self.layer_norm, h + x)


class FFTBlock(nn.Module):
    """Attention + conv FFN, with padded positions zeroed after each.  A
    cross-attention block (``cross``, the MelEncoder's) names its attention
    ``crs_attn``, a self-attention block ``slf_attn``, as the reference."""

    def __init__(self, d_model: int, n_head: int, d_inner: int,
                 kernel_sizes: tuple[int, int], dropout_rate: float = 0.0,
                 cross: bool = False, guided_sigma: float = 0.2):
        super().__init__()
        self.attn_name = "crs_attn" if cross else "slf_attn"
        self.add_module(self.attn_name, MultiHeadAttention(
            d_model, n_head, dropout_rate, guided_sigma))
        self.pos_ffn = ConvFFN(d_model, d_inner, kernel_sizes, dropout_rate)

    def forward(self, x: torch.Tensor, valid: torch.Tensor,
                cap_valid: Optional[torch.Tensor] = None,
                kv: Optional[torch.Tensor] = None,
                kv_valid: Optional[torch.Tensor] = None,
                lens: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                sp_mesh=None, sp_axis: str = "data"):
        """Returns (out, attention maps or the alignment reductions or
        None)."""
        key_valid = valid if kv_valid is None else kv_valid
        out, attn = getattr(self, self.attn_name)(x, key_valid, kv, lens,
                                                  generator, sp_mesh,
                                                  sp_axis)
        out = zero_where_not(valid, out)
        out = self.pos_ffn(out, cap_valid, generator)
        return zero_where_not(valid, out), attn


class Prenet(nn.Module):
    """Mel prenet: two Linear + ReLU layers, then dropout 0.2."""

    DROPOUT = 0.2

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.w_1 = nn.Linear(d_in, d_out)
        self.w_2 = nn.Linear(d_out, d_out)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = torch.relu(self.w_2(torch.relu(self.w_1(x))))
        return dropout(h, self.DROPOUT, generator)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the channel axis of (B, C, T) input:
    ``(x - mean) / sqrt(var + eps) * weight + bias``.

    In eval mode mean and var are the running statistics.  In train mode
    they are the batch's, over (batch, time) restricted to ``cap_valid``
    (T,) when given: the biased variance normalises, and the running
    statistics move by momentum 0.1 towards the mean and the unbiased
    variance, as ``torch.nn.BatchNorm1d`` on tensors cut to the batch's
    longest item.

    Under a data ``group`` (each rank holding its rows of the batch) the
    statistics are the whole batch's: the masked sums and the count are
    summed over the group, by an all-reduce whose backward is an
    all-reduce, so the running statistics move alike on every rank."""

    MOMENTUM = 0.1

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor,
                cap_valid: Optional[torch.Tensor] = None,
                group=None) -> torch.Tensor:
        if self.training:
            if cap_valid is None:
                m = torch.ones((1, 1, x.shape[2]), dtype=x.dtype,
                               device=x.device)
            else:
                m = cap_valid.to(x.dtype)[None, None, :]
            n = torch.clamp(all_reduce(m.sum() * x.shape[0], group),
                            min=1.0)
            mean = all_reduce_sum((x * m).sum(dim=(0, 2)), group) / n
            var = all_reduce_sum(((x - mean[:, None]) ** 2 * m).sum(
                dim=(0, 2)), group) / n
            with torch.no_grad():
                unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
                self.running_mean.mul_(1 - self.MOMENTUM).add_(
                    self.MOMENTUM * mean)
                self.running_var.mul_(1 - self.MOMENTUM).add_(
                    self.MOMENTUM * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean[:, None]) * torch.rsqrt(var + self.eps)[:, None]
        return y * self.weight[:, None] + self.bias[:, None]


class PostNet(nn.Module):
    """Five conv1d(k=5) + BatchNorm layers over mels, tanh on all but the
    last, dropout 0.5 after each.  The caller adds the residual.
    ``cap_valid`` (T,) zeroes each conv's input beyond the batch capacity
    and restricts the BatchNorm's batch statistics to it; ``data_group``
    takes those statistics over the whole batch (``MaskedBatchNorm``)."""

    DROPOUT = 0.5

    def __init__(self, n_mels: int = 80, d_hidden: int = 512,
                 kernel_size: int = 5, n_convs: int = 5):
        super().__init__()
        dims = [n_mels] + [d_hidden] * (n_convs - 1) + [n_mels]
        self.convolutions = nn.ModuleList(
            nn.ModuleList([ConvNorm(dims[i], dims[i + 1], kernel_size),
                           MaskedBatchNorm(dims[i + 1])])
            for i in range(n_convs))

    def forward(self, x: torch.Tensor,
                cap_valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                data_group=None) -> torch.Tensor:
        h = x.transpose(1, 2)                                  # (B, C, T)
        last = len(self.convolutions) - 1
        for i, (conv, bn) in enumerate(self.convolutions):
            if cap_valid is not None:
                h = torch.where(cap_valid[None, None, :], h, 0.0)
            h = bn(conv.conv(h), cap_valid, data_group)
            if i != last:
                h = torch.tanh(h)
            h = dropout(h, self.DROPOUT, generator)
        return h.transpose(1, 2)
