"""Alignment attention: the CUDA kernel ``csrc/alignment_attention.cu`` and
its plain version.

The kernel replaces the TPU kernel ``alignment_attention`` of
``smart_nar_fast_tts_tpu/ops/pallas/alignment.py``.  The MelEncoder's
cross-attention needs, besides ``P·V``, only two reductions of head 0's
probabilities: the per-frame argmax over the text axis (duration targets)
and the guided-attention numerator ``Σ W·p`` over the valid (frame, phoneme)
pairs.  The kernel returns exactly those, and the (B, H, T, L)
probabilities never reach device memory.  It computes in full f32 (scores by
f32 FMA, no TF32, no bf16): near-ties in the argmax decide duration targets.

Its backward, as the TPU kernel's ``custom_vjp``, recomputes ``out`` and the
numerator with the plain version and differentiates them; the argmax has no
gradient.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

# the masked score, as the TPU kernel's NEG_INF
NEG_INF = -1e30

# pointers and the stream as c_void_p: ctypes would pass a bare int as 32 bits
_SIGNATURES = {
    "alignment_attention_forward": (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
    "alignment_attention_tiles": ([ctypes.c_int], ctypes.c_int),
    "alignment_attention_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def guided_weight(T: int, L: int, src_lens: torch.Tensor,
                  mel_lens: torch.Tensor, sigma: float
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The guided-attention weight ``W = 1 − exp(−(n/ilen − t/olen)² /
    2σ²)`` (B, T, L) and its pair mask ``t < olen & n < ilen``."""
    device = src_lens.device
    t = torch.arange(T, dtype=torch.float32, device=device)[None, :, None]
    n = torch.arange(L, dtype=torch.float32, device=device)[None, None, :]
    olen = mel_lens.float()[:, None, None]
    ilen = src_lens.float()[:, None, None]
    w = 1.0 - torch.exp(-((n / ilen - t / olen) ** 2) / (2.0 * sigma ** 2))
    return w, (t < olen) & (n < ilen)


def alignment_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_valid: torch.Tensor, src_lens: torch.Tensor,
                        mel_lens: torch.Tensor, sigma: float = 0.2
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version, in f32: (out (B, H, T, D), idx (B, T) int32 head-0
    argmax of the masked scores, first index among equal maxima, gnum (B,)
    head-0 ``Σ W·p`` over the valid pairs)."""
    d = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(d)
    valid = key_valid[:, None, None, :]
    masked = torch.where(valid, scores, NEG_INF)
    m = masked.amax(dim=-1, keepdim=True)
    p = torch.exp(masked - m) * valid
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-37)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(v.dtype)

    s0 = masked[:, 0].detach()
    L = s0.shape[-1]
    pos = torch.arange(L, device=s0.device)
    hit = s0 == s0.amax(dim=-1, keepdim=True)
    idx = torch.where(hit, pos, L).amin(dim=-1).to(torch.int32)

    w, pair_valid = guided_weight(q.shape[2], L, src_lens, mel_lens, sigma)
    gnum = torch.where(pair_valid, w * p[:, 0], 0.0).sum(dim=(1, 2))
    return out, idx, gnum


class _AlignmentAttention(torch.autograd.Function):
    """``launch`` (the kernel) forward; backward recomputes ``out`` and
    ``gnum`` with :func:`alignment_reference` and returns their VJP for q,
    k and v."""

    @staticmethod
    def forward(ctx, q, k, v, key_valid, src_lens, mel_lens, sigma, launch):
        ctx.save_for_backward(q, k, v, key_valid, src_lens, mel_lens)
        ctx.sigma = sigma
        out, idx, gnum = launch(q, k, v, key_valid, src_lens, mel_lens, sigma)
        ctx.mark_non_differentiable(idx)
        return out, idx, gnum

    @staticmethod
    def backward(ctx, grad_out, _grad_idx, grad_gnum):
        q, k, v, key_valid, src_lens, mel_lens = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (q, k, v)]
            out, _, gnum = alignment_reference(
                *inputs, key_valid, src_lens, mel_lens, ctx.sigma)
        dq, dk, dv = torch.autograd.grad(
            (out, gnum), inputs, (grad_out, grad_gnum))
        return dq, dk, dv, None, None, None, None, None


def _launch(q, k, v, key_valid, src_lens, mel_lens, sigma):
    B, H, T, D = q.shape
    L = k.shape[2]
    lib = _build.load("alignment_attention", _SIGNATURES)
    src = src_lens.to(torch.int32).contiguous()
    mel = mel_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    idx = torch.empty((B, T), dtype=torch.int32, device=q.device)
    partial = torch.empty((B, lib.alignment_attention_tiles(T)),
                          dtype=torch.float32, device=q.device)
    gnum = torch.empty((B,), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        status = lib.alignment_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
            src.data_ptr(), mel.data_ptr(), out.data_ptr(), idx.data_ptr(),
            partial.data_ptr(), gnum.data_ptr(), B, H, T, L, D,
            math.sqrt(D), 2.0 * float(sigma) ** 2,
            torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError(
            "alignment_attention: launch failed: "
            + lib.alignment_attention_error_string(status).decode())
    alignment_attention.launches += 1
    return out, idx, gnum


def alignment_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_valid: torch.Tensor, src_lens: torch.Tensor,
                        mel_lens: torch.Tensor, sigma: float = 0.2
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Alignment cross-attention of mel-frame queries q (B, H, T, D) over
    text keys and values k, v (B, H, L, D); key_valid (B, L) bool,
    src_lens and mel_lens (B,).  Returns (out (B, H, T, D), idx (B, T)
    int32, gnum (B,) f32), as :func:`alignment_reference`.

    A CPU tensor takes the plain version.  A CUDA tensor launches the
    kernel: q, k, v contiguous float32, D a multiple of 4 up to 128, with a
    backward through :class:`_AlignmentAttention`."""
    if q.device.type == "cpu":
        return alignment_reference(q, k, v, key_valid, src_lens, mel_lens,
                                   sigma)
    if q.device.type != "cuda":
        raise ValueError(f"alignment_attention: unsupported device {q.device}")
    B, H, T, D = q.shape
    L = k.shape[2]
    if k.shape != (B, H, L, D) or v.shape != k.shape:
        raise ValueError(f"alignment_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if key_valid.shape != (B, L) or key_valid.dtype != torch.bool:
        raise ValueError("alignment_attention: key_valid must be (B, L) "
                         f"bool, got {tuple(key_valid.shape)} "
                         f"{key_valid.dtype}")
    if src_lens.shape != (B,) or mel_lens.shape != (B,):
        raise ValueError("alignment_attention: src_lens and mel_lens must "
                         "be (B,)")
    if any(t.dtype != torch.float32 for t in (q, k, v)):
        raise ValueError("alignment_attention: q, k, v must be float32")
    if D % 4 or D > 128:
        raise ValueError(f"alignment_attention: head dim {D} is not a "
                         "multiple of 4 up to 128")
    tensors = (q, k, v, key_valid, src_lens, mel_lens)
    if any(t.device != q.device for t in tensors):
        raise ValueError("alignment_attention: inputs on different devices")
    if not all(t.is_contiguous() for t in (q, k, v, key_valid)):
        raise ValueError("alignment_attention: inputs must be contiguous")
    return _AlignmentAttention.apply(q, k, v, key_valid, src_lens, mel_lens,
                                     sigma, _launch)


alignment_attention.launches = 0
