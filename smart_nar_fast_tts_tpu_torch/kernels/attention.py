"""Flash attention: the CUDA kernel ``csrc/flash_attention.cu`` and its
plain version.

The kernel replaces the TPU kernel ``flash_attention`` of
``smart_nar_fast_tts_tpu/ops/pallas/attention.py``.  Like it, it rounds
q·scale, k, v and the probabilities to bf16 and accumulates in f32, so it
agrees with the f32 plain version to bf16 precision (~1e-2), not f32.

Its backward, as the TPU kernel's ``custom_vjp``, recomputes the f32 plain
version and returns that function's vector-Jacobian product: the gradient of
the f32 function, which differs from the bf16 forward by the same rounding.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def masked_softmax(scores: torch.Tensor, key_valid: torch.Tensor
                   ) -> torch.Tensor:
    """Softmax over the last axis with invalid keys excluded; a row with no
    valid key is all zeros instead of NaN."""
    info = torch.finfo(scores.dtype)
    masked = torch.where(key_valid, scores, info.min)
    m = masked.amax(dim=-1, keepdim=True)
    p = torch.exp(masked - m) * key_valid
    denom = p.sum(dim=-1, keepdim=True)
    return p / torch.clamp(denom, min=info.tiny)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_valid: torch.Tensor) -> torch.Tensor:
    """Plain version: f32 masked attention ``softmax(QKᵀ/√D)V``.

    q (B, H, Lq, D), k/v (B, H, Lk, D), key_valid (B, Lk) bool; returns
    (B, H, Lq, D) in q's dtype, zero rows where no key is valid."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(q.shape[-1])
    p = masked_softmax(scores, key_valid[:, None, None, :])
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


# pointers and the stream as c_void_p: ctypes would pass a bare int as 32 bits
_SIGNATURES = {
    "flash_attention_forward": (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
    "flash_attention_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


class _FlashAttention(torch.autograd.Function):
    """``launch`` (the kernel) forward; the VJP of the f32
    :func:`attention_reference`, recomputed, backward."""

    @staticmethod
    def forward(ctx, q, k, v, key_valid, launch):
        ctx.save_for_backward(q, k, v, key_valid)
        return launch(q, k, v, key_valid)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, key_valid = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (q, k, v)]
            out = attention_reference(*inputs, key_valid)
        dq, dk, dv = torch.autograd.grad(out, inputs, grad_out)
        return dq, dk, dv, None, None


def _launch(q, k, v, key_valid):
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    lib = _build.load("flash_attention", _SIGNATURES)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        status = lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
            out.data_ptr(), B, H, Lq, Lk, D, _DTYPE_CODES[q.dtype],
            1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError("flash_attention: launch failed: "
                           + lib.flash_attention_error_string(status).decode())
    flash_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_valid: torch.Tensor) -> torch.Tensor:
    """Masked attention ``softmax(QKᵀ/√D)V`` over (B, H, L, D) tensors.

    A CPU tensor takes :func:`attention_reference`.  A CUDA tensor launches
    the kernel: q, k, v contiguous, all f32 or all bf16, D 64 or 128;
    key_valid (B, Lk) bool.  The output has q's dtype and, on CUDA, a
    backward through :class:`_FlashAttention`."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, key_valid)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if k.shape != (B, H, Lk, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if key_valid.shape != (B, Lk) or key_valid.dtype != torch.bool:
        raise ValueError("flash_attention: key_valid must be (B, Lk) bool, "
                         f"got {tuple(key_valid.shape)} {key_valid.dtype}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k, v must all be float32 or "
                         f"all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in (64, 128):
        raise ValueError(f"flash_attention: head dim {D} is not 64 or 128")
    tensors = (q, k, v, key_valid)
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_attention: inputs on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention: inputs must be contiguous")
    return _FlashAttention.apply(q, k, v, key_valid, _launch)


flash_attention.launches = 0
