"""Flash attention: the CUDA kernel ``csrc/flash_attention.cu`` and its
plain versions.

The kernel replaces the TPU kernel ``flash_attention`` of
``smart_nar_fast_tts_tpu/ops/pallas/attention.py``.  Like it, it rounds
q·scale, k, v and the probabilities to bf16 and accumulates in f32, so it
agrees with the f32 plain version :func:`attention_reference` to bf16
precision (~1e-2), and with :func:`attention_bf16_reference`, which rounds at
the same points, to the difference between an online and a two-pass softmax
(~1e-3).  Its products run on Hopper's tensor cores (``wgmma``); for f32
inputs the wrapper allocates bf16 scratch for the rounded k and v.

The TPU kernel takes any head dim D.  The tensor-core kernel takes D 64
or 128; below 128 the wrapper zero-pads q, k and v along D to the next of
the two and slices the output (exact: zero columns add exact zeros to every
score, and the scale stays 1/√D of the true D), and past 128 it launches the
general kernel of ``csrc/attention_general.cu``, which rounds at the same
points with f32 CUDA-core sums and takes any D.  ``flash_attention.launches``
counts the tensor-core kernel's launches, ``.general_launches`` the general
kernel's.

Its backward, as the TPU kernel's ``custom_vjp``, recomputes the f32 plain
version and returns that function's vector-Jacobian product: the gradient of
the f32 function, which differs from the bf16 forward by the same rounding.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
NEG_INF = -1e30     # an invalid key's score in the TPU kernel


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


def attention_bf16_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, key_valid: torch.Tensor,
                             scale: float | None = None) -> torch.Tensor:
    """Plain version that rounds where the TPU kernel does, with a two-pass
    softmax: bf16(q·scale) (the product in f32), bf16 k and v, f32 scores,
    an invalid key's score -1e30, ``p = exp(s − m)·mask`` in f32 and rounded
    to bf16 for the PV product, the sum l of the f32 ``p``, ``out = PV /
    max(l, 1e-37)``.  For tests and ``chip_smoke.py``: it pins the kernel's
    rounding points more tightly than :func:`attention_reference`.
    ``scale`` defaults to 1/√D of q's last axis (the tests pass the true
    D's when they zero-pad D, as the wrapper does)."""
    bf16 = torch.bfloat16
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qs = (q.float() * scale).to(bf16).float()
    scores = torch.einsum("bhqd,bhkd->bhqk", qs, k.to(bf16).float())
    valid = key_valid[:, None, None, :]
    scores = torch.where(valid, scores, NEG_INF)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True)) * valid
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(bf16).float(),
                       v.to(bf16).float())
    return (out / torch.clamp(l, min=1e-37)).to(q.dtype)


def attention_bf16_tolerance(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, key_valid: torch.Tensor,
                             ref: torch.Tensor) -> torch.Tensor:
    """Per-element bound on how far an output that rounds where the TPU
    kernel does may lie from ``ref = attention_bf16_reference(q, k, v,
    key_valid)``: 1e-3 for the order of the f32 sums; plus
    2^-8·Σⱼ pⱼ|vⱼ|/l, since an f32 difference far below bf16 precision
    (another summation order, an online softmax's running max) can tip the
    bf16 rounding of a probability by one ulp, 2^-8 of it, and where a few
    keys dominate that moves the output by up to this much; plus, for a
    bf16 output, one ulp of its own rounding (2^-7·|ref|).  About 5×
    tighter than the f32 plain version's 2e-2 where attention is spread;
    the f32 plain version itself falls outside it where few keys are
    valid."""
    spread = attention_bf16_reference(q, k, v.abs(), key_valid).float()
    tol = 1e-3 + 2.0 ** -8 * spread
    if ref.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * ref.float().abs()
    return tol


# pointers and the stream as c_void_p: ctypes would pass a bare int as 32 bits
_SIGNATURES = {
    "flash_attention_forward": (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
    "flash_attention_error_string": ([ctypes.c_int], ctypes.c_char_p),
    "flash_attention_smem_bytes": ([ctypes.c_int] * 2, ctypes.c_int),
}
# csrc/attention_general.cu, the general kernels of this wrapper and of
# alignment_attention (one library: its signatures are set once)
GENERAL_SIGNATURES = {
    "flash_attention_general_forward": (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
    "alignment_attention_general_forward": (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
    "attention_general_error_string": ([ctypes.c_int], ctypes.c_char_p),
}
TC_HEAD_DIMS = (64, 128)    # the head dims of the tensor-core kernel


def padded_head_dim(d: int) -> int:
    """The tensor-core kernel's head dim for a head dim d ≤ 128: the
    smallest of 64 and 128 that holds it."""
    return next(w for w in TC_HEAD_DIMS if d <= w)


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


def _launch_general(q, k, v, key_valid):
    B, H, Lq, D = q.shape
    lib = _build.load("attention_general", GENERAL_SIGNATURES)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        status = lib.flash_attention_general_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
            out.data_ptr(), B, H, Lq, k.shape[2], D, _DTYPE_CODES[q.dtype],
            1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError(
            "flash_attention: general kernel launch failed: "
            + lib.attention_general_error_string(status).decode())
    flash_attention.general_launches += 1
    return out


def _launch(q, k, v, key_valid):
    B, H, Lq, D = q.shape
    if D > TC_HEAD_DIMS[-1]:
        return _launch_general(q, k, v, key_valid)
    width = padded_head_dim(D)
    if width != D:
        q, k, v = (F.pad(t, (0, width - D)) for t in (q, k, v))
    Lk = k.shape[2]
    lib = _build.load("flash_attention", _SIGNATURES)
    out = torch.empty_like(q)
    # f32: the kernel rounds k and v to bf16 here first (TMA reads bf16)
    scratch = (torch.empty((2, B, H, Lk, width), dtype=torch.bfloat16,
                           device=q.device)
               if q.dtype == torch.float32 else None)
    with torch.cuda.device(q.device):
        status = lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
            out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            B, H, Lq, Lk, width, _DTYPE_CODES[q.dtype],
            1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError("flash_attention: launch failed: "
                           + lib.flash_attention_error_string(status).decode())
    flash_attention.launches += 1
    return out if width == D else out[..., :D].contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_valid: torch.Tensor) -> torch.Tensor:
    """Masked attention ``softmax(QKᵀ/√D)V`` over (B, H, L, D) tensors.

    A CPU tensor takes :func:`attention_reference`.  A CUDA tensor launches
    the tensor-core kernel for D ≤ 128 (zero-padded to 64 or 128) and the
    general kernel past it: q, k, v contiguous and 16-byte aligned, all f32
    or all bf16; key_valid (B, Lk) bool.  The output has q's dtype and, on CUDA, a
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
    if D < 1:
        raise ValueError(f"flash_attention: head dim {D}")
    tensors = (q, k, v, key_valid)
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_attention: inputs on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be 16-byte aligned")
    return _FlashAttention.apply(q, k, v, key_valid, _launch)


flash_attention.launches = 0
flash_attention.general_launches = 0
