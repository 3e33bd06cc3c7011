"""Alignment attention: the CUDA kernel ``csrc/alignment_attention.cu`` and
its plain version.

The kernel replaces the TPU kernel ``alignment_attention`` of
``smart_nar_fast_tts_tpu/ops/pallas/alignment.py``.  The MelEncoder's
cross-attention needs, besides ``P·V``, only two reductions of head 0's
probabilities: the per-frame argmax over the text axis (duration targets)
and the guided-attention numerator ``Σ W·p`` over the valid (frame, phoneme)
pairs.  The kernel returns exactly those, and the (B, H, T, L)
probabilities never reach device memory.

Its products run on the tensor cores in 3xTF32, the counterpart of the TPU
kernel's ``Precision.HIGHEST``: each operand of QKᵀ and of PV (q, k, the
unnormalised probabilities and v) is split into two tf32 parts, ``hi =
tf32(x)`` and ``lo = tf32(x − hi)``, both rounded to nearest, and a product
sums ``hi·hi + hi·lo + lo·hi`` in f32.  That is about f32 accuracy (the
dropped ``lo·lo`` weighs ~2⁻²²), so the kernel is held to the f32 plain
version :func:`alignment_reference` at the f32 tolerances (``out`` 1e-5,
``idx`` exact: near-ties in the argmax decide duration targets), and its
``out`` to :func:`alignment_tf32x3_reference`, which rounds its operands
where the kernel does, within 8e-6 (the order of the f32 sums in the
scores, not the rounding points, makes the rest of the gap).  Single-pass
TF32 (~1e-3) would fail both.

The TPU kernel takes any head dim D; the tensor-core kernel takes a
multiple of 4 up to 128.  Below 128 the wrapper zero-pads q, k and v along
D to the next multiple of 4 and slices the output (exact: zero columns add
exact zeros, and the temperature stays 1/√D of the true D); past 128 it
launches the general kernel of ``csrc/attention_general.cu``: f32 CUDA-core
products (no split), the same argmax and guided numerator, held to the same
tolerances.  ``alignment_attention.launches`` counts the tensor-core
kernel's launches, ``.general_launches`` the general kernel's.

Its backward, as the TPU kernel's ``custom_vjp``, recomputes ``out`` and the
numerator with the plain version and differentiates them; the argmax has no
gradient.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import _build
from .attention import GENERAL_SIGNATURES

# the masked score, as the TPU kernel's NEG_INF
NEG_INF = -1e30

# pointers and the stream as c_void_p: ctypes would pass a bare int as 32 bits
_SIGNATURES = {
    "alignment_attention_forward": (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
    "alignment_attention_tiles": ([ctypes.c_int], ctypes.c_int),
    "alignment_attention_smem_bytes": ([ctypes.c_int], ctypes.c_int),
    "alignment_attention_error_string": ([ctypes.c_int], ctypes.c_char_p),
}
MAX_TC_HEAD_DIM = 128       # the tensor-core kernel's widest head dim


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

    L = k.shape[2]
    w, pair_valid = guided_weight(q.shape[2], L, src_lens, mel_lens, sigma)
    gnum = torch.where(pair_valid, w * p[:, 0], 0.0).sum(dim=(1, 2))
    return out, _first_argmax(masked[:, 0].detach()), gnum


def _first_argmax(scores: torch.Tensor) -> torch.Tensor:
    """int32 index of each row's maximum over the last axis, the first
    among equal maxima."""
    L = scores.shape[-1]
    pos = torch.arange(L, device=scores.device)
    hit = scores == scores.amax(dim=-1, keepdim=True)
    return torch.where(hit, pos, L).amin(dim=-1).to(torch.int32)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to tf32 (10 explicit mantissa bits), to nearest
    with ties away from zero, as ``cvt.rna.tf32.f32``."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _product_tf32x3(equation: str, a: torch.Tensor, b: torch.Tensor
                    ) -> torch.Tensor:
    """``einsum(equation, a, b)`` in 3xTF32: each operand split as ``hi =
    tf32(x)``, ``lo = tf32(x − hi)``; ``lo·hi + hi·lo`` then ``hi·hi``, f32
    sums (the products of tf32 values are exact in f32)."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    a_lo, b_lo = tf32_round(a - a_hi), tf32_round(b - b_hi)
    small = (torch.einsum(equation, a_lo, b_hi)
             + torch.einsum(equation, a_hi, b_lo))
    return small + torch.einsum(equation, a_hi, b_hi)


def alignment_tf32x3_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, key_valid: torch.Tensor,
                               src_lens: torch.Tensor, mel_lens: torch.Tensor,
                               sigma: float = 0.2, scale: float | None = None
                               ) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Plain version that rounds where the kernel does: scores =
    3xTF32(q, k) · f32(1/√D); an invalid key's score -1e30; ``e = exp(s −
    m)·mask`` in f32; ``l = max(Σe, 1e-37)``; ``out = 3xTF32(e, v) ·
    (1/l)``; ``gnum = Σ_t (Σ_n W·e) · (1/l)`` over the valid pairs; ``idx``
    the first argmax of head 0's masked scores.  For tests and
    ``chip_smoke.py``: it pins the kernel's rounding points more tightly
    than :func:`alignment_reference`.  Matmuls must run in f32 (TF32 off).
    ``scale`` defaults to 1/√D of q's last axis (the tests pass the true
    D's when they zero-pad D, as the wrapper does)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = _product_tf32x3("bhqd,bhkd->bhqk", q, k) * scale
    valid = key_valid[:, None, None, :]
    masked = torch.where(valid, scores, NEG_INF)
    e = torch.exp(masked - masked.amax(dim=-1, keepdim=True)) * valid
    inv = 1.0 / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-37)
    out = _product_tf32x3("bhqk,bhkd->bhqd", e, v) * inv

    w, pair_valid = guided_weight(q.shape[2], k.shape[2], src_lens,
                                  mel_lens, sigma)
    rows = torch.where(pair_valid, w * e[:, 0], 0.0).sum(dim=-1)
    gnum = (rows * inv[:, 0, :, 0]).sum(dim=-1)
    return out, _first_argmax(masked[:, 0]), gnum


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


def _launch_general(q, k, v, key_valid, src, mel, sigma):
    B, H, T, D = q.shape
    lib = _build.load("attention_general", GENERAL_SIGNATURES)
    out = torch.empty_like(q)
    idx = torch.empty((B, T), dtype=torch.int32, device=q.device)
    row_gnum = torch.empty((B, T), dtype=torch.float32, device=q.device)
    gnum = torch.empty((B,), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        status = lib.alignment_attention_general_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
            src.data_ptr(), mel.data_ptr(), out.data_ptr(), idx.data_ptr(),
            row_gnum.data_ptr(), gnum.data_ptr(), B, H, T, k.shape[2], D,
            1.0 / math.sqrt(D), 2.0 * float(sigma) ** 2,
            torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError(
            "alignment_attention: general kernel launch failed: "
            + lib.attention_general_error_string(status).decode())
    alignment_attention.general_launches += 1
    return out, idx, gnum


def _launch(q, k, v, key_valid, src_lens, mel_lens, sigma):
    B, H, T, D = q.shape
    L = k.shape[2]
    src = src_lens.to(torch.int32).contiguous()
    mel = mel_lens.to(torch.int32).contiguous()
    if D > MAX_TC_HEAD_DIM:
        return _launch_general(q, k, v, key_valid, src, mel, sigma)
    width = -(-D // 4) * 4
    if width != D:
        q, k, v = (F.pad(t, (0, width - D)) for t in (q, k, v))
    lib = _build.load("alignment_attention", _SIGNATURES)
    out = torch.empty_like(q)
    idx = torch.empty((B, T), dtype=torch.int32, device=q.device)
    partial = torch.empty((B, lib.alignment_attention_tiles(T)),
                          dtype=torch.float32, device=q.device)
    gnum = torch.empty((B,), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        status = lib.alignment_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
            src.data_ptr(), mel.data_ptr(), out.data_ptr(), idx.data_ptr(),
            partial.data_ptr(), gnum.data_ptr(), B, H, T, L, width,
            1.0 / math.sqrt(D), 2.0 * float(sigma) ** 2,
            torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError(
            "alignment_attention: launch failed: "
            + lib.alignment_attention_error_string(status).decode())
    alignment_attention.launches += 1
    return (out if width == D else out[..., :D].contiguous()), idx, gnum


def alignment_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_valid: torch.Tensor, src_lens: torch.Tensor,
                        mel_lens: torch.Tensor, sigma: float = 0.2
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Alignment cross-attention of mel-frame queries q (B, H, T, D) over
    text keys and values k, v (B, H, L, D); key_valid (B, L) bool,
    src_lens and mel_lens (B,).  Returns (out (B, H, T, D), idx (B, T)
    int32, gnum (B,) f32), as :func:`alignment_reference`.

    A CPU tensor takes the plain version.  A CUDA tensor launches the
    tensor-core kernel for D ≤ 128 (zero-padded to a multiple of 4) and the
    general kernel past it: q, k, v contiguous float32 (16-byte aligned),
    any L, with a backward through :class:`_AlignmentAttention`."""
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
    if D < 1:
        raise ValueError(f"alignment_attention: head dim {D}")
    tensors = (q, k, v, key_valid, src_lens, mel_lens)
    if any(t.device != q.device for t in tensors):
        raise ValueError("alignment_attention: inputs on different devices")
    if not all(t.is_contiguous() for t in (q, k, v, key_valid)):
        raise ValueError("alignment_attention: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("alignment_attention: q, k, v must be 16-byte "
                         "aligned")
    return _AlignmentAttention.apply(q, k, v, key_valid, src_lens, mel_lens,
                                     sigma, _launch)


alignment_attention.launches = 0
alignment_attention.general_launches = 0
