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

The TPU kernel takes any head dim D, and so does the port, on the tensor
cores.  The kernel of ``alignment_attention_forward`` takes a multiple of 4
up to 256 (192 is FastSpeech's 384 hidden over 2 heads) and pads it further
to 32, 64, 128, 192 or 256 as it stages rows; past 256 the wide kernels of
``alignment_attention_wide_forward`` (same file) take any multiple of 4,
splitting the output's columns into slices of at most 192
(:func:`wide_column_slices`): up to D 512 a team of warps, one a slice,
splits each unit's scores by slice and adds the parts; past it each warp
computes the full scores over chunks of D for its slice.  The wrapper
zero-pads q, k and v along D to a multiple of 4 and slices the output
(exact: zero columns add exact zeros, and the temperature stays 1/√D of the
true D).  All are held to the same tolerances;
``alignment_attention.launches`` counts every launch, ``.wide_launches``
those past 256.  :func:`alignment_wide_reference` is the wide kernels'
schedule in plain PyTorch.

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
    "alignment_attention_wide_forward": (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
    "alignment_attention_wide_shape": (
        [ctypes.c_int, ctypes.POINTER(ctypes.c_int)], None),
}
MAX_TC_HEAD_DIM = 256       # the first kernel's widest head dim
WIDE_KC = 32                # the wide kernel's keys a chunk
WIDE_DC = 64                # its columns of D a chunk of the scores
WIDE_GROUPS = 6             # 32-column groups a slice at most (192)


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


def wide_column_slices(d: int) -> list[tuple[int, int]]:
    """The wide kernel's output slices at head dim ``d``: (first column,
    columns) of each, multiples of 32, as even as 32-column groups allow
    with at most 192 a slice (csrc/alignment_attention.cu ``wide_cols``)."""
    groups = -(-d // 32)
    n = -(-groups // WIDE_GROUPS)
    base, rem = divmod(groups, n)
    out, first = [], 0
    for s in range(n):
        width = base + (s < rem)
        out.append((32 * first, 32 * width))
        first += width
    return out


def alignment_wide_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, key_valid: torch.Tensor,
                             src_lens: torch.Tensor, mel_lens: torch.Tensor,
                             sigma: float = 0.2, scale: float | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The wide kernels' schedule in plain PyTorch, for the tests: for each
    output slice (:func:`wide_column_slices`) and each chunk of 32 keys, the
    scores in 3xTF32 summed over 64-column chunks of D (the kernels' chunks
    differ only in the order of the f32 sums), ``hi·hi`` apart from
    ``lo·hi + hi·lo``, times f32(1/√D); an online softmax over the key
    chunks (``e = exp(s − m)·mask``, sums rescaled); ``o += 3xTF32(e, v)``
    over the slice's columns; ``out = o·(1/max(l, 1e-37))`` slice by slice;
    from slice 0 the guided numerator (as :func:`alignment_tf32x3_reference`)
    and head 0's first argmax.  Matmuls must run in f32 (TF32 off).
    ``scale`` defaults to 1/√D of q's last axis."""
    D = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    B, H, T, _ = q.shape
    L = k.shape[2]
    slices = wide_column_slices(D)
    width = slices[-1][0] + slices[-1][1]
    q, k, v = (F.pad(t.float(), (0, width - D)) for t in (q, k, v))
    w, pair_valid = guided_weight(T, L, src_lens, mel_lens, sigma)
    w = torch.where(pair_valid, w, 0.0)
    dev = q.device
    out = torch.zeros(B, H, T, width, device=dev)
    masked = None
    for c0, dv in slices:
        o = torch.zeros(B, H, T, dv, device=dev)
        m = torch.full((B, H, T, 1), -math.inf, device=dev)
        l = torch.zeros(B, H, T, 1, device=dev)
        g = torch.zeros(B, T, 1, device=dev)
        scores = []
        for n0 in range(0, L, WIDE_KC):
            keys = slice(n0, n0 + WIDE_KC)
            big = small = 0.0
            for d0 in range(0, width, WIDE_DC):
                cols = slice(d0, d0 + WIDE_DC)
                qc, kc = q[..., cols], k[:, :, keys, cols]
                q_hi, k_hi = tf32_round(qc), tf32_round(kc)
                q_lo, k_lo = tf32_round(qc - q_hi), tf32_round(kc - k_hi)
                eq = "bhqd,bhkd->bhqk"
                big = big + torch.einsum(eq, q_hi, k_hi)
                small = (small + torch.einsum(eq, q_lo, k_hi)
                         + torch.einsum(eq, q_hi, k_lo))
            valid = key_valid[:, None, None, keys]
            s = torch.where(valid, (big + small) * scale, NEG_INF)
            scores.append(s)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            e = torch.exp(s - m_new) * valid
            l = l * alpha + e.sum(dim=-1, keepdim=True)
            g = g * alpha[:, 0] + (w[:, :, keys] * e[:, 0]).sum(
                dim=-1, keepdim=True)
            o = o * alpha + _product_tf32x3("bhqk,bhkd->bhqd", e,
                                            v[:, :, keys, c0:c0 + dv])
            m = m_new
        inv = 1.0 / torch.clamp(l, min=1e-37)
        out[..., c0:c0 + dv] = o * inv
        if c0 == 0:
            gnum = (g * inv[:, 0]).sum(dim=(1, 2))
            masked = torch.cat(scores, dim=-1)[:, 0]
    return out[..., :D], _first_argmax(masked), gnum


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


def _run(entry, q, k, v, key_valid, src, mel, sigma, scale):
    """The library's ``entry`` on the inputs' card: returns (out, idx,
    gnum); raises on a status other than 0."""
    B, H, T, D = q.shape
    lib = _build.load("alignment_attention", _SIGNATURES)
    out = torch.empty_like(q)
    idx = torch.empty((B, T), dtype=torch.int32, device=q.device)
    partial = torch.empty((B, lib.alignment_attention_tiles(T)),
                          dtype=torch.float32, device=q.device)
    gnum = torch.empty((B,), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        status = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
            src.data_ptr(), mel.data_ptr(), out.data_ptr(), idx.data_ptr(),
            partial.data_ptr(), gnum.data_ptr(), B, H, T, k.shape[2], D,
            scale, 2.0 * float(sigma) ** 2,
            torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError(
            "alignment_attention: launch failed: "
            + lib.alignment_attention_error_string(status).decode())
    return out, idx, gnum


def _launch_tc(*args):
    """The first kernel, D a multiple of 4 up to 256."""
    return _run("alignment_attention_forward", *args)


def _launch_wide(*args):
    """The wide kernels, D a multiple of 4 past 256 (the team kernel where
    it fits, else the wide one)."""
    res = _run("alignment_attention_wide_forward", *args)
    alignment_attention.wide_launches += 1
    return res


def _launch(q, k, v, key_valid, src_lens, mel_lens, sigma):
    D = q.shape[-1]
    src = src_lens.to(torch.int32).contiguous()
    mel = mel_lens.to(torch.int32).contiguous()
    width = -(-D // 4) * 4
    if width != D:
        q, k, v = (F.pad(t, (0, width - D)) for t in (q, k, v))
    launch = _launch_wide if width > MAX_TC_HEAD_DIM else _launch_tc
    out, idx, gnum = launch(q, k, v, key_valid, src, mel, sigma,
                            1.0 / math.sqrt(D))
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
    tensor-core kernel for D ≤ 256 and the wide one past it (both on D
    zero-padded to a multiple of 4): q, k, v contiguous float32 (16-byte
    aligned),
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
alignment_attention.wide_launches = 0
