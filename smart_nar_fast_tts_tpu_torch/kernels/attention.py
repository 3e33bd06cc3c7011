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

The TPU kernel takes any head dim D, and so does the port, on the tensor
cores.  The kernel of ``flash_attention_forward`` takes D 64, 128, 192 or 256
(192 is FastSpeech's 384 hidden over 2 heads); past 256 the wide kernel of
``flash_attention_wide_forward`` (same file) takes any multiple of 64,
splitting the output's columns across blocks (:func:`wide_slices`).  The
wrapper zero-pads q, k and v along D to the kernel's width
(:func:`padded_head_dim`) and slices the output (exact: zero columns add
exact zeros to every score, and the scale stays 1/√D of the true D).  Both
round at the same points; ``flash_attention.launches`` counts both kernels'
launches, ``.wide_launches`` the wide kernel's.
:func:`attention_wide_reference` is the wide kernel's schedule in plain
PyTorch.

The forward is the registered operator ``smart_tts::flash_attention``:
the plain version on the CPU, the kernel on CUDA, and a shape rule for
tracing, so ``torch.export`` keeps the kernel in an exported program as one
call (the serving artifacts of ``serving.py``) and the launch count still
counts there.  Its backward, as the TPU kernel's ``custom_vjp``, recomputes
the f32 plain version and returns that function's vector-Jacobian product:
the gradient of the f32 function, which differs from the bf16 forward by
the same rounding.
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


def einsum_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     key_valid: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Self-attention's einsum branch (the JAX model's up to its flash
    length): the f32 product QKᵀ divided by √D, :func:`masked_softmax`, and
    the probabilities in v's dtype times v in f32.  bf16 × bf16 is exact
    in f32: these are the f32 sums of JAX's ``preferred_element_type=
    float32`` products.  Returns the f32 output (B, H, Lq, D) and the
    probabilities (B, H, Lq, Lk)."""
    scores = (torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
              / q.shape[-1] ** 0.5)
    attn = masked_softmax(scores, key_valid[:, None, None, :])
    out = torch.einsum("bhqk,bhkd->bhqd", attn.to(v.dtype).float(),
                       v.float())
    return out, attn


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
    "flash_attention_wide_forward": (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
    "flash_attention_wide_smem_bytes": (
        [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
        ctypes.c_int),
}
TC_HEAD_DIMS = (64, 128, 192, 256)    # the first kernel's head dims
WIDE_CHUNK = 64                       # past 256: multiples of 64 columns
WIDE_MAX_SLICE = 4                    # chunks of 64 columns a slice
WIDE_TILE = 64                        # keys a tile of the wide kernel


def padded_head_dim(d: int) -> int:
    """The kernels' head dim for a head dim d: the smallest of
    :data:`TC_HEAD_DIMS` that holds it up to 256, the next multiple of 64
    past it (the wide kernel)."""
    if d > TC_HEAD_DIMS[-1]:
        return -(-d // WIDE_CHUNK) * WIDE_CHUNK
    return next(w for w in TC_HEAD_DIMS if d <= w)


def wide_slices(width: int) -> list[tuple[int, int]]:
    """The wide kernel's output slices at a padded head dim ``width``: (first
    column, columns) of each, as even as whole 64-column chunks allow with
    at most 4 chunks a slice (csrc/flash_attention.cu ``wide_slice``)."""
    nc = width // WIDE_CHUNK
    n = -(-nc // WIDE_MAX_SLICE)
    base, rem = divmod(nc, n)
    out, first = [], 0
    for s in range(n):
        chunks = base + (s < rem)
        out.append((WIDE_CHUNK * first, WIDE_CHUNK * chunks))
        first += chunks
    return out


def attention_wide_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, key_valid: torch.Tensor,
                             scale: float | None = None) -> torch.Tensor:
    """The wide kernel's schedule in plain PyTorch, for the tests: D
    zero-padded to a multiple of 64; bf16(q·scale), bf16 k and v; for each
    output slice (:func:`wide_slices`) and each 64-key tile holding a valid
    key, the scores summed over 64-column chunks of D in f32, an online
    softmax in f32 (an invalid key -1e30, probability 0), p rounded to bf16
    for its P·V over the slice's columns, f32 sums; ``out = PV / max(l,
    1e-37)``, slice by slice.  ``scale`` defaults to 1/√D of the true D."""
    bf16 = torch.bfloat16
    D = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    width = -(-D // WIDE_CHUNK) * WIDE_CHUNK
    qs, ks, vs = (F.pad(t.float(), (0, width - D)) for t in (q, k, v))
    qs = (qs * scale).to(bf16).float()
    ks, vs = ks.to(bf16).float(), vs.to(bf16).float()
    B, H, Lq, _ = q.shape
    Lk = k.shape[2]
    out = torch.zeros(B, H, Lq, width, device=q.device)
    for c0, dv in wide_slices(width):
        o = torch.zeros(B, H, Lq, dv, device=q.device)
        m = torch.full((B, H, Lq, 1), NEG_INF, device=q.device)
        l = torch.zeros(B, H, Lq, 1, device=q.device)
        for t0 in range(0, Lk, WIDE_TILE):
            keys = slice(t0, t0 + WIDE_TILE)
            valid = key_valid[:, None, None, keys]
            s = sum(torch.einsum("bhqd,bhkd->bhqk",
                                 qs[..., d:d + WIDE_CHUNK],
                                 ks[:, :, keys, d:d + WIDE_CHUNK])
                    for d in range(0, width, WIDE_CHUNK))
            s = torch.where(valid, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new) * valid
            # a tile with no valid key of its item is skipped, changing no bit
            live = key_valid[:, keys].any(1)[:, None, None, None]
            l = torch.where(live, l * alpha + p.sum(dim=-1, keepdim=True), l)
            pv = torch.einsum("bhqk,bhkd->bhqd", p.to(bf16).float(),
                              vs[:, :, keys, c0:c0 + dv])
            o = torch.where(live, o * alpha + pv, o)
            m = torch.where(live, m_new, m)
        out[..., c0:c0 + dv] = o / torch.clamp(l, min=1e-37)
    return out[..., :D].to(q.dtype)


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


def _run(lib, entry, device, *args):
    """Call the library's ``entry`` with ``args`` and the current stream on
    ``device``; raises on a status other than 0."""
    with torch.cuda.device(device):
        status = getattr(lib, entry)(*args,
                                     torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError("flash_attention: launch failed: "
                           + lib.flash_attention_error_string(status).decode())


def _launch_tc(q, k, v, key_valid, scale):
    """The first kernel, q, k, v at D 64, 128, 192 or 256."""
    B, H, Lq, width = q.shape
    Lk = k.shape[2]
    lib = _build.load("flash_attention", _SIGNATURES)
    out = torch.empty_like(q)
    # f32: the kernel rounds k and v to bf16 here first (TMA reads bf16)
    scratch = (torch.empty((2, B, H, Lk, width), dtype=torch.bfloat16,
                           device=q.device)
               if q.dtype == torch.float32 else None)
    _run(lib, "flash_attention_forward", q.device, q.data_ptr(), k.data_ptr(),
         v.data_ptr(), key_valid.data_ptr(), out.data_ptr(),
         None if scratch is None else scratch.data_ptr(), B, H, Lq, Lk,
         width, _DTYPE_CODES[q.dtype], scale)
    return out


def _launch_wide(q, k, v, key_valid, scale):
    """The wide kernel, q, k, v at a multiple of 64 past 256."""
    B, H, Lq, width = q.shape
    Lk = k.shape[2]
    lib = _build.load("flash_attention", _SIGNATURES)
    out = torch.empty_like(q)
    # bf16(q·scale), and for f32 the rounded k and v, for the TMA loads
    rows = Lq + (2 * Lk if q.dtype == torch.float32 else 0)
    scratch = torch.empty((B, H, rows, width), dtype=torch.bfloat16,
                          device=q.device)
    _run(lib, "flash_attention_wide_forward", q.device, q.data_ptr(),
         k.data_ptr(), v.data_ptr(), key_valid.data_ptr(), out.data_ptr(),
         scratch.data_ptr(), B, H, Lq, Lk, width, _DTYPE_CODES[q.dtype],
         scale)
    flash_attention.wide_launches += 1
    return out


def _launch(q, k, v, key_valid):
    _check_cuda(q, k, v, key_valid)
    D = q.shape[-1]
    width = padded_head_dim(D)
    if width != D:
        q, k, v = (F.pad(t, (0, width - D)) for t in (q, k, v))
    launch = _launch_wide if width > TC_HEAD_DIMS[-1] else _launch_tc
    out = launch(q, k, v, key_valid, 1.0 / math.sqrt(D))
    flash_attention.launches += 1
    return out if width == D else out[..., :D].contiguous()


def _check_cuda(q, k, v, key_valid):
    """What the kernels take; raises otherwise."""
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


@torch.library.custom_op("smart_tts::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       key_valid: torch.Tensor) -> torch.Tensor:
    """The registered forward: :func:`attention_reference` on the CPU, the
    kernel on CUDA (:func:`_launch`); raises on another device."""
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return attention_reference(q, k, v, key_valid)


flash_attention_op.register_kernel("cuda")(_launch)


@flash_attention_op.register_fake
def _(q, k, v, key_valid):
    return torch.empty_like(q)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_valid: torch.Tensor) -> torch.Tensor:
    """Masked attention ``softmax(QKᵀ/√D)V`` over (B, H, L, D) tensors,
    through ``smart_tts::flash_attention``.

    A CPU tensor takes :func:`attention_reference`.  A CUDA tensor launches
    the tensor-core kernel for D ≤ 256 (zero-padded to 64, 128, 192 or 256)
    and the wide one past it (zero-padded to a multiple of 64): q, k, v
    contiguous and 16-byte aligned, all f32 or all bf16; key_valid (B, Lk)
    bool.  The output has q's dtype; where a gradient is wanted, the
    backward of :class:`_FlashAttention`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, key_valid, flash_attention_op)
    return flash_attention_op(q, k, v, key_valid)


flash_attention.launches = 0
flash_attention.wide_launches = 0
