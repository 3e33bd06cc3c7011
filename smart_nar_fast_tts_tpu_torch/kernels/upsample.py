"""Banded Gaussian upsampling: the CUDA kernel ``csrc/gaussian_upsample.cu``
and its plain version, the dense ``ops.upsample.gaussian_upsample``.

The kernel replaces the TPU kernel ``gaussian_upsample_banded`` of
``smart_nar_fast_tts_tpu/ops/pallas/upsample.py``.  It computes in full f32;
the only difference from the dense version is that, for each tile of
``TILE`` frames, a phoneme whose center lies more than ``BAND_SIGMAS``·σ
from the tile is left out.  Its weight there is below exp(-104), which f32
``exp`` rounds to exactly 0, so the tile rule drops nothing that the dense
version keeps, even where every weight of a frame is tiny and the
denominator's 1e-20 does not hide them.  :func:`gaussian_upsample_tile_reference`
applies the tile rule in plain PyTorch, so the rule is checked without a
card.  One launch computes the centers, the total and ``mel_len`` besides
``out``.

The forward is the registered operator ``smart_tts::gaussian_upsample_banded``
(the dense version on the CPU, the kernel on CUDA, a shape rule for
tracing), so ``torch.export`` keeps the kernel in an exported program.  Its
backward, as the TPU kernel's ``custom_vjp``, is the vector-Jacobian product
of the dense version, recomputed, for each input that needs one.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..ops.upsample import gaussian_upsample
from . import _build

# past √104·σ a weight exp(-(t - c)²/σ²) < exp(-104) ≈ 6.8e-46, below half
# the least f32 subnormal: f32 exp gives exactly 0 there
BAND_SIGMAS = math.sqrt(104.0)
TILE = 32           # frames per tile (csrc/gaussian_upsample.cu TT)

# pointers and the stream as c_void_p: ctypes would pass a bare int as 32 bits
_SIGNATURES = {
    "gaussian_upsample_forward": (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int),
    "gaussian_upsample_max_l": ([], ctypes.c_int),
    "gaussian_upsample_smem_bytes": ([ctypes.c_int], ctypes.c_int),
    "gaussian_upsample_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def gaussian_upsample_tile_reference(x: torch.Tensor, durations: torch.Tensor,
                                     max_len: int, phon_valid: torch.Tensor,
                                     sigma: float = 10.0,
                                     band_sigmas: float = BAND_SIGMAS
                                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The dense function with the kernel's tile rule: frame t of tile
    [t0, t0 + TILE) takes phoneme l only if its center c_l satisfies
    ``c_l + band >= t0`` and ``c_l - band <= t0 + TILE - 1``, band =
    ``band_sigmas``·σ in f32 as the kernel's.  Returns (out (B, T, D),
    mel_len (B,) int32), in f32.  For tests: it equals the dense version
    at ``BAND_SIGMAS`` and shows what a narrower band loses."""
    d = durations.float() * phon_valid
    e = torch.cumsum(d, dim=1)
    c = e - 0.5 * d                                                # (B, L)
    t = torch.arange(max_len, dtype=torch.float32, device=x.device)
    t_lo = torch.div(t, TILE, rounding_mode="floor") * TILE
    band = torch.tensor(band_sigmas * sigma, dtype=torch.float32)
    keep = ((c[:, :, None] + band >= t_lo[None, None, :])
            & (c[:, :, None] - band <= t_lo[None, None, :] + TILE - 1))
    dist2 = (t[None, None, :] - c[:, :, None]) ** 2                # (B, L, T)
    w = torch.exp(-(sigma ** -2) * dist2) * phon_valid[:, :, None] * keep
    w = w / (w.sum(dim=1, keepdim=True) + 1e-20)
    total = e[:, -1]
    w = w * (t[None, :] < total[:, None])[:, None, :]
    out = torch.einsum("blt,bld->btd", w, x.float())
    return out, torch.clamp(total, max=max_len).to(torch.int32)


class _GaussianUpsample(torch.autograd.Function):
    """``launch`` (the kernel) forward; the VJP of the dense
    :func:`~..ops.upsample.gaussian_upsample`, recomputed, backward."""

    @staticmethod
    def forward(ctx, x, durations, phon_valid, max_len, sigma, launch):
        ctx.save_for_backward(x, durations, phon_valid)
        ctx.max_len, ctx.sigma = max_len, sigma
        out, mel_len = launch(x, durations, phon_valid, max_len, sigma)
        ctx.mark_non_differentiable(mel_len)
        return out, mel_len

    @staticmethod
    def backward(ctx, grad_out, _grad_mel_len):
        saved = ctx.saved_tensors
        wants = [ctx.needs_input_grad[i] and saved[i].is_floating_point()
                 for i in range(3)]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(w)
                      for t, w in zip(saved, wants)]
            out = gaussian_upsample(*inputs[:2], ctx.max_len, inputs[2],
                                    sigma=ctx.sigma)[0]
        grads = torch.autograd.grad(
            out, [t for t, w in zip(inputs, wants) if w], grad_out)
        it = iter(grads)
        return (*(next(it) if w else None for w in wants), None, None, None)


def _launch(x, durations, phon_valid, max_len, sigma):
    B, L, D = x.shape
    if durations.shape != (B, L) or phon_valid.shape != (B, L):
        raise ValueError(
            f"gaussian_upsample_banded: x {tuple(x.shape)}, durations "
            f"{tuple(durations.shape)}, phon_valid {tuple(phon_valid.shape)}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("gaussian_upsample_banded: x must be contiguous "
                         f"float32, got {x.dtype}")
    if durations.device != x.device or phon_valid.device != x.device:
        raise ValueError("gaussian_upsample_banded: inputs on different "
                         "devices")
    d = durations.float().contiguous()
    valid = phon_valid.float().contiguous()
    lib = _build.load("gaussian_upsample", _SIGNATURES)
    if L > lib.gaussian_upsample_max_l():
        raise ValueError(f"gaussian_upsample_banded: L {L} over the "
                         f"kernel's {lib.gaussian_upsample_max_l()}")
    out = torch.empty((B, max_len, D), dtype=torch.float32, device=x.device)
    mel_len = torch.empty((B,), dtype=torch.int32, device=x.device)
    vec = int(D % 4 == 0 and x.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        status = lib.gaussian_upsample_forward(
            x.data_ptr(), d.data_ptr(), valid.data_ptr(), out.data_ptr(),
            mel_len.data_ptr(), B, L, max_len, D, float(sigma) ** -2,
            BAND_SIGMAS * float(sigma), vec,
            torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError(
            "gaussian_upsample_banded: launch failed: "
            + lib.gaussian_upsample_error_string(status).decode())
    gaussian_upsample_banded.launches += 1
    return out, mel_len


@torch.library.custom_op("smart_tts::gaussian_upsample_banded",
                         mutates_args=())
def gaussian_upsample_op(x: torch.Tensor, durations: torch.Tensor,
                         max_len: int, phon_valid: torch.Tensor,
                         sigma: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The registered forward: the dense version on the CPU, the kernel on
    CUDA (:func:`_launch`); raises on another device."""
    if x.device.type != "cpu":
        raise ValueError(f"gaussian_upsample_banded: unsupported device "
                         f"{x.device}")
    out, mel_len, _ = gaussian_upsample(x, durations, max_len, phon_valid,
                                        sigma=sigma)
    return out, mel_len


@gaussian_upsample_op.register_kernel("cuda")
def _cuda_impl(x, durations, max_len, phon_valid, sigma):
    """The operator's CUDA body: its arguments in the operator's order."""
    return _launch(x, durations, phon_valid, max_len, sigma)


@gaussian_upsample_op.register_fake
def _(x, durations, max_len, phon_valid, sigma):
    B, _, D = x.shape
    return (x.new_empty((B, max_len, D)),
            x.new_empty((B,), dtype=torch.int32))


def _op_launch(x, durations, phon_valid, max_len, sigma):
    """The operator, with the launcher's argument order."""
    return gaussian_upsample_op(x, durations, max_len, phon_valid,
                                float(sigma))


def gaussian_upsample_banded(x: torch.Tensor, durations: torch.Tensor,
                             max_len: int, phon_valid: torch.Tensor,
                             sigma: float = 10.0
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gaussian upsampling of x (B, L, D) by durations (B, L) to max_len
    frames; phon_valid (B, L) is 1 on real phonemes.  Returns (out
    (B, max_len, D), mel_len (B,) int32 = min(Σd, max_len)), through
    ``smart_tts::gaussian_upsample_banded``.

    A CPU tensor takes the dense plain version.  A CUDA tensor launches the
    kernel (x contiguous float32).  Where a gradient is wanted, the
    backward of :class:`_GaussianUpsample`."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, durations, phon_valid)):
        return _GaussianUpsample.apply(x, durations, phon_valid, max_len,
                                       sigma, _op_launch)
    return _op_launch(x, durations, phon_valid, max_len, sigma)


gaussian_upsample_banded.launches = 0
