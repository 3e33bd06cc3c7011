"""Banded Gaussian upsampling: the CUDA kernel ``csrc/gaussian_upsample.cu``
and its plain version, the dense ``ops.upsample.gaussian_upsample``.

The kernel replaces the TPU kernel ``gaussian_upsample_banded`` of
``smart_nar_fast_tts_tpu/ops/pallas/upsample.py``.  It computes in full f32;
the only difference from the dense version is that a phoneme more than
``BAND_SIGMAS``·σ from a frame tile is left out, a weight below exp(-36).
One launch computes the centers, the total and ``mel_len`` besides ``out``.

Its backward, as the TPU kernel's ``custom_vjp``, is the vector-Jacobian
product of the dense version, recomputed, for each input that needs one.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.upsample import gaussian_upsample
from . import _build

# the TPU kernel's band: exp(-36) ≈ 2e-16, below f32 resolution
BAND_SIGMAS = 6.0

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


def gaussian_upsample_banded(x: torch.Tensor, durations: torch.Tensor,
                             max_len: int, phon_valid: torch.Tensor,
                             sigma: float = 10.0
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gaussian upsampling of x (B, L, D) by durations (B, L) to max_len
    frames; phon_valid (B, L) is 1 on real phonemes.  Returns (out
    (B, max_len, D), mel_len (B,) int32 = min(Σd, max_len)).

    A CPU tensor takes the dense plain version.  A CUDA tensor launches the
    kernel (x contiguous float32), with a backward through
    :class:`_GaussianUpsample`."""
    if x.device.type == "cpu":
        out, mel_len, _ = gaussian_upsample(x, durations, max_len, phon_valid,
                                            sigma=sigma)
        return out, mel_len
    if x.device.type != "cuda":
        raise ValueError(f"gaussian_upsample_banded: unsupported device "
                         f"{x.device}")
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
    return _GaussianUpsample.apply(x, durations, phon_valid, max_len, sigma,
                                   _launch)


gaussian_upsample_banded.launches = 0
