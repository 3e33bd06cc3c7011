"""One HiFi-GAN resblock convolution with its elementwise work: the CUDA
kernel ``csrc/hifigan_resblock.cu`` and its plain version.

``y = conv1d(leaky_relu(x, slope), weight, bias, dilation d, padding
(k-1)·d/2)``, then ``res + y`` where a residual is given, then ``(acc +
(res + y)) / div`` where a running multi-receptive-field sum is given (the
generator's order of f32 operations).  The kernel replaces no TPU kernel
(the JAX package's HiFi-GAN convolutions are XLA's); it takes the place of
cuDNN's float32 convolution and of the separate LeakyReLU, add and divide
passes.  It computes the products in 3xTF32 (tf32 hi and lo parts of each
operand, lo·lo dropped: about f32 accuracy, see the source);
:func:`resblock_conv_tf32x3_reference` rounds at the same points in plain
PyTorch.  The weights are split once per call; nothing split is cached.

The forward is the registered operator ``smart_tts::hifigan_resblock_conv``
(the plain version on the CPU, the kernel on CUDA, a shape rule for
tracing), so ``torch.export`` keeps the kernel in an exported vocoder
program.  There is no backward: the generator takes this path only when no
gradient is recorded (``vocoder/hifigan.py``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .alignment import tf32_round

# pointers and the stream as c_void_p: ctypes would pass a bare int as 32 bits
_SIGNATURES = {
    "hifigan_resblock_conv_forward": (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
           ctypes.c_void_p],
        ctypes.c_int),
    "hifigan_resblock_wsplit_floats": ([ctypes.c_int] * 3,
                                       ctypes.c_longlong),
    "hifigan_resblock_tiles": ([], ctypes.c_int),
    "hifigan_resblock_tile_for": ([ctypes.c_int] * 6, ctypes.c_int),
    "hifigan_resblock_smem_bytes": ([ctypes.c_int] * 3, ctypes.c_int),
    "hifigan_resblock_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def mrf_sum(y: torch.Tensor, acc: Optional[torch.Tensor],
            div: float) -> torch.Tensor:
    """The generator's running multi-receptive-field sum: ``acc + y``
    where ``acc`` is given, then ``/ div`` (the stage's last resblock)."""
    if acc is not None:
        y = acc + y
    return y / div if div != 1 else y


def _epilogue(y, res, acc, div):
    return mrf_sum(y if res is None else res + y, acc, div)


def resblock_conv_reference(x: torch.Tensor, weight: torch.Tensor,
                            bias: Optional[torch.Tensor], dilation: int,
                            slope: float, res: Optional[torch.Tensor] = None,
                            acc: Optional[torch.Tensor] = None,
                            div: float = 1.0) -> torch.Tensor:
    """The plain version: the module chain's operations in its order."""
    k = weight.shape[-1]
    y = F.conv1d(F.leaky_relu(x, slope), weight, bias, dilation=dilation,
                 padding=(k - 1) * dilation // 2)
    return _epilogue(y, res, acc, div)


def resblock_conv_tf32x3_reference(x: torch.Tensor, weight: torch.Tensor,
                                   bias: Optional[torch.Tensor],
                                   dilation: int, slope: float,
                                   res: Optional[torch.Tensor] = None,
                                   acc: Optional[torch.Tensor] = None,
                                   div: float = 1.0) -> torch.Tensor:
    """Plain version that rounds where the kernel does: the LeakyReLU in
    f32, each operand split as ``hi = tf32(v)``, ``lo = tf32(v − hi)``,
    ``conv(lo, w_hi) + conv(hi, w_lo)`` then ``+ conv(hi, w_hi)`` (products
    of tf32 values are exact in f32), then the bias and the epilogue.
    Convolutions must run in f32 (TF32 off)."""
    k = weight.shape[-1]
    a = F.leaky_relu(x.float(), slope)
    a_hi, w_hi = tf32_round(a), tf32_round(weight)
    a_lo, w_lo = tf32_round(a - a_hi), tf32_round(weight - w_hi)

    def conv(u, v):
        return F.conv1d(u, v, None, dilation=dilation,
                        padding=(k - 1) * dilation // 2)

    y = (conv(a_lo, w_hi) + conv(a_hi, w_lo)) + conv(a_hi, w_hi)
    if bias is not None:
        y = y + bias[:, None]
    return _epilogue(y, res, acc, div)


def _check(x, weight, bias, res, acc, div):
    B, cin, T = x.shape
    cout, wcin, k = weight.shape
    if wcin != cin:
        raise ValueError(f"hifigan_resblock_conv: x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)}")
    for name, t, shape in (("bias", bias, (cout,)),
                           ("res", res, (B, cout, T)),
                           ("acc", acc, (B, cout, T))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"hifigan_resblock_conv: {name} "
                             f"{tuple(t.shape)}, expected {shape}")
    if acc is not None and res is None:
        raise ValueError("hifigan_resblock_conv: a running sum needs the "
                         "residual")
    if div != 1.0 and acc is None:
        raise ValueError("hifigan_resblock_conv: div applies to the running "
                         "sum")


def _launch(x, weight, bias, res, acc, dilation, slope, div, tile=-1):
    """Both launches (the weight split, the convolution) on x's stream."""
    tensors = [t for t in (x, weight, bias, res, acc) if t is not None]
    if any(t.dtype != torch.float32 or t.device != x.device
           for t in tensors):
        raise ValueError("hifigan_resblock_conv: float32 tensors on one "
                         "device expected")
    x, weight = x.contiguous(), weight.contiguous()
    bias = (torch.zeros(weight.shape[0], device=x.device) if bias is None
            else bias.contiguous())
    res = None if res is None else res.contiguous()
    acc = None if acc is None else acc.contiguous()
    B, cin, T = x.shape
    cout, _, k = weight.shape
    lib = _build.load("hifigan_resblock", _SIGNATURES)
    out = torch.empty((B, cout, T), dtype=torch.float32, device=x.device)
    wsplit = torch.empty(int(lib.hifigan_resblock_wsplit_floats(cin, cout, k)),
                         dtype=torch.float32, device=x.device)
    mode = 0 if res is None else 1 if acc is None else 2
    with torch.cuda.device(x.device):
        status = lib.hifigan_resblock_conv_forward(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            None if res is None else res.data_ptr(),
            None if acc is None else acc.data_ptr(), out.data_ptr(),
            wsplit.data_ptr(), B, cin, cout, T, k, int(dilation),
            float(slope), float(div), mode, int(tile),
            torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError(
            "hifigan_resblock_conv: launch failed: "
            + lib.hifigan_resblock_error_string(status).decode())
    hifigan_resblock_conv.launches += 1
    return out


@torch.library.custom_op("smart_tts::hifigan_resblock_conv", mutates_args=())
def resblock_conv_op(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor], res: Optional[torch.Tensor],
                     acc: Optional[torch.Tensor], dilation: int, slope: float,
                     div: float) -> torch.Tensor:
    """The registered forward: the plain version on the CPU, the kernel on
    CUDA (:func:`_launch`); raises on another device."""
    if x.device.type != "cpu":
        raise ValueError(f"hifigan_resblock_conv: unsupported device "
                         f"{x.device}")
    return resblock_conv_reference(x, weight, bias, dilation, slope, res, acc,
                                   div)


@resblock_conv_op.register_kernel("cuda")
def _cuda_impl(x, weight, bias, res, acc, dilation, slope, div):
    return _launch(x, weight, bias, res, acc, dilation, slope, div)


@resblock_conv_op.register_fake
def _(x, weight, bias, res, acc, dilation, slope, div):
    return x.new_empty((x.shape[0], weight.shape[0], x.shape[2]))


def hifigan_resblock_conv(x: torch.Tensor, weight: torch.Tensor,
                          bias: Optional[torch.Tensor], dilation: int,
                          slope: float, res: Optional[torch.Tensor] = None,
                          acc: Optional[torch.Tensor] = None,
                          div: float = 1.0) -> torch.Tensor:
    """``conv1d(leaky_relu(x, slope), weight, bias)`` at ``dilation`` with
    "same" padding, x (B, Cin, T), weight (Cout, Cin, k); then ``res + y``
    where ``res`` is given, and ``(acc + (res + y)) / div`` where ``acc``
    is, through ``smart_tts::hifigan_resblock_conv``.  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel (float32).  No
    gradient flows through it."""
    _check(x, weight, bias, res, acc, float(div))
    return resblock_conv_op(x, weight, bias, res, acc, int(dilation),
                            float(slope), float(div))


hifigan_resblock_conv.launches = 0

