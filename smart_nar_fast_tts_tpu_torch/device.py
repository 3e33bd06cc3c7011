"""The device rule of the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means CUDA.  Raises when CUDA is asked for and absent: the
    port does not fall back to the CPU unless the caller asks for it.  On
    CUDA, turns TF32 off for matmuls and cuDNN: the JAX reference is f32,
    and cuDNN runs f32 convolutions in TF32 unless told not to, which keeps
    only ~3 decimal digits."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run the plain PyTorch versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device
