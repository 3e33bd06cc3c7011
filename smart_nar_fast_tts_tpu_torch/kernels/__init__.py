"""Hand-written CUDA kernels, with their plain versions.

Each wrapper takes the plain PyTorch version for a CPU tensor and launches
its CUDA kernel for a CUDA tensor (or raises); there is no fallback.  Each
wrapper counts its launches in ``<wrapper>.launches``, so a run can show that
it went through the kernels.
"""

from .alignment import alignment_attention, alignment_reference
from .attention import (attention_bf16_reference, attention_bf16_tolerance,
                        attention_reference, flash_attention, masked_softmax)
from .stft import fused_log_mel
from .upsample import gaussian_upsample_banded

WRAPPERS = (flash_attention, gaussian_upsample_banded, alignment_attention,
            fused_log_mel)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launches() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


__all__ = ["alignment_attention", "alignment_reference",
           "attention_bf16_reference", "attention_bf16_tolerance",
           "attention_reference",
           "flash_attention", "masked_softmax", "fused_log_mel",
           "gaussian_upsample_banded", "reset_launches", "launches"]
