"""Hand-written CUDA kernels, with their plain versions.

Each wrapper takes the plain PyTorch version for a CPU tensor and launches
its CUDA kernel for a CUDA tensor (or raises); there is no fallback.  Each
wrapper counts its launches in ``<wrapper>.launches``, so a run can show that
it went through the kernels.  Three wrappers have a second kernel for the
widths their first does not take (head dims past 256, an n_fft that is not
a power of two from 32 to 4096), counted apart: :func:`general_launches`.
"""

from .alignment import (alignment_attention, alignment_reference,
                        alignment_tf32x3_reference)
from .attention import (attention_bf16_reference, attention_bf16_tolerance,
                        attention_reference, flash_attention, masked_softmax)
from .stft import fused_log_mel, log_mel_dft_reference, log_mel_fft_reference
from .upsample import gaussian_upsample_banded

WRAPPERS = (flash_attention, gaussian_upsample_banded, alignment_attention,
            fused_log_mel)
# (wrapper, its second kernel's counter, that kernel's name)
GENERAL_COUNTERS = (
    (flash_attention, "general_launches", "flash_attention_general"),
    (alignment_attention, "general_launches", "alignment_attention_general"),
    (fused_log_mel, "dft_launches", "fused_log_mel_dft"))


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
    for fn, counter, _ in GENERAL_COUNTERS:
        setattr(fn, counter, 0)


def launches() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


def general_launches() -> dict[str, int]:
    """Launches of the second kernels (any head dim, any n_fft)."""
    return {name: getattr(fn, counter)
            for fn, counter, name in GENERAL_COUNTERS}


__all__ = ["alignment_attention", "alignment_reference",
           "alignment_tf32x3_reference",
           "attention_bf16_reference", "attention_bf16_tolerance",
           "attention_reference",
           "flash_attention", "masked_softmax", "fused_log_mel",
           "gaussian_upsample_banded", "general_launches",
           "log_mel_dft_reference", "log_mel_fft_reference",
           "reset_launches", "launches"]
