"""Hand-written CUDA kernels, with their plain versions.

Each wrapper takes the plain PyTorch version for a CPU tensor and launches
its CUDA kernel for a CUDA tensor (or raises); there is no fallback.  Each
wrapper counts its launches in ``<wrapper>.launches``, so a run can show that
it went through the kernels.  Three wrappers have further kernels for the
widths their first does not take, whose launches are also counted apart
(:func:`route_launches`): the wide flash and alignment kernels (head dims
past 256, on the tensor cores too; counted in ``.launches`` as well), and
the log-mel mixed-radix FFT kernel (an n_fft that is not a power of two
from 32 to 4096) and DFT kernel (an odd n_fft past the mixed-radix
kernel's 7,263), each counted there alone.

The serving kernels' forwards are registered operators,
``smart_tts::flash_attention``, ``smart_tts::gaussian_upsample_banded`` and
``smart_tts::hifigan_resblock_conv`` (importing this package registers
them), so that ``torch.export`` keeps them in the exported serving programs
of ``serving.py``.
"""

from .alignment import (alignment_attention, alignment_reference,
                        alignment_tf32x3_reference, alignment_wide_reference)
from .attention import (attention_bf16_reference, attention_bf16_tolerance,
                        attention_reference, attention_wide_reference,
                        einsum_attention, flash_attention, masked_softmax)
from .resblock import (hifigan_resblock_conv, resblock_conv_reference,
                       resblock_conv_tf32x3_reference)
from .stft import fused_log_mel, log_mel_dft_reference, log_mel_fft_reference
from .upsample import gaussian_upsample_banded

WRAPPERS = (flash_attention, gaussian_upsample_banded, alignment_attention,
            fused_log_mel, hifigan_resblock_conv)
# (wrapper, its second kernel's counter, that kernel's name)
ROUTE_COUNTERS = (
    (flash_attention, "wide_launches", "flash_attention_wide"),
    (alignment_attention, "wide_launches", "alignment_attention_wide"),
    (fused_log_mel, "mixed_launches", "fused_log_mel_mixed"),
    (fused_log_mel, "dft_launches", "fused_log_mel_dft"))


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
    for fn, counter, _ in ROUTE_COUNTERS:
        setattr(fn, counter, 0)


def launches() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


def route_launches() -> dict[str, int]:
    """Launches of the further kernels (head dims past 256, n_fft not a
    power of two from 32 to 4096)."""
    return {name: getattr(fn, counter)
            for fn, counter, name in ROUTE_COUNTERS}


__all__ = ["alignment_attention", "alignment_reference",
           "alignment_tf32x3_reference", "alignment_wide_reference",
           "attention_bf16_reference", "attention_bf16_tolerance",
           "attention_reference", "attention_wide_reference",
           "einsum_attention", "flash_attention", "masked_softmax",
           "fused_log_mel",
           "gaussian_upsample_banded", "hifigan_resblock_conv",
           "log_mel_dft_reference", "log_mel_fft_reference",
           "resblock_conv_reference", "resblock_conv_tf32x3_reference",
           "reset_launches", "launches", "route_launches"]
