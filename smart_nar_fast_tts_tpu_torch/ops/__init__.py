"""Plain tensor ops (no kernels)."""

from .duration import durations_from_argmax, durations_from_attention
from .masks import length_to_valid, masked_mean
from .positional import sinusoid_table
from .upsample import gaussian_upsample, hard_upsample

__all__ = ["durations_from_argmax", "durations_from_attention",
           "length_to_valid", "masked_mean", "sinusoid_table",
           "gaussian_upsample", "hard_upsample"]
