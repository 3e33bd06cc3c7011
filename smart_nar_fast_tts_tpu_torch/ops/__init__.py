"""Plain tensor ops of the serving path (no kernels)."""

from .masks import length_to_valid
from .positional import sinusoid_table
from .upsample import gaussian_upsample, hard_upsample

__all__ = ["length_to_valid", "sinusoid_table", "gaussian_upsample",
           "hard_upsample"]
