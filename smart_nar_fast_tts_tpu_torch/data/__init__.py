"""The training batch type."""

from .batch import Batch

__all__ = ["Batch"]
