"""The data layer: the training batch, the bucketed corpus pipeline,
synthesis metadata items and wav IO."""

from .batch import Batch
from .dataset import (AcousticDataset, BucketBatcher, BucketSpec,
                      TextOnlyDataset)
from .wavio import load_wav, save_wav

__all__ = ["Batch", "AcousticDataset", "BucketBatcher", "BucketSpec",
           "TextOnlyDataset", "load_wav", "save_wav"]
