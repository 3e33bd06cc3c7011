"""The data layer: offline feature extraction (TextGrid alignment, F0,
the feature store), the training batch, the bucketed corpus pipeline,
synthesis metadata items and wav IO."""

from .alignment import get_alignment
from .batch import Batch
from .dataset import (AcousticDataset, BucketBatcher, BucketSpec,
                      TextOnlyDataset)
from .pitch import estimate_f0
from .preprocessor import Preprocessor
from .textgrid import TextGrid, read_textgrid
from .wavio import load_wav, save_wav

__all__ = ["TextGrid", "read_textgrid", "get_alignment", "estimate_f0",
           "Preprocessor", "Batch", "AcousticDataset", "BucketBatcher",
           "BucketSpec", "TextOnlyDataset", "load_wav", "save_wav"]
