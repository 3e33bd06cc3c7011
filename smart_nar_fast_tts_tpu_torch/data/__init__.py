"""The training batch type, synthesis-time metadata items and the wav
writer."""

from .batch import Batch
from .dataset import TextOnlyDataset
from .wavio import save_wav

__all__ = ["Batch", "TextOnlyDataset", "save_wav"]
