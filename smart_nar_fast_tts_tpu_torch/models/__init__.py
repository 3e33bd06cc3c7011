"""Acoustic model of the serving path (inference only)."""

from .fastspeech2_align import FastSpeech2Align, ModelOutput

__all__ = ["FastSpeech2Align", "ModelOutput"]
