"""Acoustic model (inference and training) and its losses."""

from .fastspeech2_align import FastSpeech2Align, ModelOutput
from .loss import FastSpeech2Loss, LossBreakdown, guided_attention_loss

__all__ = ["FastSpeech2Align", "ModelOutput", "FastSpeech2Loss",
           "LossBreakdown", "guided_attention_loss"]
