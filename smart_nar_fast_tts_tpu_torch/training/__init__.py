"""Training: the acoustic model's Noam-Adam, train state and steps, and the
vocoder's GAN step."""

from .schedule import clip_by_global_norm, noam_schedule
from .state import TrainState, create_train_state
from .step import compute_gradients, make_eval_step, make_train_step
from .vocoder import (VocoderMetrics, VocoderOptimizer, VocoderState,
                      create_vocoder_state, make_vocoder_train_step,
                      sample_segments)

__all__ = ["clip_by_global_norm", "noam_schedule",
           "TrainState", "create_train_state", "compute_gradients",
           "make_eval_step", "make_train_step",
           "VocoderMetrics", "VocoderOptimizer", "VocoderState",
           "create_vocoder_state", "make_vocoder_train_step",
           "sample_segments"]
