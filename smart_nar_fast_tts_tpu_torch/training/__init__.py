"""Training: the acoustic model's Noam-Adam, train state, steps, fit loop,
validation, checkpoints, logging and profiling, and the vocoder's GAN
step."""

from .checkpoint import CheckpointManager
from .evaluate import evaluate, weighted_average
from .logging import MetricWriter, format_losses, plot_mel
from .profiling import StepProfiler, Throughput
from .schedule import clip_by_global_norm, noam_schedule
from .state import TrainState, create_train_state
from .step import compute_gradients, make_eval_step, make_train_step
from .trainer import Trainer
from .vocoder import (VocoderMetrics, VocoderOptimizer, VocoderState,
                      create_vocoder_state, make_vocoder_train_step,
                      sample_segments)

__all__ = ["CheckpointManager", "evaluate", "weighted_average",
           "MetricWriter", "format_losses", "plot_mel", "StepProfiler",
           "Throughput", "clip_by_global_norm", "noam_schedule",
           "TrainState", "create_train_state", "compute_gradients",
           "make_eval_step", "make_train_step", "Trainer",
           "VocoderMetrics", "VocoderOptimizer", "VocoderState",
           "create_vocoder_state", "make_vocoder_train_step",
           "sample_segments"]
