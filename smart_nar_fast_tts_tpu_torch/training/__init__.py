"""Acoustic-model training: Noam-Adam, the train state, train and eval
steps."""

from .schedule import clip_by_global_norm, noam_schedule
from .state import TrainState, create_train_state
from .step import compute_gradients, make_eval_step, make_train_step

__all__ = ["clip_by_global_norm", "noam_schedule",
           "TrainState", "create_train_state", "compute_gradients",
           "make_eval_step", "make_train_step"]
