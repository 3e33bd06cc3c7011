"""Checkpoints of the acoustic model's train state, in the port's own
format.

The JAX package saves with orbax (``training/checkpoint.py``), which the
card's machine cannot read, and the port does not read those; a reference
``<step>.pth.tar`` comes in through ``cli/import_checkpoint.py``.  Here a
step is the directory
``<directory>/<step>/`` holding ``state.pt`` (``torch.save`` of the model's
state dict, the optimizer's state dict and the step) and ``data.json`` (the
data iterator's position).  The manager keeps the newest ``max_to_keep``
steps, and ``restore`` has the JAX manager's shape: ``(state, data_state)``,
the state unchanged and ``None`` when there is no checkpoint.  A step is
written under a temporary name and renamed, so a reader never sees half of
one.

``save`` decides as the JAX manager's orbax ``CheckpointManager`` does with
``save_interval_steps`` (orbax 0.11: ``FixedIntervalPolicy`` or
``InitialSavePolicy``, after the latest-step check): a step at or below the
latest one on disk is never saved; otherwise the step is saved when it is a
multiple of the interval or when the directory holds no step yet.
``force`` saves regardless.  So a trainer's saves land on the JAX
trainer's steps.  Saves are synchronous: the JAX manager's ``wait`` and
``close`` have nothing to do here.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Optional

import torch

from .state import TrainState

STATE_FILE = "state.pt"
DATA_FILE = "data.json"


class CheckpointManager:
    """Save and restore :class:`~.state.TrainState` under ``directory``;
    ``max_to_keep`` None keeps every step."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = 5,
                 save_interval_steps: int = 1):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps

    def all_steps(self) -> list[int]:
        """The steps saved, ascending."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.isfile(
                          os.path.join(self.directory, name, STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step: int) -> bool:
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        return step % self.save_interval_steps == 0 or latest is None

    def save(self, state: TrainState, data_state: Optional[dict] = None,
             force: bool = False) -> bool:
        """Write step ``state.step`` when :meth:`should_save` (or ``force``:
        then replacing a step of the same number) and drop the oldest
        beyond ``max_to_keep``.  Returns whether it was written."""
        if not (force or self.should_save(state.step)):
            return False
        os.makedirs(self.directory, exist_ok=True)
        final = os.path.join(self.directory, str(state.step))
        tmp = tempfile.mkdtemp(prefix=f".{state.step}-", dir=self.directory)
        try:
            torch.save({"model": state.model.state_dict(),
                        "optimizer": state.optimizer.state_dict(),
                        "step": state.step},
                       os.path.join(tmp, STATE_FILE))
            with open(os.path.join(tmp, DATA_FILE), "w") as f:
                json.dump(data_state or {}, f)
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if self.max_to_keep:
            for step in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(step)))
        return True

    def restore(self, state: TrainState, step: Optional[int] = None
                ) -> tuple[TrainState, Optional[dict]]:
        """Load step ``step`` (the latest when None) into ``state``'s model
        and optimizer, in place.  Returns ``(state, data_state)``;
        ``(state, None)`` unchanged when no checkpoint exists.  A step asked
        for and absent raises ``FileNotFoundError``."""
        if step is None:
            step = self.latest_step()
            if step is None:
                return state, None
        path = os.path.join(self.directory, str(step))
        if not os.path.isfile(os.path.join(path, STATE_FILE)):
            raise FileNotFoundError(f"no checkpoint of step {step} under "
                                    f"{self.directory}")
        saved = torch.load(os.path.join(path, STATE_FILE),
                           map_location=state.device, weights_only=True)
        state.model.load_state_dict(saved["model"])
        state.optimizer.load_state_dict(saved["optimizer"])
        state.step = int(saved["step"])
        with open(os.path.join(path, DATA_FILE)) as f:
            data_state = json.load(f)
        return state, data_state
