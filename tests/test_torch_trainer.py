"""The port's fit loop (``training/trainer.py``) against the JAX package's on
the CPU, on a tiny synthetic corpus (``tests/test_data._make_corpus``
through the JAX ``Preprocessor``, 4 train and 2 val utterances) and a tiny
model (d 32, 1 + 1 layers, 2 heads, batch 2), both read from one YAML
triplet.

- Both trainers take 3 steps (log every step, val and a synth figure at
  step 2, a checkpoint every 2) from the same step-0 parameters: JAX's
  ``init_state()``, saved as an orbax checkpoint for JAX and carried
  across by ``weights.jax_to_torch_acoustic`` into a port checkpoint.
  Dropout is off on both sides (``flax.linen.Dropout`` patched inside the
  test, the port's generator None).  Both event files are read with
  TensorBoard's ``event_accumulator``: the same scalar and image tags at
  the same steps; each loss term of steps 1-3 and of the val run within
  LOSS_RTOL of JAX's, the one-step tolerance of
  ``tests/test_torch_training.py`` (measured: at most 3.9e-7); the logged
  messages as many; the saved steps the same (0, 2 and 3).

The rest of the loop, on the port alone: ``tests/test_torch_trainer_loop.py``.
"""

import os

import flax.linen as flax_nn
import numpy as np
import pytest
from tensorboard.backend.event_processing import event_accumulator

from smart_nar_fast_tts_tpu.config import Config as JaxConfig
from smart_nar_fast_tts_tpu.training import Trainer as JaxTrainer
from smart_nar_fast_tts_tpu.training.checkpoint import (
    CheckpointManager as JaxCheckpointManager)
from smart_nar_fast_tts_tpu_torch.config import Config
from smart_nar_fast_tts_tpu_torch.models import FastSpeech2Align
from smart_nar_fast_tts_tpu_torch.training import (CheckpointManager,
                                                   Trainer,
                                                   create_train_state)
from smart_nar_fast_tts_tpu_torch.weights import jax_to_torch_acoustic
from torch_port_util import (flatten, make_trainer_corpus, one_torch_thread,
                             write_trainer_triplet)

LOSS_RTOL = 1e-5
GUIDANCE = {"scalars": 0, "images": 0, "audio": 0}


def _events(log_dir):
    acc = event_accumulator.EventAccumulator(log_dir, size_guidance=GUIDANCE)
    acc.Reload()
    return acc


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_trainer")
    return root, make_trainer_corpus(root)


@pytest.fixture(scope="module")
def runs(corpus):
    """JAX's and the port's 3-step fits from the same step-0 parameters,
    dropout off on both sides."""
    root, pre = corpus
    jcfg = JaxConfig.from_yaml_triplet(*write_trainer_triplet(root, "jax",
                                                              pre))
    pcfg = Config.from_yaml_triplet(*write_trainer_triplet(root, "port",
                                                           pre))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_nn.Dropout, "__call__",
                   lambda self, x, *args, **kwargs: x)
        mp.setattr(Trainer, "_dropout_generator", lambda self, step: None)
        jax_trainer = JaxTrainer(jcfg)
        state0 = jax_trainer.init_state()
        mngr = JaxCheckpointManager(jcfg.train.ckpt_path)
        mngr.save(state0, force=True)
        mngr.wait()
        mngr.close()
        model = FastSpeech2Align(pcfg.model, pcfg.preprocess)
        model.load_state_dict(jax_to_torch_acoustic(flatten(
            {"params": state0.params, "batch_stats": state0.batch_stats}),
            pcfg.model))
        CheckpointManager(pcfg.train.ckpt_path).save(
            create_train_state(model, pcfg.train.optimizer, "cpu"))
        jax_trainer.fit()
        Trainer(pcfg, device="cpu").fit()
    return jcfg, pcfg


@pytest.mark.parametrize("writer", ["train", "val"])
def test_fit_logs_as_jax(runs, writer):
    jcfg, pcfg = runs
    jax_ev = _events(f"{jcfg.train.log_path}/{writer}")
    port_ev = _events(f"{pcfg.train.log_path}/{writer}")
    assert port_ev.Tags()["scalars"] == jax_ev.Tags()["scalars"]
    assert port_ev.Tags()["images"] == jax_ev.Tags()["images"]
    assert len(port_ev.Tags()["images"]) == 1
    for tag in jax_ev.Tags()["scalars"]:
        got = port_ev.Scalars(tag)
        expect = jax_ev.Scalars(tag)
        assert [e.step for e in got] == [e.step for e in expect], tag
        if tag.startswith("Loss/"):
            np.testing.assert_allclose([e.value for e in got],
                                       [e.value for e in expect],
                                       rtol=LOSS_RTOL, err_msg=tag)
    for tag in jax_ev.Tags()["images"]:
        assert [e.step for e in port_ev.Images(tag)] == [
            e.step for e in jax_ev.Images(tag)]
    with open(f"{jcfg.train.log_path}/{writer}/log.txt") as f:
        jax_lines = f.read().splitlines()
    with open(f"{pcfg.train.log_path}/{writer}/log.txt") as f:
        port_lines = f.read().splitlines()
    assert [line.split(",")[0] for line in port_lines] == [
        line.split(",")[0] for line in jax_lines]


def test_fit_saves_the_jax_steps(runs):
    jcfg, pcfg = runs
    jax_steps = sorted(int(n) for n in os.listdir(jcfg.train.ckpt_path)
                       if n.isdigit())
    assert jax_steps == [0, 2, 3]
    assert CheckpointManager(pcfg.train.ckpt_path).all_steps() == jax_steps
