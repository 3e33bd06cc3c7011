"""The port's checkpoints and vocoder loader.

- ``training.checkpoint.CheckpointManager`` (the port's own format:
  ``<dir>/<step>/state.pt`` + ``data.json``): a save and restore round trip
  of the model, the optimizer after an update, the step and the data state
  (exact), retention, the latest step, and the JAX manager's return shape
  when nothing is saved; which saves ``save_interval_steps`` and ``force``
  let through, step for step as orbax's ``CheckpointManager`` (the JAX
  manager's) decides them, on a fresh directory and on one that holds a
  step.
- ``vocoder.convert``: ``fold_weight_norm`` against the JAX package's
  (float64 on both sides: exact), and ``load_hifigan`` of an upstream-layout
  torch file against the JAX package's ``load_hifigan`` of the same file:
  the waveform within 1e-4 (f32 convolutions on both sides, the HiFi-GAN
  parity tolerance of ``tests/test_torch_hifigan.py``); an unknown family
  raises.  The other families and the ``.msgpack`` format are held in
  ``tests/test_torch_vocoder_checkpoint.py``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from smart_nar_fast_tts_tpu.vocoder import convert as jax_convert
from smart_nar_fast_tts_tpu.vocoder import hifigan_infer
from smart_nar_fast_tts_tpu_torch.config import (ModelConfig,
                                                 OptimizerConfig,
                                                 TransformerConfig,
                                                 VarianceEmbeddingConfig,
                                                 VariancePredictorConfig)
from smart_nar_fast_tts_tpu_torch.models import FastSpeech2Align
from smart_nar_fast_tts_tpu_torch.training import (CheckpointManager,
                                                   create_train_state)
from smart_nar_fast_tts_tpu_torch.vocoder import convert
from torch_port_util import write_upstream_hifigan

WAV_ATOL = 1e-4


def _tiny_state(seed):
    torch.manual_seed(seed)
    cfg = ModelConfig(
        transformer=TransformerConfig(
            encoder_layer=1, encoder_hidden=16, decoder_layer=1,
            decoder_hidden=16, conv_filter_size=32),
        variance_predictor=VariancePredictorConfig(filter_size=16),
        variance_embedding=VarianceEmbeddingConfig(n_bins=16),
        multi_speaker=True, n_speakers=3)
    return create_train_state(FastSpeech2Align(cfg), OptimizerConfig(),
                              "cpu")


def _step(state):
    for p in state.params:
        p.grad = torch.full_like(p, 0.01)
    state.apply_gradients()


def test_save_and_restore_round_trip(tmp_path):
    state = _tiny_state(0)
    _step(state)
    _step(state)
    mngr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mngr.save(state, {"epoch": 3, "position": 17}) is True
    assert mngr.all_steps() == [2]
    fresh = _tiny_state(1)
    got, data = mngr.restore(fresh)
    assert got is fresh and got.step == 2 and data == {"epoch": 3,
                                                       "position": 17}
    for (k, a), (_, b) in zip(state.model.state_dict().items(),
                              got.model.state_dict().items()):
        assert torch.equal(a, b), k
    a_opt, b_opt = state.optimizer.state_dict(), got.optimizer.state_dict()
    assert a_opt["param_groups"] == b_opt["param_groups"]
    for i, s in a_opt["state"].items():
        for name, value in s.items():
            assert torch.equal(value, b_opt["state"][i][name])
    # the next update continues from the restored moments alike
    _step(state)
    _step(got)
    for a, b in zip(state.params, got.params):
        assert torch.equal(a, b)


def test_retention_latest_and_empty(tmp_path):
    state = _tiny_state(0)
    mngr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    assert mngr.latest_step() is None
    same, data = mngr.restore(state)
    assert same is state and data is None and state.step == 0
    for _ in range(4):
        _step(state)
        mngr.save(state)
    assert mngr.all_steps() == [3, 4] and mngr.latest_step() == 4
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["3", "4"]
    got, _ = CheckpointManager(str(tmp_path / "ckpt")).restore(
        _tiny_state(1), step=3)
    assert got.step == 3
    with pytest.raises(FileNotFoundError, match="step 1"):
        mngr.restore(_tiny_state(1), step=1)


# (step, force) in the order a trainer asks: every step's cadence, a resume
# past the last save, a step below the latest, the final forced save
SAVE_CALLS = [(1, False), (2, False), (3, False), (4, False), (5, False),
              (6, False), (7, False), (7, True), (5, False), (9, False),
              (10, False), (11, True)]


def _orbax_saved(directory, interval, first):
    mngr = ocp.CheckpointManager(
        directory, options=ocp.CheckpointManagerOptions(
            max_to_keep=None, save_interval_steps=interval, create=True))
    out = []
    for step, force in [(first, True)] * (first is not None) + SAVE_CALLS:
        if mngr.latest_step() == step and force:
            continue            # orbax refuses to overwrite; no trainer asks
        out.append(mngr.save(step, args=ocp.args.StandardSave(
            {"x": np.zeros(2, np.float32)}), force=force))
        mngr.wait_until_finished()
    mngr.close()
    return out, sorted(int(n) for n in os.listdir(directory) if n.isdigit())


@pytest.mark.parametrize("interval, first", [(3, None), (3, 0), (1, None),
                                             (4, 2)])
def test_save_interval_matches_orbax(tmp_path, interval, first):
    expect = _orbax_saved(str(tmp_path / "orbax"), interval, first)
    state = _tiny_state(0)
    mngr = CheckpointManager(str(tmp_path / "port"), max_to_keep=None,
                             save_interval_steps=interval)
    got = []
    for step, force in [(first, True)] * (first is not None) + SAVE_CALLS:
        if mngr.latest_step() == step and force:
            continue
        state.step = step
        got.append(mngr.save(state, force=force))
    assert (got, mngr.all_steps()) == expect


def test_fold_weight_norm_matches_jax():
    rng = np.random.RandomState(0)
    sd = {"a.weight_v": rng.randn(6, 4, 3), "a.weight_g": rng.rand(6, 1, 1),
          "a.bias": rng.randn(6), "b.weight_v": rng.randn(4, 2, 5),
          "b.weight_g": rng.rand(4, 1, 1), "c.weight": rng.randn(3, 3, 1)}
    ours, theirs = convert.fold_weight_norm(sd), jax_convert.fold_weight_norm(
        sd)
    assert sorted(ours) == sorted(theirs) == ["a.bias", "a.weight",
                                              "b.weight", "c.weight"]
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_load_hifigan_matches_jax(tmp_path):
    path = write_upstream_hifigan(tmp_path / "voc", seed=3)
    gen = convert.load_vocoder(path)
    assert not gen.training and gen.config.upsample_initial_channel == 32
    mel = (np.random.RandomState(4).randn(1, 12, 80) - 5.0).astype(
        np.float32)
    with torch.no_grad():
        got = gen(torch.from_numpy(mel)).numpy()
    jgen, variables = jax_convert.load_vocoder(path)
    expect = hifigan_infer(jgen, variables, jnp.asarray(mel),
                           max_wav_value=1.0)[0]
    assert got.shape == (1, 12 * 256)
    np.testing.assert_allclose(got[0], expect, atol=WAV_ATOL, rtol=0)


def test_vocoders_not_ported_raise(tmp_path):
    """No family or format is refused any longer; what still raises is an
    unknown family (``ValueError``), and a checkpoint of another family
    than its ``config.json`` names (a state dict that does not fit)."""
    path = write_upstream_hifigan(tmp_path / "voc")
    with open(tmp_path / "voc" / "config.json") as f:
        config = json.load(f)
    with open(tmp_path / "voc" / "config.json", "w") as f:
        json.dump({**config, "family": "wavenet"}, f)
    with pytest.raises(ValueError, match="unknown vocoder family"):
        convert.load_vocoder(path)
    with open(tmp_path / "voc" / "config.json", "w") as f:
        json.dump({"family": "vocos"}, f)
    with pytest.raises(RuntimeError, match="state_dict"):
        convert.load_vocoder(path)
