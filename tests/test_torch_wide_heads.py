"""The port at FastSpeech's widths against the JAX package on the CPU: 384
hidden, 2 heads (head dim 192, the width the tensor-core kernels take past
128 on the card), conv filter 1536 (Ren et al. 2019, "FastSpeech",
"Model Configuration"), cut to 1 + 1 layers, B 2, L 16, T 48, with seeded
weights mapped through ``weights.py``.

- Inference: rounded durations and mel lengths exact; log-duration, pitch
  and energy predictions 1e-4; mel and postnet mel 1e-3 (ROADMAP's
  tolerances).
- The training forward on the alignment kernel's configuration
  (``intended``/``first``), JAX with ``SMART_TTS_PALLAS=interpret`` (its
  fused Pallas alignment kernel at head dim 192 in interpret mode): duration
  targets exact, guided numerators 1e-4, the loss terms rtol 1e-5 (the
  total 1e-4), variance predictions 1e-4, mels 1e-3.

Both sides are f32 on the CPU; JAX's dropout is patched off inside these
tests only, as the port's is by passing no generator.
"""

import copy

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_nar_fast_tts_tpu.config import (FeatureStats, ModelConfig,
                                           PreprocessConfig,
                                           TransformerConfig)
from smart_nar_fast_tts_tpu.models import FastSpeech2Loss as JaxLoss
from smart_nar_fast_tts_tpu_torch import config as tcfg
from smart_nar_fast_tts_tpu_torch.models import (FastSpeech2Align,
                                                 FastSpeech2Loss)
from smart_nar_fast_tts_tpu_torch.weights import jax_to_torch_acoustic
from torch_port_util import flatten, init_acoustic, random_variables

WIDTHS = dict(encoder_layer=1, encoder_head=2, encoder_hidden=384,
              decoder_layer=1, decoder_head=2, decoder_hidden=384,
              conv_filter_size=1536)
STATS = dict(pitch_min=-2.0, pitch_max=2.0, energy_min=-2.0, energy_max=2.0)
B, L, T = 2, 16, 48
PRED_ATOL, MEL_ATOL = 1e-4, 1e-3
GNUM_ATOL, LOSS_RTOL, TOTAL_RTOL = 1e-4, 1e-5, 1e-4


@pytest.fixture(scope="module")
def models():
    """The JAX and port models on one seeded tree (``intended``/``first``),
    the duration head biased to ~3 frames a phoneme, so that inference fills
    most of T."""
    jcfg = ModelConfig(transformer=TransformerConfig(**WIDTHS),
                       duration_extraction="intended",
                       duration_head_reduce="first")
    jax_model, shapes = init_acoustic(
        jcfg, PreprocessConfig(stats=FeatureStats(**STATS)))
    variables = random_variables(shapes, seed=41)
    variables["params"]["variance_adaptor"]["duration_predictor"][
        "linear_layer"]["bias"] += np.log(5.0)
    pcfg = tcfg.ModelConfig(transformer=tcfg.TransformerConfig(**WIDTHS),
                            duration_extraction="intended",
                            duration_head_reduce="first")
    port = FastSpeech2Align(pcfg, tcfg.PreprocessConfig(
        stats=tcfg.FeatureStats(**STATS)))
    port.load_state_dict(jax_to_torch_acoustic(flatten(variables), pcfg))
    assert port.mel_encoder.layer_stack[0].crs_attn.d_k == 192
    return jax_model, variables, port


@pytest.fixture
def no_jax_dropout(monkeypatch):
    monkeypatch.setattr(flax_nn.Dropout, "__call__",
                        lambda self, x, *args, **kwargs: x)


def _inputs():
    rng = np.random.RandomState(42)
    return dict(texts=rng.randint(2, 300, (B, L)).astype(np.int32),
                src_lens=np.array([16, 11], np.int32),
                mels=rng.randn(B, T, 80).astype(np.float32),
                mel_lens=np.array([48, 37], np.int32),
                pitch=rng.randn(B, T).astype(np.float32),
                energy=rng.randn(B, T).astype(np.float32))


def _close(got, expect, names, atol):
    for name in names:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(expect, name)),
                                   atol=atol, err_msg=name)


def test_fastspeech_width_inference(models, monkeypatch):
    jax_model, variables, port = models
    monkeypatch.setenv("SMART_TTS_PALLAS", "interpret")
    a = _inputs()
    expect = jax.jit(lambda v, t, s: jax_model.apply(
        v, t, s, max_mel_len=T))(variables, jnp.asarray(a["texts"]),
                                 jnp.asarray(a["src_lens"]))
    with torch.no_grad():
        got = copy.deepcopy(port).eval()(
            torch.from_numpy(a["texts"]), torch.from_numpy(a["src_lens"]),
            max_mel_len=T)
    np.testing.assert_array_equal(got.duration_rounded.numpy(),
                                  np.asarray(expect.duration_rounded))
    np.testing.assert_array_equal(got.mel_lens.numpy(),
                                  np.asarray(expect.mel_lens))
    assert int(got.mel_lens.min()) > L
    _close(got, expect, ("log_duration_prediction", "pitch_prediction",
                         "energy_prediction"), PRED_ATOL)
    _close(got, expect, ("mel", "postnet_mel"), MEL_ATOL)


def test_fastspeech_width_training_forward(models, no_jax_dropout,
                                           monkeypatch):
    jax_model, variables, port = models
    monkeypatch.setenv("SMART_TTS_PALLAS", "interpret")
    a = _inputs()
    j = {k: jnp.asarray(v) for k, v in a.items()}
    expect, _ = jax.jit(lambda v: jax_model.apply(
        v, j["texts"], j["src_lens"], mels=j["mels"], mel_lens=j["mel_lens"],
        p_targets=j["pitch"], e_targets=j["energy"], deterministic=False,
        rngs={"dropout": jax.random.PRNGKey(0)},
        mutable=["batch_stats"]))(variables)
    e_losses = JaxLoss(PreprocessConfig(stats=FeatureStats(**STATS)))(
        expect, j["mels"], j["pitch"], j["energy"])
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    with torch.no_grad():
        got = copy.deepcopy(port).train()(
            t["texts"], t["src_lens"], mels=t["mels"], mel_lens=t["mel_lens"],
            p_targets=t["pitch"], e_targets=t["energy"])
    losses = FastSpeech2Loss(tcfg.PreprocessConfig())(
        got, t["mels"], t["pitch"], t["energy"])

    np.testing.assert_array_equal(got.duration_targets.numpy(),
                                  np.asarray(expect.duration_targets))
    np.testing.assert_array_equal(got.duration_targets.sum(1).numpy(),
                                  a["mel_lens"])
    np.testing.assert_allclose(got.guided_numerators.numpy(),
                               np.asarray(expect.guided_numerators),
                               atol=GNUM_ATOL)
    _close(got, expect, ("log_duration_prediction", "pitch_prediction",
                         "energy_prediction"), PRED_ATOL)
    _close(got, expect, ("mel", "postnet_mel"), MEL_ATOL)
    for name in losses._fields:
        np.testing.assert_allclose(
            float(getattr(losses, name)), float(getattr(e_losses, name)),
            rtol=TOTAL_RTOL if name == "total" else LOSS_RTOL, err_msg=name)
