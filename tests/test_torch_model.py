"""Parity of the port's ``FastSpeech2Align`` inference with the JAX model on
the CPU: a small configuration (2 + 2 layers, d = 64) with seeded weights,
and the committed flagship at full width at B = 2, L = 16.

Tolerances: log-duration, pitch and energy predictions 1e-4; rounded
durations and mel lengths exact; mel and postnet mel 1e-3.  Both sides are
f32 on the CPU (the JAX model with Pallas off, the port with its plain
versions); the slack over f32 rounding covers summation order through eight
FFT blocks and the five-conv PostNet.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.train_flagship import load_variables_npz
from smart_nar_fast_tts_tpu.config import (
    FeatureStats, ModelConfig, PreprocessConfig, TransformerConfig)
from smart_nar_fast_tts_tpu_torch import config as tcfg
from smart_nar_fast_tts_tpu_torch.models import FastSpeech2Align
from smart_nar_fast_tts_tpu_torch.weights import (
    FLAGSHIP_INDEX, jax_to_torch_acoustic, load_committed)
from torch_port_util import (FLAGSHIP_NPZ, RESULTS, flatten, init_acoustic,
                             random_variables, zeros)

PRED_ATOL = 1e-4
MEL_ATOL = 1e-3


def _compare(jax_model, variables, port_model, texts, src_lens, max_len,
             **controls):
    expect = jax.jit(lambda v, t, s: jax_model.apply(
        v, t, s, max_mel_len=max_len, **controls))(
            variables, jnp.asarray(texts), jnp.asarray(src_lens))
    with torch.no_grad():
        got = port_model(torch.from_numpy(texts), torch.from_numpy(src_lens),
                         max_mel_len=max_len, **controls)
    np.testing.assert_array_equal(got.duration_rounded.numpy(),
                                  np.asarray(expect.duration_rounded))
    np.testing.assert_array_equal(got.mel_lens.numpy(),
                                  np.asarray(expect.mel_lens))
    for name in ("log_duration_prediction", "pitch_prediction",
                 "energy_prediction"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(expect, name)),
                                   atol=PRED_ATOL, err_msg=name)
    for name in ("mel", "postnet_mel"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(expect, name)),
                                   atol=MEL_ATOL, err_msg=name)
    assert int(got.mel_lens.min()) > 0
    return got


@pytest.mark.parametrize("upsampling,level", [
    ("gaussian", "frame_level"), ("hard", "frame_level"),
    ("gaussian_banded", "phoneme_level")])
def test_small_config(upsampling, level):
    t = dict(encoder_layer=2, encoder_head=2, encoder_hidden=64,
             decoder_layer=2, decoder_head=2, decoder_hidden=64,
             conv_filter_size=128)
    stats = dict(pitch_min=-2.0, pitch_max=2.0, energy_min=-2.0,
                 energy_max=2.0)
    jax_model, shapes = init_acoustic(
        ModelConfig(transformer=TransformerConfig(**t),
                    upsampling=upsampling),
        PreprocessConfig(pitch_feature=level, energy_feature=level,
                         stats=FeatureStats(**stats)))
    variables = random_variables(shapes, seed=21)
    # ~4 frames per phoneme: round(exp(log d) - 1) with log d ≈ log 5
    variables["params"]["variance_adaptor"]["duration_predictor"][
        "linear_layer"]["bias"] += np.log(5.0)
    cfg = tcfg.ModelConfig(transformer=tcfg.TransformerConfig(**t),
                           upsampling=upsampling)
    port = FastSpeech2Align(cfg, tcfg.PreprocessConfig(
        pitch_feature=level, energy_feature=level,
        stats=tcfg.FeatureStats(**stats)))
    port.load_state_dict(jax_to_torch_acoustic(flatten(variables), cfg))
    rng = np.random.RandomState(22)
    texts = rng.randint(1, tcfg.VOCAB_SIZE, size=(3, 12)).astype(np.int32)
    src_lens = np.array([12, 9, 5], np.int32)
    _compare(jax_model, variables, port.eval(), texts, src_lens, 64,
             p_control=1.1, e_control=0.9, d_control=1.2)


def test_committed_flagship_full_width():
    with open(os.path.join(RESULTS, "flagship_meta.json")) as f:
        meta = json.load(f)
    jax_model, shapes = init_acoustic(pre=PreprocessConfig(
        stats=FeatureStats(**meta["stats"])))
    variables = load_variables_npz(FLAGSHIP_NPZ, zeros(shapes))
    port = FastSpeech2Align(tcfg.ModelConfig(), tcfg.PreprocessConfig(
        stats=tcfg.FeatureStats(**meta["stats"])))
    port.load_state_dict(jax_to_torch_acoustic(
        load_committed(FLAGSHIP_NPZ, FLAGSHIP_INDEX)))
    rng = np.random.default_rng(0)
    texts = rng.choice(np.asarray(meta["phone_ids"], np.int32), size=(2, 16))
    src_lens = np.array([16, 11], np.int32)
    got = _compare(jax_model, variables, port.eval(), texts, src_lens, 256)
    assert int(got.mel_lens.max()) < 256      # no item was cut at the cap


def test_flagship_attention_logits_outrun_bf16():
    """Why self-attention runs the bf16 flash kernel only where the JAX
    model does (past ``FLASH_MIN_LEN`` frames) and the f32 einsum branch
    below: the committed flagship's attention logits QKᵀ/√D exceed 1e3, so
    rounding q·scale and k to bf16, as the TPU kernel and the port's CUDA
    kernel do, moves them by more than 1, which reorders the softmax.  The
    threshold is patched to 0 here so that all 8 self-attentions reach the
    spy at a CPU-sized length."""
    from unittest import mock

    from smart_nar_fast_tts_tpu_torch.kernels import flash_attention
    from smart_nar_fast_tts_tpu_torch.models import layers
    with open(os.path.join(RESULTS, "flagship_meta.json")) as f:
        meta = json.load(f)
    port = FastSpeech2Align(tcfg.ModelConfig(), tcfg.PreprocessConfig(
        stats=tcfg.FeatureStats(**meta["stats"])))
    port.load_state_dict(jax_to_torch_acoustic(
        load_committed(FLAGSHIP_NPZ, FLAGSHIP_INDEX)))
    logits, shifts = [], []

    def spy(q, k, v, key_valid):
        scale = q.shape[-1] ** -0.5
        exact = torch.einsum("bhqd,bhkd->bhqk", q * scale, k)
        rounded = torch.einsum(
            "bhqd,bhkd->bhqk", (q * scale).bfloat16().float(),
            k.bfloat16().float())
        valid = key_valid[:, None, None, :]
        logits.append(exact[valid.expand_as(exact)].abs().max().item())
        shifts.append((exact - rounded)[valid.expand_as(exact)].abs().max()
                      .item())
        return flash_attention(q, k, v, key_valid)

    rng = np.random.default_rng(0)
    texts = rng.choice(np.asarray(meta["phone_ids"]), size=(2, 16))
    with mock.patch.object(layers, "flash_attention", spy), \
            mock.patch.object(layers, "FLASH_MIN_LEN", 0), torch.no_grad():
        port.eval()(torch.from_numpy(texts), torch.tensor([16, 11]),
                    max_mel_len=256)
    assert len(logits) == 8                   # 4 encoder + 4 decoder layers
    assert max(logits) > 1e3
    assert max(shifts) > 1.0
