"""Parity of the port's FFT-stack layers with the JAX package on the CPU:
multi-head attention, the FFT block and the PostNet at d = 64, 2 heads, from
a seeded JAX parameter tree converted by ``weights.py``.  Both sides compute
in f32 (the port's attention takes its plain version on the CPU), so the
tolerance is 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_nar_fast_tts_tpu.config import ModelConfig, TransformerConfig
from smart_nar_fast_tts_tpu.models import layers as jax_layers
from smart_nar_fast_tts_tpu_torch import config as tcfg
from smart_nar_fast_tts_tpu_torch.models import FastSpeech2Align
from smart_nar_fast_tts_tpu_torch.weights import jax_to_torch_acoustic
from torch_port_util import flatten, init_acoustic, random_variables

ATOL = 1e-5
D, HEADS, FILTER = 64, 2, 128


@pytest.fixture(scope="module")
def trees():
    cfg = ModelConfig(transformer=TransformerConfig(
        encoder_layer=1, encoder_head=HEADS, encoder_hidden=D,
        decoder_layer=1, decoder_head=HEADS, decoder_hidden=D,
        conv_filter_size=FILTER, conv_kernel_size=(9, 3)))
    variables = random_variables(init_acoustic(cfg)[1], seed=11)
    port_cfg = tcfg.ModelConfig(transformer=tcfg.TransformerConfig(
        encoder_layer=1, encoder_head=HEADS, encoder_hidden=D,
        decoder_layer=1, decoder_head=HEADS, decoder_hidden=D,
        conv_filter_size=FILTER, conv_kernel_size=(9, 3)))
    model = FastSpeech2Align(port_cfg)
    model.load_state_dict(jax_to_torch_acoustic(flatten(variables), port_cfg))
    return variables, model.eval()


def _inputs(B=3, L=21, C=D, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, L, C).astype(np.float32)
    lens = np.array([L, L - 5, 0])[:B]
    valid = np.arange(L)[None, :] < lens[:, None]
    cap = np.arange(L) < lens.max()
    return x, valid, cap


def test_multi_head_attention(trees):
    variables, model = trees
    x, valid, _ = _inputs(seed=1)
    p = variables["params"]["txt_encoder"]["layer_0"]["attn"]
    expect, _ = jax_layers.MultiHeadAttention(D, HEADS, 0.0).apply(
        {"params": p}, jnp.asarray(x), jnp.asarray(x), jnp.asarray(valid))
    with torch.no_grad():
        got, maps = model.txt_encoder.layer_stack[0].slf_attn(
            torch.from_numpy(x), torch.from_numpy(valid))
    assert maps is None                   # the flash path keeps no maps
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=ATOL)


@pytest.mark.parametrize("stack", ["txt_encoder", "mel_decoder"])
def test_fft_block(trees, stack):
    variables, model = trees
    x, valid, cap = _inputs(seed=2)
    p = variables["params"][stack]["layer_0"]
    expect, _ = jax_layers.FFTBlock(D, HEADS, FILTER, (9, 3), 0.0).apply(
        {"params": p}, jnp.asarray(x), jnp.asarray(valid),
        cap_valid=jnp.asarray(cap))
    with torch.no_grad():
        got, _ = getattr(model, stack).layer_stack[0](
            torch.from_numpy(x), torch.from_numpy(valid),
            torch.from_numpy(cap))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=ATOL)


def test_postnet(trees):
    variables, model = trees
    x, _, cap = _inputs(C=80, seed=3)
    expect = jax_layers.PostNet().apply(
        {"params": variables["params"]["postnet"],
         "batch_stats": variables["batch_stats"]["postnet"]},
        jnp.asarray(x), True, jnp.asarray(cap))
    with torch.no_grad():
        got = model.postnet(torch.from_numpy(x), torch.from_numpy(cap))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=ATOL)
