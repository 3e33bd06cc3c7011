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
    expect, expect_maps = jax_layers.MultiHeadAttention(D, HEADS, 0.0).apply(
        {"params": p}, jnp.asarray(x), jnp.asarray(x), jnp.asarray(valid))
    with torch.no_grad():
        got, maps = model.txt_encoder.layer_stack[0].slf_attn(
            torch.from_numpy(x), torch.from_numpy(valid))
    # below FLASH_MIN_LEN both take the einsum branch and return its maps
    np.testing.assert_allclose(maps.numpy(), np.asarray(expect_maps),
                               atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=ATOL)


@pytest.mark.parametrize("length, calls", [(64, 0), (2049, 1)])
def test_self_attention_dispatch(length, calls):
    """Self-attention reaches the flash kernel's wrapper only past
    ``FLASH_MIN_LEN`` (2048) frames, as the JAX model
    (``smart_nar_fast_tts_tpu/models/layers.py:106-117``); shorter ones
    take the f32 einsum branch."""
    from unittest import mock

    from smart_nar_fast_tts_tpu_torch.kernels import flash_attention
    from smart_nar_fast_tts_tpu_torch.models import layers
    seen = []

    def spy(q, k, v, key_valid):
        seen.append(tuple(q.shape))
        return flash_attention(q, k, v, key_valid)

    torch.manual_seed(0)
    attn = layers.MultiHeadAttention(8, 1)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, length, 8)).astype(np.float32))
    valid = torch.ones(1, length, dtype=torch.bool)
    with mock.patch.object(layers, "flash_attention", spy), torch.no_grad():
        out, maps = attn(x, valid)
    assert seen == [(1, 1, length, 8)] * calls
    assert (maps is None) == (calls == 1)
    assert out.shape == (1, length, 8) and torch.isfinite(out).all()


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
