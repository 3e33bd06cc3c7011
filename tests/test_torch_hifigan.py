"""Parity of the port's HiFi-GAN V1 generator with the JAX generator
(``tail_impl="plain"``) on the CPU: the committed ``vocoder_params.npz`` at
8 mel frames, and a narrow configuration with seeded weights.  Both sides
are f32 convolutions; the waveform (in [-1, 1]) agrees to 1e-4."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from benchmarks.train_flagship import load_variables_npz
from smart_nar_fast_tts_tpu.vocoder import HiFiGANConfig as JaxConfig
from smart_nar_fast_tts_tpu.vocoder import HiFiGANGenerator as JaxGenerator
from smart_nar_fast_tts_tpu_torch.vocoder import (HiFiGANConfig,
                                                  HiFiGANGenerator)
from smart_nar_fast_tts_tpu_torch.weights import (
    HIFIGAN_INDEX, jax_to_torch_hifigan, load_committed)
from torch_port_util import (RESULTS, VOCODER_NPZ, flatten, init_hifigan,
                             random_variables, zeros)

ATOL = 1e-4


def _mel(B, T, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, 80) - 5.0).astype(np.float32)


def _run_port(config, state, mel):
    gen = HiFiGANGenerator(config)
    gen.load_state_dict(state)
    with torch.no_grad():
        return gen.eval()(torch.from_numpy(mel)).numpy()


def test_committed_vocoder():
    with open(os.path.join(RESULTS, "vocoder_meta.json")) as f:
        cfg_dict = json.load(f)["config"]
    jax_cfg = JaxConfig.from_dict({**cfg_dict, "tail_impl": "plain",
                                   "transpose_impl": "dilated"})
    _, shapes = init_hifigan(jax_cfg)
    variables = load_variables_npz(VOCODER_NPZ, zeros(shapes))
    mel = _mel(2, 8, seed=31)
    expect = np.asarray(jax.jit(JaxGenerator(jax_cfg).apply)(
        variables, jnp.asarray(mel)))
    config = HiFiGANConfig.from_dict(cfg_dict)
    got = _run_port(config, jax_to_torch_hifigan(
        load_committed(VOCODER_NPZ, HIFIGAN_INDEX), config), mel)
    assert got.shape == (2, 8 * config.hop_length)
    np.testing.assert_allclose(got, expect, atol=ATOL)


def test_narrow_config_seeded_weights():
    kw = dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
              upsample_initial_channel=32, resblock_kernel_sizes=(3, 5),
              resblock_dilation_sizes=((1, 3), (1, 2)))
    jax_cfg = JaxConfig(**kw, tail_impl="plain", transpose_impl="dilated")
    jax_gen, shapes = init_hifigan(jax_cfg)
    variables = random_variables(shapes, seed=32)
    mel = _mel(2, 11, seed=33)
    expect = np.asarray(jax.jit(jax_gen.apply)(variables, jnp.asarray(mel)))
    config = HiFiGANConfig(**kw)
    got = _run_port(config, jax_to_torch_hifigan(flatten(variables), config),
                    mel)
    np.testing.assert_allclose(got, expect, atol=ATOL)
