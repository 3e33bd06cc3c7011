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


V3_NARROW = dict(resblock="2", upsample_rates=(4, 2),
                 upsample_kernel_sizes=(8, 4), upsample_initial_channel=32,
                 resblock_kernel_sizes=(3, 5, 7),
                 resblock_dilation_sizes=((1, 2), (2, 6), (3, 12)))


def test_resblock2_v3_seeded_weights():
    """HiFi-GAN V3's ResBlock2 (one conv per dilation) on a narrow tree
    with V3's resblock kernels and dilations, within 1e-5 of JAX."""
    jax_cfg = JaxConfig(**V3_NARROW, tail_impl="plain",
                        transpose_impl="dilated")
    jax_gen, shapes = init_hifigan(jax_cfg)
    variables = random_variables(shapes, seed=34)
    mel = _mel(2, 11, seed=35)
    expect = np.asarray(jax.jit(jax_gen.apply)(variables, jnp.asarray(mel)))
    config = HiFiGANConfig(**V3_NARROW)
    got = _run_port(config, jax_to_torch_hifigan(flatten(variables), config),
                    mel)
    np.testing.assert_allclose(got, expect, atol=1e-5)


def test_upstream_v3_checkpoint_loads(tmp_path):
    """An upstream-layout V3 file (ResBlock2's ``convs``, weight-normed)
    loads through ``load_hifigan`` and vocodes as the JAX package's loader
    of the same file does."""
    from smart_nar_fast_tts_tpu.vocoder import load_hifigan as jax_load
    from smart_nar_fast_tts_tpu_torch.vocoder import load_hifigan
    from smart_nar_fast_tts_tpu_torch.vocoder.hifigan import ResBlock2
    from torch_port_util import write_upstream_hifigan
    config = {**HiFiGANConfig(**V3_NARROW).to_dict(), "tail_impl": "plain",
              "transpose_impl": "dilated"}
    path = write_upstream_hifigan(tmp_path, config, seed=36)
    gen = load_hifigan(path)
    assert gen.config.resblock == "2"
    assert all(isinstance(b, ResBlock2) for b in gen.resblocks)
    jax_gen, jax_vars = jax_load(path)
    mel = _mel(1, 9, seed=37)
    expect = np.asarray(jax_gen.apply(jax_vars, jnp.asarray(mel)))
    with torch.no_grad():
        got = gen(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, expect, atol=1e-5)


def test_from_dict_keeps_compute_dtype():
    """ROADMAP §C.7: ``from_dict`` dropped ``compute_dtype``, so a bf16
    vocoder config ran in f32 in the port and in bf16 in the JAX package."""
    config = HiFiGANConfig.from_dict({"num_mels": 80,
                                      "compute_dtype": "bfloat16"})
    assert config.compute_dtype == "bfloat16"
    assert config.to_dict()["compute_dtype"] == "bfloat16"
    assert HiFiGANConfig.from_dict(config.to_dict()) == config
    assert JaxConfig.from_dict(config.to_dict()).compute_dtype == "bfloat16"


def test_bfloat16_generator_tracks_jax_bfloat16():
    """The bf16 conv stack (f32 parameters rounded per call, conv_post and
    tanh in f32) against JAX's bf16 generator: f32 output, mean relative
    error below JAX's own bf16 bar against f32 (tests/test_vocoder.py)."""
    kw = dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
              upsample_initial_channel=32, resblock_kernel_sizes=(3, 5),
              resblock_dilation_sizes=((1, 3), (1, 2)),
              compute_dtype="bfloat16")
    jax_gen, shapes = init_hifigan(JaxConfig(**kw, tail_impl="plain"))
    variables = random_variables(shapes, seed=38)
    mel = _mel(2, 13, seed=39)
    expect = np.asarray(jax.jit(jax_gen.apply)(variables, jnp.asarray(mel)))
    config = HiFiGANConfig(**kw)
    got = _run_port(config, jax_to_torch_hifigan(flatten(variables), config),
                    mel)
    assert got.dtype == np.float32 and expect.dtype == np.float32
    rel = np.abs(got - expect).mean() / np.abs(expect).mean()
    assert rel < 0.08, rel
