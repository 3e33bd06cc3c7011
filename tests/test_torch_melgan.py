"""Parity of the port's MelGAN generator (``vocoder/melgan.py``) with the
JAX package, on the CPU.

- The committed ``melgan_params.npz`` through ``assets/melgan_leaves.json``
  against JAX's ``apply`` on a seeded (2, 40, 80) mel within 1e-4.
- descript's melgan-neurips generator built with ``weight_norm`` (as
  ``tests/test_melgan.py`` builds it, the torch.hub layout), saved as its
  state dict and loaded through ``vocoder.load_melgan``: within 2e-5 /
  rtol 1e-4 of JAX's ``melgan_torch_to_flax`` of the same weights, and of
  the descript module itself.
- An odd ratio raises; ``melgan_inverse``'s ln 10 rescale, scale and trim
  against JAX's.
- One GAN step at the train_vocoder CLI's ``--debug_tiny`` MelGAN against
  JAX's ``make_vocoder_train_step``: metrics rtol 1e-4, parameters 1e-5.
- ``StreamingVocoder`` on a narrow MelGAN (reflect padding at the window
  edges) within 2e-5 of the full forward.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_nar_fast_tts_tpu.vocoder.melgan import (
    MelGANConfig as JaxConfig, MelGANGenerator as JaxGenerator,
    melgan_inverse as jax_melgan_inverse, melgan_torch_to_flax)
from smart_nar_fast_tts_tpu_torch.cli.train_vocoder import TINY_GENERATORS
from smart_nar_fast_tts_tpu_torch.vocoder import (MelGANConfig,
                                                  MelGANGenerator,
                                                  StreamingVocoder,
                                                  load_melgan,
                                                  melgan_inverse)
from smart_nar_fast_tts_tpu_torch.weights import (MELGAN_INDEX,
                                                  jax_to_torch_melgan,
                                                  load_committed)
from test_melgan import TINY as DESCRIPT_TINY
from test_melgan import _torch_generator as descript_generator
from torch_port_util import (RESULTS, check_gan_steps, committed_config,
                             flatten, init_vocoder, jax_gan_run,
                             one_torch_thread,  # noqa: F401
                             random_variables, zeros)

ATOL = 1e-4
DESCRIPT_ATOL, DESCRIPT_RTOL = 2e-5, 1e-4
STREAM_ATOL = 2e-5
NARROW = dict(n_mels=8, ngf=4, n_residual_layers=2, ratios=(4, 2))


def _pair(kw, seed):
    jax_gen, shapes = init_vocoder("melgan", JaxConfig(**kw))
    variables = random_variables(shapes, seed)
    config = MelGANConfig(**kw)
    gen = MelGANGenerator(config)
    gen.load_state_dict(jax_to_torch_melgan(flatten(variables), config))
    return jax_gen, variables, gen.eval()


def _run(gen, mel):
    with torch.no_grad():
        return gen(torch.from_numpy(mel)).numpy()


def test_committed_melgan_matches_jax():
    from benchmarks.train_flagship import load_variables_npz
    jax_config = committed_config("melgan")
    jax_gen, shapes = init_vocoder("melgan", jax_config)
    variables = load_variables_npz(f"{RESULTS}/melgan_params.npz",
                                   zeros(shapes))
    mel = (np.random.RandomState(51).randn(2, 40, 80) - 5.0).astype(
        np.float32)
    expect = np.asarray(jax.jit(jax_gen.apply)(variables, jnp.asarray(mel)))
    config = MelGANConfig.from_dict(jax_config.to_dict())
    assert config.ratios == (8, 8, 2, 2) and config.hop_length == 256
    gen = MelGANGenerator(config)
    gen.load_state_dict(jax_to_torch_melgan(load_committed(
        f"{RESULTS}/melgan_params.npz", MELGAN_INDEX), config))
    got = _run(gen.eval(), mel)
    assert got.shape == (2, 40 * 256)
    np.testing.assert_allclose(got, expect, atol=ATOL)


def test_descript_checkpoint_loads(tmp_path):
    """A torch.hub-layout state dict (every conv weight-normed) loads
    through ``load_melgan`` with its ``config.json``; the port, JAX's
    import of the same weights and the descript module agree."""
    oracle = descript_generator(DESCRIPT_TINY).eval()
    sd = {k: v.detach().clone() for k, v in oracle.state_dict().items()}
    assert any(k.endswith(".weight_g") for k in sd)
    torch.save(sd, tmp_path / "linda_johnson.pt")
    config = MelGANConfig.from_dict(DESCRIPT_TINY.to_dict())
    (tmp_path / "config.json").write_text(json.dumps(
        {"family": "melgan", **config.to_dict()}))
    gen = load_melgan(str(tmp_path / "linda_johnson.pt"))
    assert gen.config == config and not gen.training
    mel = np.random.RandomState(0).randn(2, 17, 8).astype(np.float32)
    variables = melgan_torch_to_flax(
        {k: v.numpy() for k, v in sd.items()}, DESCRIPT_TINY)
    expect = np.asarray(JaxGenerator(DESCRIPT_TINY).apply(
        variables, jnp.asarray(mel)))
    got = _run(gen, mel)
    assert got.shape == (2, 17 * 8)
    np.testing.assert_allclose(got, expect, atol=DESCRIPT_ATOL,
                               rtol=DESCRIPT_RTOL)
    with torch.no_grad():
        ref = oracle(torch.from_numpy(mel).transpose(1, 2))[:, 0].numpy()
    np.testing.assert_allclose(got, ref, atol=DESCRIPT_ATOL,
                               rtol=DESCRIPT_RTOL)


def test_odd_ratio_rejected():
    with pytest.raises(ValueError, match="even ratios"):
        MelGANGenerator(MelGANConfig(n_mels=8, ngf=4, n_residual_layers=1,
                                     ratios=(3, 2)))


def test_config_round_trip():
    config = MelGANConfig.from_dict({**MelGANConfig().to_dict(),
                                     "ratios": [8, 8, 4]})
    assert config.ratios == (8, 8, 4) and config.hop_length == 256
    assert MelGANConfig.from_dict(config.to_dict()) == config
    assert JaxConfig.from_dict(config.to_dict()).hop_length == 256


def test_inverse_scales_and_trims_as_jax():
    jax_gen, variables, gen = _pair(NARROW, seed=52)
    mel = (np.random.RandomState(53).randn(2, 10, 8) - 3.0).astype(
        np.float32)
    lens = np.asarray([10, 4])
    expect = jax_melgan_inverse(jax_gen, variables, jnp.asarray(mel),
                                mel_lens=lens)
    got = melgan_inverse(gen, mel, mel_lens=lens)
    assert [w.shape for w in got] == [(80,), (32,)]
    for g, e in zip(got, expect):
        np.testing.assert_allclose(g, e, atol=32768.0 * 1e-5)
    # the generator runs on log10 mels: natural log / ln 10
    np.testing.assert_allclose(
        melgan_inverse(gen, mel, max_wav_value=1.0)[0],
        _run(gen, mel / np.float32(np.log(10.0)))[0], atol=1e-6)


@pytest.fixture(scope="module")
def jax_gan():
    return jax_gan_run(JaxGenerator(JaxConfig(**TINY_GENERATORS["melgan"])))


def test_gan_step_matches_jax(jax_gan):
    config = MelGANConfig(**TINY_GENERATORS["melgan"])
    check_gan_steps(jax_gan, lambda: MelGANGenerator(config),
                    lambda flat: jax_to_torch_melgan(flat, config))


def test_streaming_matches_full_forward():
    _, _, gen = _pair(NARROW, seed=54)
    mel = np.random.RandomState(55).randn(90, 8).astype(np.float32)
    full = _run(gen, mel[None])[0]
    sv = StreamingVocoder(gen, chunk_frames=16)
    chunks = list(sv.synthesize_chunks(mel))
    assert len(chunks) == 6 and sv.window_frames < 90
    np.testing.assert_allclose(np.concatenate(chunks), full,
                               atol=STREAM_ATOL)
    online = np.concatenate(list(sv.stream(
        mel[i:i + 7] for i in range(0, 90, 7))))
    np.testing.assert_allclose(online, full, atol=STREAM_ATOL)
