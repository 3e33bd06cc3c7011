"""Parity of the port's Vocos generator (``vocoder/vocos.py``) and its
inverse STFT by matrix products (``audio/stft.py`` ``istft_matmul``) with
the JAX package, on the CPU.

- ``istft_matmul`` against JAX's at n_fft/hop 1024/256, 32/8 and 40/12 (a
  hop that does not divide n_fft: JAX's scatter-add overlap-add, the port's
  ``F.fold``) within 1e-5; the port's FFT ``istft`` against its own
  ``istft_matmul`` within 2e-4 (JAX's bar, ``tests/test_vocos.py``).
- The committed ``vocos_params.npz`` through ``assets/vocos_leaves.json``
  against JAX's ``apply`` on a seeded (2, 40, 80) mel within 1e-4, and a
  narrow seeded tree (LayerNorm inputs of small variance, where flax's
  epsilon 1e-6 and its tanh GELU show) within 1e-5.
- bf16: a narrow seeded tree against JAX's bf16 generator (``apply``
  without ``jit``), mean relative error below 0.08; the magnitude cap
  (finite at ×100 parameters); ``vocos_infer``'s clip and trim against
  JAX's.
- One GAN step at the train_vocoder CLI's ``--debug_tiny`` Vocos against
  JAX's ``make_vocoder_train_step``: metrics rtol 1e-4, parameters 1e-5.
- ``StreamingVocoder`` on a narrow Vocos within 2e-5 of the full forward
  (JAX's bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_nar_fast_tts_tpu.audio import stft as jax_stft
from smart_nar_fast_tts_tpu.vocoder import VocosConfig as JaxConfig
from smart_nar_fast_tts_tpu.vocoder import VocosGenerator as JaxGenerator
from smart_nar_fast_tts_tpu.vocoder import vocos_infer as jax_vocos_infer
from smart_nar_fast_tts_tpu_torch.audio import (MelSpectrogramConfig, istft,
                                                istft_matmul)
from smart_nar_fast_tts_tpu_torch.audio.stft import _irdft_bases
from smart_nar_fast_tts_tpu_torch.cli.train_vocoder import TINY_GENERATORS
from smart_nar_fast_tts_tpu_torch.vocoder import (StreamingVocoder,
                                                  VocosConfig, VocosGenerator,
                                                  vocos_infer)
from smart_nar_fast_tts_tpu_torch.weights import (VOCOS_INDEX,
                                                  jax_to_torch_vocos,
                                                  load_committed)
from torch_port_util import (RESULTS, check_gan_steps, committed_config,
                             flatten, init_vocoder, jax_gan_run,
                             one_torch_thread,  # noqa: F401
                             random_variables, zeros)

ATOL = 1e-4          # the committed generator's waveform
NARROW_ATOL = 1e-5   # a narrow seeded generator's
ISTFT_ATOL = 1e-5    # istft_matmul against JAX's
BF16_REL = 0.08      # mean relative error, bf16 against JAX's bf16
STREAM_ATOL = 2e-5   # chunks against the full forward
NARROW = dict(n_mels=8, dim=16, intermediate=32, n_layers=2, n_fft=32,
              hop=8, win_length=32)


def _pair(kw, seed, shrink_embed=1.0):
    """The JAX generator, seeded variables and the port's generator with
    the same weights.  ``shrink_embed`` scales the embed conv, so the first
    LayerNorm sees inputs of small variance."""
    jax_gen, shapes = init_vocoder("vocos", JaxConfig(**kw))
    variables = random_variables(shapes, seed)
    variables["params"]["embed"]["kernel"] *= np.float32(shrink_embed)
    variables["params"]["embed"]["bias"] *= np.float32(shrink_embed)
    config = VocosConfig(**kw)
    gen = VocosGenerator(config)
    gen.load_state_dict(jax_to_torch_vocos(flatten(variables), config))
    return jax_gen, variables, gen.eval()


def _run(gen, mel):
    with torch.no_grad():
        return gen(torch.from_numpy(mel)).numpy()


@pytest.mark.parametrize("n_fft, hop", [(1024, 256), (32, 8), (40, 12)])
def test_istft_matmul_matches_jax(n_fft, hop):
    rng = np.random.RandomState(7)
    f, bins = 9, n_fft // 2 + 1
    mag = np.abs(rng.randn(2, bins, f)).astype(np.float32)
    phase = rng.uniform(-np.pi, np.pi, (2, bins, f)).astype(np.float32)
    kw = dict(n_fft=n_fft, hop_length=hop, win_length=n_fft, n_mels=8,
              mel_fmax=None)
    expect = np.asarray(jax_stft.istft_matmul(
        jnp.asarray(mag), jnp.asarray(phase),
        jax_stft.MelSpectrogramConfig(**kw)))
    cfg = MelSpectrogramConfig(**kw)
    got = istft_matmul(torch.from_numpy(mag), torch.from_numpy(phase), cfg)
    assert got.shape == expect.shape == (2, hop * (f - 1))
    np.testing.assert_allclose(got.numpy(), expect, atol=ISTFT_ATOL)
    by_fft = istft(torch.from_numpy(mag), torch.from_numpy(phase), cfg)
    np.testing.assert_allclose(got.numpy(), by_fft.numpy(),
                               atol=2e-4 if n_fft > 64 else 1e-5)


def test_irdft_bases_match_jax():
    """Built in float64, stored as f32, cached per (n_fft, device)."""
    c, s = _irdft_bases(64)
    assert c.dtype == s.dtype == torch.float32 and c.shape == (33, 64)
    assert _irdft_bases(64)[0] is c
    jc, js = jax_stft._irdft_bases(64)
    np.testing.assert_array_equal(c.numpy(), jc)
    np.testing.assert_array_equal(s.numpy(), js)


def test_committed_vocos_matches_jax():
    from benchmarks.train_flagship import load_variables_npz
    jax_config = committed_config("vocos")
    jax_gen, shapes = init_vocoder("vocos", jax_config)
    variables = load_variables_npz(f"{RESULTS}/vocos_params.npz",
                                   zeros(shapes))
    mel = (np.random.RandomState(31).randn(2, 40, 80) - 5.0).astype(
        np.float32)
    expect = np.asarray(jax.jit(jax_gen.apply)(variables, jnp.asarray(mel)))
    config = VocosConfig.from_dict(jax_config.to_dict())
    gen = VocosGenerator(config)
    gen.load_state_dict(jax_to_torch_vocos(load_committed(
        f"{RESULTS}/vocos_params.npz", VOCOS_INDEX), config))
    got = _run(gen.eval(), mel)
    assert got.shape == (2, 40 * config.hop_length)
    np.testing.assert_allclose(got, expect, atol=ATOL)


@pytest.mark.parametrize("dw_kernel", [7, 4])
def test_narrow_seeded_matches_jax(dw_kernel):
    """LayerNorm inputs of variance ~1e-5 (the embed conv scaled down), so
    an epsilon of 1e-5 for flax's 1e-6 would show, as would an exact GELU
    for flax's tanh one; an even depthwise kernel pads (r, k//2)."""
    kw = dict(NARROW, dw_kernel=dw_kernel)
    jax_gen, variables, gen = _pair(kw, seed=41, shrink_embed=3e-3)
    mel = np.random.RandomState(42).randn(2, 13, 8).astype(np.float32)
    expect = np.asarray(jax.jit(jax_gen.apply)(variables, jnp.asarray(mel)))
    got = _run(gen, mel)
    assert got.shape == (2, 13 * 8)
    np.testing.assert_allclose(got, expect, atol=NARROW_ATOL)


def test_bfloat16_tracks_jax_bfloat16():
    kw = dict(NARROW, compute_dtype="bfloat16")
    jax_gen, variables, gen = _pair(kw, seed=43)
    mel = np.random.RandomState(44).randn(2, 16, 8).astype(np.float32)
    expect = np.asarray(jax_gen.apply(variables, jnp.asarray(mel)))
    got = _run(gen, mel)
    assert got.dtype == np.float32 and expect.dtype == np.float32
    rel = np.abs(got - expect).mean() / np.abs(expect).mean()
    assert rel < BF16_REL, rel
    f32 = VocosGenerator(VocosConfig(**NARROW))
    f32.load_state_dict(gen.state_dict())
    rel32 = np.abs(got - _run(f32.eval(), mel)).mean() / np.abs(got).mean()
    assert 0 < rel32 < 0.1, rel32         # bf16 is not f32, and near it


def test_magnitude_is_capped():
    """exp of the head's log-magnitude is capped at 100: a wild head (every
    parameter ×100, an absurd mel) still gives finite audio."""
    _, _, gen = _pair(NARROW, seed=45)
    with torch.no_grad():
        for p in gen.parameters():
            p.mul_(100.0)
        wav = gen(torch.full((1, 8, 8), 50.0))
    assert torch.isfinite(wav).all()


def test_vocos_infer_clips_and_trims_as_jax():
    """``vocos_infer`` clips to [-1, 1] before the scale (a head biased to
    loud magnitudes clips), and cuts item i to mel_lens[i]·hop samples."""
    jax_gen, variables, gen = _pair(NARROW, seed=46)
    bias = np.asarray(variables["params"]["head"]["bias"]).copy()
    bias[:NARROW["n_fft"] // 2 + 1] += 3.0
    variables["params"]["head"]["bias"] = bias
    gen.load_state_dict(jax_to_torch_vocos(flatten(variables),
                                           VocosConfig(**NARROW)))
    mel = np.random.RandomState(47).randn(2, 10, 8).astype(np.float32)
    expect = jax_vocos_infer(jax_gen, variables, jnp.asarray(mel),
                             mel_lens=[10, 6], max_wav_value=1.0)
    got = vocos_infer(gen, mel, mel_lens=[10, 6], max_wav_value=1.0)
    assert [w.shape for w in got] == [(80,), (48,)]
    assert np.abs(got[0]).max() == 1.0          # clipped
    for g, e in zip(got, expect):
        np.testing.assert_allclose(g, e, atol=NARROW_ATOL)
    scaled = vocos_infer(gen, mel)
    np.testing.assert_allclose(scaled[1][:48], got[1] * 32768.0,
                               rtol=1e-6)


@pytest.fixture(scope="module")
def jax_gan():
    return jax_gan_run(JaxGenerator(JaxConfig(**TINY_GENERATORS["vocos"])))


def test_gan_step_matches_jax(jax_gan):
    config = VocosConfig(**TINY_GENERATORS["vocos"])
    check_gan_steps(jax_gan, lambda: VocosGenerator(config),
                    lambda flat: jax_to_torch_vocos(flat, config))


def test_streaming_matches_full_forward():
    """Chunks of 16 frames (halo: the backbone's 5 frames, the overlap-add
    margin of n_fft/hop 4 and the edge frame), the online mode fed in
    pieces of 7 frames, and a mel shorter than one window."""
    _, _, gen = _pair(NARROW, seed=48)
    mel = np.random.RandomState(49).randn(120, 8).astype(np.float32)
    full = _run(gen, mel[None])[0]
    sv = StreamingVocoder(gen, chunk_frames=16)
    assert sv.halo == 3 + 2 * 3 + 4 + 1
    chunks = list(sv.synthesize_chunks(mel))
    assert len(chunks) == 8
    np.testing.assert_allclose(np.concatenate(chunks), full,
                               atol=STREAM_ATOL)
    online = np.concatenate(list(sv.stream(
        mel[i:i + 7] for i in range(0, 120, 7))))
    np.testing.assert_allclose(online, full, atol=STREAM_ATOL)
    short = mel[:20]
    np.testing.assert_allclose(sv.synthesize(short),
                               _run(gen, short[None])[0], atol=STREAM_ATOL)
