"""Parity of the port's vocoder GAN training with the JAX package on the
CPU: one and two steps of ``make_vocoder_train_step`` on a narrow HiFi-GAN
(hop 8, 16 channels), a narrow discriminator and a tiny mel configuration
(n_fft 32, 8 mels), from the same JAX-initialised trees and the same seeded
waveform segments.  JAX runs its ``fused_log_mel`` Pallas kernel in
interpret mode (``SMART_TTS_PALLAS=interpret``); the port's wrapper takes
its plain version on the CPU.

Two steps let the learning-rate schedule, the Adam moments and the
spectral-norm statistics carried from step 1 take part.  The metrics agree
to rtol 1e-4; the updated generator, discriminator and spectral-norm state
to atol 1e-5.  Both sides are f32."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from smart_nar_fast_tts_tpu.audio.stft import (
    MelSpectrogramConfig as JaxMelConfig)
from smart_nar_fast_tts_tpu.training import vocoder as jax_training
from smart_nar_fast_tts_tpu.vocoder import HiFiGANConfig as JaxGenConfig
from smart_nar_fast_tts_tpu.vocoder import HiFiGANGenerator as JaxGenerator
from smart_nar_fast_tts_tpu.vocoder.discriminators import (
    HiFiGANDiscriminator as JaxDiscriminator)
from smart_nar_fast_tts_tpu_torch import kernels
from smart_nar_fast_tts_tpu_torch.audio import MelSpectrogramConfig
from smart_nar_fast_tts_tpu_torch.training import (
    VocoderMetrics, VocoderOptimizer, create_vocoder_state,
    make_vocoder_train_step, sample_segments)
from smart_nar_fast_tts_tpu_torch.vocoder import (HiFiGANConfig,
                                                  HiFiGANDiscriminator,
                                                  HiFiGANGenerator)
from smart_nar_fast_tts_tpu_torch.weights import (jax_to_torch_discriminator,
                                                  jax_to_torch_hifigan)
from torch_port_util import flatten

METRIC_RTOL = 1e-4
PARAM_ATOL = 1e-5
GEN_KW = dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
              upsample_initial_channel=16, resblock_kernel_sizes=(3,),
              resblock_dilation_sizes=((1, 2),), n_mels=8)
MEL_KW = dict(n_fft=32, hop_length=8, win_length=32, n_mels=8,
              mel_fmax=None)
DISC_KW = dict(periods=(2, 3), period_channels=(4, 8), n_scales=2,
               scale_layers=((8, 15, 1, 1), (16, 41, 4, 4), (16, 5, 1, 1)))
B, SEG, STEPS = 2, 256, 2


def _segments():
    """Seeded segments: a decaying tone plus noise, one batch per step."""
    rng = np.random.default_rng(40)
    t = np.arange(SEG) / 22050.0
    tone = np.sin(2 * np.pi * 440.0 * t) * np.exp(-4.0 * t / t[-1])
    return [(0.3 * tone + 0.05 * rng.standard_normal((B, SEG))
             ).astype(np.float32) for _ in range(STEPS)]


def _port_trees(gen_params, disc_params, disc_stats, gen, disc):
    return (jax_to_torch_hifigan(flatten({"params": gen_params}),
                                 gen.config),
            jax_to_torch_discriminator(flatten(
                {"params": disc_params, "batch_stats": disc_stats}), disc))


@pytest.fixture(scope="module")
def jax_run():
    """The JAX state before the first step and the trees and metrics after
    each step (numpy copies: the jitted step donates its input state)."""
    gen = JaxGenerator(JaxGenConfig(**GEN_KW, tail_impl="plain"))
    disc = JaxDiscriminator(**DISC_KW)
    tx = jax_training.make_vocoder_optimizer(2e-4)
    state = jax_training.create_vocoder_state(gen, disc, tx, tx,
                                              segment_size=SEG, seed=0)
    snap = lambda s: jax.tree_util.tree_map(  # noqa: E731
        np.asarray, (s.gen_params, s.disc_params, s.disc_stats))
    initial, after, metrics = snap(state), [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SMART_TTS_PALLAS", "interpret")
        step = jax_training.make_vocoder_train_step(gen, disc,
                                                    JaxMelConfig(**MEL_KW),
                                                    tx, tx)
        for wavs in _segments():
            state, m = step(state, jnp.asarray(wavs))
            after.append(snap(state))
            metrics.append({k: float(getattr(m, k))
                            for k in VocoderMetrics._fields})
    return initial, after, metrics


def _port_state(initial):
    gen = HiFiGANGenerator(HiFiGANConfig(**GEN_KW))
    disc = HiFiGANDiscriminator(**DISC_KW)
    g, d = _port_trees(*initial, gen, disc)
    gen.load_state_dict(g)
    disc.load_state_dict(d)
    tx = VocoderOptimizer(2e-4)
    return create_vocoder_state(gen, disc, tx, tx, device="cpu")


@pytest.mark.parametrize("n_steps", [1, 2])
def test_gan_steps_match_jax(jax_run, n_steps):
    initial, after, metrics = jax_run
    state = _port_state(initial)
    step = make_vocoder_train_step(MelSpectrogramConfig(**MEL_KW))
    kernels.reset_launches()
    for i, wavs in enumerate(_segments()[:n_steps]):
        got = step(state, torch.from_numpy(wavs))
        for k in VocoderMetrics._fields:
            np.testing.assert_allclose(float(getattr(got, k)),
                                       metrics[i][k], rtol=METRIC_RTOL,
                                       err_msg=f"step {i + 1} {k}")
    assert state.step == n_steps
    assert kernels.launches()["fused_log_mel"] == 0      # CPU: plain version
    want_g, want_d = _port_trees(*after[n_steps - 1], state.generator,
                                 state.discriminator)
    for module, want in ((state.generator, want_g),
                         (state.discriminator, want_d)):
        got = module.state_dict()
        assert got.keys() == want.keys()
        for name in want:
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                       atol=PARAM_ATOL, err_msg=name)


def test_step_moves_both_trees_and_takes_mels(jax_run):
    """Every generator and discriminator tensor and every spectral-norm
    ``u`` of more than one element moves in step 1; passing ``mels`` equal
    to the step's own input mel gives the same update as leaving it out."""
    initial, _, _ = jax_run
    wavs = torch.from_numpy(_segments()[0])
    cfg = MelSpectrogramConfig(**MEL_KW)
    step = make_vocoder_train_step(cfg)
    a, b = _port_state(initial), _port_state(initial)
    before = {**{f"g.{k}": v.clone() for k, v in
                 a.generator.state_dict().items()},
              **{f"d.{k}": v.clone() for k, v in
                 a.discriminator.state_dict().items()}}
    ma = step(a, wavs)
    mel_in = kernels.fused_log_mel(wavs, cfg)[0].transpose(1, 2)
    mb = step(b, wavs, mels=mel_in)
    after = {**{f"g.{k}": v for k, v in a.generator.state_dict().items()},
             **{f"d.{k}": v for k, v in a.discriminator.state_dict().items()}}
    # a spectral-norm u of one output (conv_post) is ±1 at every step
    still = [k for k in before if torch.equal(before[k], after[k])]
    assert still == ["d.msd.scales.0.conv_post.u"]
    assert before[still[0]].abs().item() == 1.0
    assert all(torch.equal(x, y) for x, y in zip(ma, mb))
    for x, y in ((a.generator, b.generator),
                 (a.discriminator, b.discriminator)):
        assert all(torch.equal(p, q) for p, q in zip(x.state_dict().values(),
                                                     y.state_dict().values()))


def test_learning_rate_schedule():
    """optax's continuous ``exponential_decay``, at the count of updates
    before each: the first update uses the initial rate.  optax computes
    the power in f32 (rtol 1e-5); the port in float64."""
    tx = VocoderOptimizer(2e-4, lr_decay=0.9, decay_every=10)
    sched = optax.exponential_decay(2e-4, transition_steps=10,
                                    decay_rate=0.9)
    for count in (0, 1, 7, 10, 25, 1000):
        np.testing.assert_allclose(tx.lr(count), float(sched(count)),
                                   rtol=1e-5)


def test_optimizer_matches_jax():
    """Four updates through ``VocoderState.apply`` against the JAX
    package's ``make_vocoder_optimizer`` on one seeded tensor of large
    entries.  A rate of 0.1 halving every 2 updates makes each term show
    above f32 rounding: zero gradients leave the weight decay alone
    (``lr·1e-4·p``), gradients near 1e-8 weigh eps against √v̂, and the
    rest the schedule and the moments."""
    rng = np.random.default_rng(8)
    p0 = (10.0 * rng.standard_normal(64)).astype(np.float32)
    grads = []
    for _ in range(4):
        g = rng.standard_normal(64).astype(np.float32)
        g[:16] = 0.0
        g[16:32] *= 1e-8
        grads.append(g)
    j_tx = jax_training.make_vocoder_optimizer(0.1, lr_decay=0.5,
                                               decay_every=2)
    module = torch.nn.Module()
    module.p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    tx = VocoderOptimizer(0.1, lr_decay=0.5, decay_every=2)
    state = create_vocoder_state(module, torch.nn.Linear(1, 1), tx, tx,
                                 device="cpu")
    j_p = jnp.asarray(p0)
    j_opt = j_tx.init(j_p)
    for i, g in enumerate(grads):
        updates, j_opt = j_tx.update(jnp.asarray(g), j_opt, j_p)
        j_p = optax.apply_updates(j_p, updates)
        module.p.grad = torch.from_numpy(g)
        state.apply(state.gen_opt, state.gen_tx)
        state.step += 1
        np.testing.assert_allclose(module.p.detach().numpy(),
                                   np.asarray(j_p), rtol=1e-6, atol=1e-7,
                                   err_msg=f"update {i + 1}")


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_segments_match_jax(seed):
    rng = np.random.default_rng(99)
    wavs = [rng.standard_normal(n).astype(np.float32)
            for n in (5000, 300, 8192, 8193, 12000)]
    got = sample_segments(wavs, 16, 8192, np.random.default_rng(seed))
    expect = jax_training.sample_segments(wavs, 16, 8192,
                                          np.random.default_rng(seed))
    np.testing.assert_array_equal(got, expect)
