"""Parity of the port's HiFi-GAN discriminators and GAN losses with the JAX
package on the CPU, on a narrow configuration (periods 2 and 3 with
channels 4 and 8, two scales of three convs) and on the paper's full
widths at a short segment, from seeded JAX trees converted by
``weights.jax_to_torch_discriminator``.

Both sides are f32 convolutions: scores and every feature map agree to
1e-5 (the port's maps are channels-first and are transposed to JAX's
layout before comparing).  The spectral-norm state (``u``, ``sigma``)
equals JAX's after an ``update_stats=True`` call and is unchanged after an
``update_stats=False`` call.  The losses agree to rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_nar_fast_tts_tpu.vocoder import losses as jax_losses
from smart_nar_fast_tts_tpu.vocoder.discriminators import (
    HiFiGANDiscriminator as JaxDiscriminator)
from smart_nar_fast_tts_tpu_torch.audio import MelSpectrogramConfig
from smart_nar_fast_tts_tpu_torch.vocoder import HiFiGANDiscriminator
from smart_nar_fast_tts_tpu_torch.vocoder import losses as port_losses
from smart_nar_fast_tts_tpu_torch.vocoder.discriminators import SNConv
from smart_nar_fast_tts_tpu_torch.weights import jax_to_torch_discriminator
from torch_port_util import flatten, random_variables, zeros

ATOL = 1e-5
LOSS_RTOL = 1e-5
TINY_SCALE_LAYERS = ((8, 15, 1, 1), (16, 41, 4, 4), (16, 5, 1, 1))
TINY = dict(periods=(2, 3), period_channels=(4, 8), n_scales=2,
            scale_layers=TINY_SCALE_LAYERS)


def _pair(kw, seed, length):
    """A seeded JAX variable tree and the port discriminator holding it."""
    jax_disc = JaxDiscriminator(**kw)
    shapes = jax.eval_shape(lambda: jax_disc.init(
        jax.random.PRNGKey(0), jnp.zeros((1, length)), update_stats=True))
    variables = random_variables(shapes, seed)
    port = HiFiGANDiscriminator(**kw)
    port.load_state_dict(jax_to_torch_discriminator(flatten(variables),
                                                    port))
    return jax_disc, variables, port


@pytest.fixture(scope="module")
def tiny():
    return _pair(TINY, seed=21, length=256)


def _wav(B, T, seed):
    return (0.3 * np.random.default_rng(seed).standard_normal((B, T))
            ).astype(np.float32)


def _to_jax_layout(x):
    """(B, C, H, W) → (B, H, W, C); (B, C, T) → (B, T, C)."""
    return np.moveaxis(x.detach().numpy(), 1, -1)


def _assert_outputs_close(got, expect):
    assert len(got) == len(expect)
    for (score, feats), (e_score, e_feats) in zip(got, expect):
        np.testing.assert_allclose(score.detach().numpy(),
                                   np.asarray(e_score), atol=ATOL)
        assert len(feats) == len(e_feats)
        for f, e in zip(feats, e_feats):
            np.testing.assert_allclose(_to_jax_layout(f), np.asarray(e),
                                       atol=ATOL)


def _jax_apply(jax_disc, variables, wav, update_stats):
    # jitted: one compile instead of one per distinct eager op
    fn = jax.jit(lambda v, w: jax_disc.apply(
        v, w, update_stats=update_stats, mutable=["batch_stats"]))
    return fn(variables, jnp.asarray(wav))


@pytest.mark.parametrize("T", [256, 301])
def test_scores_and_feature_maps(tiny, T):
    # T 301 is a multiple of neither period: reflect padding before the fold
    jax_disc, variables, port = tiny
    wav = _wav(3, T, seed=T)
    (e_mpd, e_msd), _ = _jax_apply(jax_disc, variables, wav, False)
    with torch.no_grad():
        mpd, msd = port(torch.from_numpy(wav))
    _assert_outputs_close(mpd, e_mpd)
    _assert_outputs_close(msd, e_msd)


def test_full_width_discriminator():
    """The paper's widths (periods 2/3/5/7/11 with channels 32…1024, three
    scales of the full stack) on a 1024-sample segment."""
    jax_disc, variables, port = _pair({}, seed=22, length=1024)
    wav = _wav(1, 1024, seed=23)
    (e_mpd, e_msd), _ = _jax_apply(jax_disc, variables, wav, False)
    with torch.no_grad():
        mpd, msd = port(torch.from_numpy(wav))
    _assert_outputs_close(mpd, e_mpd)
    _assert_outputs_close(msd, e_msd)


def _sn_state(port):
    return {n: b.clone() for n, b in port.named_buffers()}


def test_spectral_norm_state(tiny):
    jax_disc, variables, _ = tiny
    _, _, port = _pair(TINY, seed=21, length=256)     # a fresh copy
    wav = _wav(2, 256, seed=24)
    before = _sn_state(port)
    with torch.no_grad():
        port(torch.from_numpy(wav), update_stats=False)
    after_false = _sn_state(port)
    assert before.keys() and all(torch.equal(before[n], after_false[n])
                                 for n in before)
    (e_mpd, e_msd), new = _jax_apply(jax_disc, variables, wav, True)
    with torch.no_grad():
        mpd, msd = port(torch.from_numpy(wav), update_stats=True)
    _assert_outputs_close(msd, e_msd)
    expect = jax_to_torch_discriminator(
        flatten({"params": variables["params"], **new}), port)
    moved = 0
    for name, buf in port.named_buffers():
        np.testing.assert_allclose(buf.numpy(), expect[name].numpy(),
                                   atol=ATOL, rtol=ATOL)
        moved += not torch.equal(buf, before[name])
    assert moved == len(before)


def test_seeded_init_follows_flax():
    """The port's own initialiser: the same tree as the JAX module, zero
    biases, weight-norm scales of 1, kernels of std √(1/fan_in), u drawn
    N(0, 1), σ 1; the same seed gives the same weights."""
    jax_disc = JaxDiscriminator(**TINY)
    variables = zeros(jax.eval_shape(lambda: jax_disc.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 256)), update_stats=True)))
    port = HiFiGANDiscriminator(**TINY, seed=3)
    state = port.state_dict()
    shapes = {k: tuple(v.shape) for k, v in jax_to_torch_discriminator(
        flatten(variables), port).items()}
    assert shapes == {k: tuple(v.shape) for k, v in state.items()}
    for name, t in state.items():
        if name.endswith(".bias"):
            assert not t.any()
        elif name.endswith(".scale") or name.endswith(".sigma"):
            assert torch.equal(t, torch.ones_like(t))
    w = port.mpd[0].conv_4.weight
    w = w.detach()
    assert abs(float(w.std()) * np.sqrt(w[0].numel()) - 1.0) < 0.05
    assert float(w.abs().max()) <= 2.0 / 0.8796256610342398 / np.sqrt(
        w[0].numel()) + 1e-6
    sn = [m for m in port.modules() if isinstance(m, SNConv)]
    assert len(sn) == len(TINY_SCALE_LAYERS) + 1
    assert all(float(m.u.abs().sum()) > 0 for m in sn)
    same = HiFiGANDiscriminator(**TINY, seed=3).state_dict()
    assert all(torch.equal(state[k], same[k]) for k in state)


def _jax_tree(out):
    return [(jnp.asarray(s.detach().numpy()),
             [jnp.asarray(_to_jax_layout(f)) for f in feats])
            for s, feats in out]


def test_losses(tiny):
    jax_disc, variables, port = tiny
    real, fake = _wav(2, 256, seed=25), _wav(2, 256, seed=26)
    with torch.no_grad():
        r_mpd, r_msd = port(torch.from_numpy(real))
        f_mpd, f_msd = port(torch.from_numpy(fake))
    real_out, fake_out = r_mpd + r_msd, f_mpd + f_msd
    cases = [
        (port_losses.discriminator_loss(real_out, fake_out),
         jax_losses.discriminator_loss(_jax_tree(real_out),
                                       _jax_tree(fake_out))),
        (port_losses.generator_adversarial_loss(fake_out),
         jax_losses.generator_adversarial_loss(_jax_tree(fake_out))),
        (port_losses.feature_matching_loss(real_out, fake_out),
         jax_losses.feature_matching_loss(_jax_tree(real_out),
                                          _jax_tree(fake_out))),
    ]
    kw = dict(n_fft=32, hop_length=8, win_length=32, n_mels=8,
              mel_fmax=None)
    from smart_nar_fast_tts_tpu.audio.stft import (
        MelSpectrogramConfig as JaxMelConfig)
    cases.append((
        port_losses.mel_l1_loss(torch.from_numpy(fake),
                                torch.from_numpy(real),
                                MelSpectrogramConfig(**kw)),
        jax_losses.mel_l1_loss(jnp.asarray(fake), jnp.asarray(real),
                               JaxMelConfig(**kw))))
    for got, expect in cases:
        assert float(got) > 0
        np.testing.assert_allclose(float(got), float(expect),
                                   rtol=LOSS_RTOL)
