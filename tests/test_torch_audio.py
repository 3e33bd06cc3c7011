"""Parity of the port's audio front end with the JAX package on the CPU:
the numpy mel filterbank and window (bit-equal), framing (exact), the STFT
magnitude and log-mel (f32 FFTs on both sides, 1e-5), and the
``fused_log_mel`` wrapper, whose CPU path is its plain version, against the
JAX Pallas kernel in interpret mode at that kernel's own tolerances
(``tests/test_pallas_kernels.py``: mel atol 2e-4, energy atol 2e-3, rtol
1e-4), on noise, a speech-like signal with a pause, and silence."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_nar_fast_tts_tpu.audio import mel as jax_mel
from smart_nar_fast_tts_tpu.audio import stft as jax_stft
from smart_nar_fast_tts_tpu.ops.pallas.stft import _dft_mel_constants
from smart_nar_fast_tts_tpu.ops.pallas.stft import (
    fused_log_mel as jax_fused_log_mel)
from smart_nar_fast_tts_tpu_torch.audio import mel as port_mel
from smart_nar_fast_tts_tpu_torch.audio import stft as port_stft
from smart_nar_fast_tts_tpu_torch.kernels import fused_log_mel
from smart_nar_fast_tts_tpu_torch.kernels.stft import (dft_mel_constants,
                                                       num_frames)

MEL_ATOL, ENERGY_ATOL, KERNEL_RTOL = 2e-4, 2e-3, 1e-4
F32_ATOL = 1e-5

CONFIGS = {
    "flagship": {},
    "tiny": dict(n_fft=32, hop_length=8, win_length=32, n_mels=8,
                 mel_fmax=None),
    "kernel_test": dict(n_fft=256, hop_length=64, win_length=256, n_mels=20),
    "short_window": dict(n_fft=512, hop_length=128, win_length=384,
                         n_mels=40, mel_fmin=50.0, sampling_rate=16000),
}


def _configs(name):
    kw = CONFIGS[name]
    return (jax_stft.MelSpectrogramConfig(**kw),
            port_stft.MelSpectrogramConfig(**kw))


def _signal(kind, B, S, seed=0):
    """Seeded (B, S) waveforms: uniform noise, a speech-like signal (a
    decaying harmonic tone, a pause of silence with a faint noise floor,
    then a louder tone), or zeros."""
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.uniform(-1, 1, (B, S)).astype(np.float32)
    if kind == "zeros":
        return np.zeros((B, S), np.float32)
    t = np.arange(S) / 22050.0
    out = np.zeros((B, S))
    for b in range(B):
        f0 = 110.0 + 40.0 * b
        voiced = sum(np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6))
                     / h ** 2 for h in range(1, 12))
        env = np.exp(-3.0 * t / t[-1])
        env[S // 3: S // 2] = 0.0
        out[b] = 0.3 * voiced * env + 1e-5 * rng.standard_normal(S)
    return out.astype(np.float32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_mel_and_window_bit_equal(name):
    cfg, _ = _configs(name)
    np.testing.assert_array_equal(
        port_mel.mel_filterbank(cfg.sampling_rate, cfg.n_fft, cfg.n_mels,
                                cfg.mel_fmin, cfg.mel_fmax),
        jax_mel.mel_filterbank(cfg.sampling_rate, cfg.n_fft, cfg.n_mels,
                               cfg.mel_fmin, cfg.mel_fmax))
    np.testing.assert_array_equal(port_mel.hann_window(cfg.win_length),
                                  jax_mel.hann_window(cfg.win_length))
    np.testing.assert_array_equal(
        port_mel.hann_window(cfg.win_length, periodic=False),
        jax_mel.hann_window(cfg.win_length, periodic=False))
    np.testing.assert_array_equal(
        port_mel.pad_center(port_mel.hann_window(cfg.win_length), cfg.n_fft),
        jax_mel.pad_center(jax_mel.hann_window(cfg.win_length), cfg.n_fft))
    hz = np.array([0.0, 440.0, 999.0, 1000.0, 4321.5, cfg.sampling_rate / 2])
    np.testing.assert_array_equal(port_mel.hz_to_mel(hz),
                                  jax_mel.hz_to_mel(hz))
    np.testing.assert_array_equal(port_mel.mel_to_hz(hz / 100),
                                  jax_mel.mel_to_hz(hz / 100))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kernel_constants_bit_equal(name):
    cfg, tcfg = _configs(name)
    for got, expect in zip(dft_mel_constants(tcfg),
                           _dft_mel_constants(cfg)):
        np.testing.assert_array_equal(got, expect)


@pytest.mark.parametrize("S", [1000, 1024, 4097])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_stft_front_end(name, S):
    cfg, tcfg = _configs(name)
    y = _signal("noise", 2, S, seed=S)
    frames = port_stft.frame_signal(torch.from_numpy(y), cfg.n_fft,
                                    cfg.hop_length)
    np.testing.assert_array_equal(frames.numpy(), np.asarray(
        jax_stft.frame_signal(jnp.asarray(y), cfg.n_fft, cfg.hop_length)))
    assert frames.shape[1] == num_frames(S, tcfg) == S // cfg.hop_length + 1
    mag = port_stft.stft_magnitude(torch.from_numpy(y), tcfg)
    np.testing.assert_allclose(mag.numpy(), np.asarray(
        jax_stft.stft_magnitude(jnp.asarray(y), cfg)), atol=F32_ATOL,
        rtol=F32_ATOL)
    mel, energy = port_stft.mel_spectrogram(torch.from_numpy(y), tcfg)
    e_mel, e_energy = jax_stft.mel_spectrogram(jnp.asarray(y), cfg)
    np.testing.assert_allclose(mel.numpy(), np.asarray(e_mel),
                               atol=F32_ATOL)
    np.testing.assert_allclose(energy.numpy(), np.asarray(e_energy),
                               atol=F32_ATOL, rtol=F32_ATOL)


def test_mel_spectrogram_gradient_matches_jax():
    """The generated branch of the mel loss takes its gradient through
    ``mel_spectrogram``: d Σ mel·c / dy against JAX's."""
    import jax
    cfg, tcfg = _configs("tiny")
    y = _signal("speech", 2, 200, seed=5)
    c = np.random.default_rng(6).standard_normal(
        (2, cfg.n_mels, 200 // cfg.hop_length + 1)).astype(np.float32)
    expect = jax.grad(lambda v: jnp.sum(
        jax_stft.mel_spectrogram(v, cfg)[0] * c))(jnp.asarray(y))
    ty = torch.from_numpy(y).requires_grad_()
    (port_stft.mel_spectrogram(ty, tcfg)[0] * torch.from_numpy(c)).sum(
    ).backward()
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(expect),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kind", ["noise", "speech", "zeros"])
@pytest.mark.parametrize("name, S", [("tiny", 256), ("kernel_test", 5000),
                                     ("flagship", 8192)])
def test_fused_log_mel_matches_pallas_kernel(name, S, kind):
    cfg, tcfg = _configs(name)
    y = _signal(kind, 2, S, seed=7)
    mel, energy = fused_log_mel(torch.from_numpy(y), tcfg)
    e_mel, e_energy = jax_fused_log_mel(jnp.asarray(y), cfg, block_f=16,
                                        interpret=True)
    assert mel.shape == e_mel.shape == (2, cfg.n_mels, S // cfg.hop_length
                                        + 1)
    np.testing.assert_allclose(mel.numpy(), np.asarray(e_mel),
                               atol=MEL_ATOL, rtol=KERNEL_RTOL)
    np.testing.assert_allclose(energy.numpy(), np.asarray(e_energy),
                               atol=ENERGY_ATOL, rtol=KERNEL_RTOL)
    if kind == "zeros":
        np.testing.assert_array_equal(
            mel.numpy(), np.log(np.float32(cfg.compression_clip)))
        np.testing.assert_array_equal(energy.numpy(), 0.0)


def test_mel_spectrogram_computes_in_the_input_dtype():
    """A float64 waveform gives float64 features, within 1e-9 of numpy's
    float64 DFT: the exact reference ``fused_log_mel`` is also held to."""
    _, tcfg = _configs("kernel_test")
    y = _signal("speech", 2, 3000, seed=8).astype(np.float64)
    mel, energy = port_stft.mel_spectrogram(torch.from_numpy(y), tcfg)
    assert mel.dtype == energy.dtype == torch.float64
    frames = port_stft.frame_signal(torch.from_numpy(y), tcfg.n_fft,
                                    tcfg.hop_length).numpy()
    mag = np.abs(np.fft.rfft(frames * tcfg.window.astype(np.float64)))
    expect = np.log(np.maximum(
        np.einsum("mf,btf->bmt", tcfg.mel_basis.astype(np.float64), mag),
        tcfg.compression_clip))
    np.testing.assert_allclose(mel.numpy(), expect, atol=1e-9)
    np.testing.assert_allclose(energy.numpy(), np.linalg.norm(mag, axis=-1),
                               rtol=1e-9)
