"""Parity of the port's audio front end with the JAX package on the CPU:
the numpy mel filterbank and window (bit-equal), framing (exact), the STFT
magnitude and log-mel (f32 FFTs on both sides, 1e-5), and the
``fused_log_mel`` wrapper, whose CPU path is its plain version, against the
JAX Pallas kernel in interpret mode at that kernel's own tolerances
(``tests/test_pallas_kernels.py``: mel atol 2e-4, energy atol 2e-3, rtol
1e-4), on noise, a speech-like signal with a pause, and silence.

The CUDA kernels' own schedule, ``log_mel_fft_reference`` (an f64 FFT by
the Stockham stages of ``fft_plan``: radix 4 and 2 for a power of two, any
radix for every other n_fft; the split step for an even n_fft; sparse f64
mel sums, an f32 log), is held here to the JAX kernel at the same
tolerances and to the float64 plain version within 5e-6 in log-mel and 1e-6
relative in energy: the error of an f32 epilogue (~1e-6) with room for
``logf``'s last ulp on the card.  So is ``log_mel_dft_reference``, the DFT
kernel's twin (odd n_fft past the mixed-radix kernel's buffers).  Their
host tables, plans and routes are held to their definitions."""

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
from smart_nar_fast_tts_tpu_torch.kernels import (fused_log_mel,
                                                  log_mel_fft_reference)
from smart_nar_fast_tts_tpu_torch.kernels.stft import (
    MAX_SMEM, _stockham_fft, dft_smem_bytes, fft_plan, log_mel_dft_reference,
    log_mel_route, log_mel_tables, max_odd_n_fft, mixed_smem_bytes,
    num_frames)

MEL_ATOL, ENERGY_ATOL, KERNEL_RTOL = 2e-4, 2e-3, 1e-4
F32_ATOL = 1e-5
FFT_MEL_ATOL, FFT_ENERGY_RTOL = 5e-6, 1e-6

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
    """The CUDA kernel's tables carry the JAX kernel's constants: its
    packed mel weights, scattered back, are the JAX kernel's melᵀ, and its
    window is the JAX kernel's windowed cos basis at bin 0."""
    cfg, tcfg = _configs(name)
    cos_b, sin_b, mel_t = _dft_mel_constants(cfg)
    tables = log_mel_tables(tcfg)
    dense = np.zeros(mel_t.T.shape, np.float32)
    for m, (start, count, offset) in enumerate(tables.mel_ranges):
        dense[m, start:start + count] = \
            tables.mel_weights[offset:offset + count]
    np.testing.assert_array_equal(dense.T, mel_t)
    np.testing.assert_array_equal(tables.window.astype(np.float32),
                                  cos_b[:, 0])
    np.testing.assert_array_equal(sin_b[:, 0], 0.0)


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


def _tones_with_pause(B, S, seed):
    """Harmonic tones of falling loudness with a silent stretch under a
    noise floor 100 dB down (``chip_smoke.py``'s quiet-bin signal): bins
    ~110 dB below a frame's loudest."""
    rng = np.random.default_rng(seed)
    t = np.arange(S) / 22050.0
    out = np.zeros((B, S))
    for b in range(B):
        out[b] = sum(np.sin(2 * np.pi * (90.0 + 15.0 * b) * h * t
                            + rng.uniform(0, 6)) / h ** 2
                     for h in range(1, 30))
        out[b] *= 0.4 * np.exp(-4.0 * t / t[-1])
        out[b, S // 3: S // 2] = 0.0
    return (out + 1e-5 * rng.standard_normal((B, S))).astype(np.float32)


@pytest.mark.parametrize("name", ["flagship", "tiny"])
def test_log_mel_tables(name):
    """The sparse mel table reproduces ``mel_basis`` exactly with every
    nonzero inside its filter's range; the twiddles and the window equal
    their float64 definitions."""
    _, tcfg = _configs(name)
    tables = log_mel_tables(tcfg)
    basis = tcfg.mel_basis
    n = tcfg.n_fft
    assert tables.mel_ranges.shape == (tcfg.n_mels, 3)
    assert tables.mel_weights.dtype == np.float32
    rebuilt = np.zeros_like(basis)
    offset = 0
    for m, (start, count, off) in enumerate(tables.mel_ranges):
        assert off == offset and start + count <= n // 2 + 1
        nz = np.flatnonzero(basis[m])
        assert nz.size == 0 or (nz[0] == start and nz[-1] == start + count - 1)
        rebuilt[m, start:start + count] = \
            tables.mel_weights[off:off + count]
        offset += count
    assert offset == tables.mel_weights.size
    np.testing.assert_array_equal(rebuilt, basis)
    w = np.exp(-2j * np.pi * np.arange(n) / n)
    np.testing.assert_allclose(tables.twiddles[:, 0], w.real, rtol=0,
                               atol=1e-15)
    np.testing.assert_allclose(tables.twiddles[:, 1], w.imag, rtol=0,
                               atol=1e-15)
    assert tables.twiddles.dtype == tables.window.dtype == np.float64
    np.testing.assert_array_equal(tables.window,
                                  np.asarray(tcfg.window, np.float64))


@pytest.mark.parametrize("m", [16, 32, 64, 128, 512, 2048, 3, 5, 7, 12, 15,
                               49, 75, 300, 441, 600, 601, 1001])
def test_stockham_fft_matches_fft(m):
    """The kernels' stages (for a power of two radix-2 first where log2 m
    is odd, then radix-4; for any other m the mixed plan) against
    ``torch.fft.fft`` in float64, with twiddle tables of m points (an odd
    n_fft) and 2m (an even one)."""
    if m & (m - 1) == 0:
        assert fft_plan(m) == [2] * (m.bit_length() % 2 == 0) + [4] * (
            (m.bit_length() - 1) // 2)
    rng = np.random.default_rng(m)
    z = torch.from_numpy(rng.standard_normal((3, m))
                         + 1j * rng.standard_normal((3, m)))
    for big in (m, 2 * m):
        w = torch.from_numpy(np.exp(-2j * np.pi * np.arange(big) / big))
        np.testing.assert_allclose(_stockham_fft(z, w).numpy(),
                                   torch.fft.fft(z).numpy(), rtol=0,
                                   atol=1e-12 * m)


def _is_prime(n):
    return n > 1 and all(n % f for f in range(2, int(n ** 0.5) + 1))


@pytest.mark.parametrize("m, plan", [
    (1, []), (2, [2]), (8, [2, 4]), (4096, [4] * 6), (600, [4, 2, 3, 5, 5]),
    (200, [4, 2, 5, 5]), (441, [3, 3, 7, 7]), (1001, [7, 11, 13]),
    (601, [601]), (7263, [3, 3, 3, 269]), (4802, [2, 7, 7, 7, 7]),
    (1100, [4, 5, 5, 11])])
def test_fft_plan(m, plan):
    """The plan of the sizes the kernels take: a power of two as the
    first FFT kernel's stages, any other m as radix-4 stages, one 2, then
    3, 5, 7 and larger primes in ascending order; a prime m one stage."""
    assert fft_plan(m) == plan


def test_log_mel_route_covers_the_domain():
    """Every n_fft from 2 to the DFT kernel's largest has one route, as
    before the mixed-radix kernel: powers of two from 32 to 4096 the first
    FFT kernel, every even n_fft and every odd one up to 7,263 the
    mixed-radix one, the odd ones past it the DFT kernel; each mixed plan
    multiplies to its FFT's length in at most 20 stages (the kernel's
    ``MAX_STAGES``), its radices in the plan's order."""
    assert (max_odd_n_fft("mixed"), max_odd_n_fft("dft")) == (7263, 14527)
    for n in range(2, 14528):
        route = log_mel_route(n)
        pow2 = 32 <= n <= 4096 and n & (n - 1) == 0
        assert route == ("fft" if pow2 else "dft" if n % 2 and n > 7263
                         else "mixed"), n
        smem = dft_smem_bytes(n) if route == "dft" else mixed_smem_bytes(n)
        assert smem <= MAX_SMEM
        if route == "mixed":
            m = n if n % 2 else n // 2
            plan = fft_plan(m)
            assert int(np.prod(plan)) == m and len(plan) <= 20, n
            if m & (m - 1):
                rank = [{4: 0, 2: 1}.get(r, r) for r in plan]
                assert rank == sorted(rank) and all(
                    _is_prime(r) for r in plan if r != 4), (n, plan)
    for n in (1, 14528, 14529):
        with pytest.raises(ValueError, match="outside 2 to 14527"):
            log_mel_route(n)


@pytest.mark.parametrize("kind", ["noise", "speech", "zeros"])
@pytest.mark.parametrize("name, S", [("tiny", 256), ("kernel_test", 5000),
                                     ("flagship", 8192)])
def test_log_mel_fft_reference_matches_pallas_kernel(name, S, kind):
    cfg, tcfg = _configs(name)
    y = _signal(kind, 2, S, seed=7)
    mel, energy = log_mel_fft_reference(torch.from_numpy(y), tcfg)
    e_mel, e_energy = jax_fused_log_mel(jnp.asarray(y), cfg, block_f=16,
                                        interpret=True)
    assert mel.dtype == energy.dtype == torch.float32
    assert mel.shape == e_mel.shape and energy.shape == e_energy.shape
    np.testing.assert_allclose(mel.numpy(), np.asarray(e_mel),
                               atol=MEL_ATOL, rtol=KERNEL_RTOL)
    np.testing.assert_allclose(energy.numpy(), np.asarray(e_energy),
                               atol=ENERGY_ATOL, rtol=KERNEL_RTOL)
    if kind == "zeros":
        np.testing.assert_array_equal(
            mel.numpy(), np.log(np.float32(cfg.compression_clip)))
        np.testing.assert_array_equal(energy.numpy(), 0.0)


@pytest.mark.parametrize("kind", ["noise", "tones with a pause"])
@pytest.mark.parametrize("name", ["flagship", "tiny"])
def test_log_mel_fft_reference_near_float64(name, kind):
    """Within 5e-6 of the float64 plain version where the f32 plain version
    (an f32 FFT) is 1.8e-3 off on the tones with a pause."""
    _, tcfg = _configs(name)
    y = torch.from_numpy(
        np.random.default_rng(3).uniform(-1, 1, (4, 8192)).astype(np.float32)
        if kind == "noise" else _tones_with_pause(4, 8192, seed=14))
    mel, energy = log_mel_fft_reference(y, tcfg)
    e_mel, e_energy = port_stft.mel_spectrogram(y.double(), tcfg)
    np.testing.assert_allclose(mel.double().numpy(), e_mel.numpy(), rtol=0,
                               atol=FFT_MEL_ATOL)
    np.testing.assert_allclose(energy.double().numpy(), e_energy.numpy(),
                               rtol=FFT_ENERGY_RTOL, atol=0)


@pytest.mark.parametrize("n_fft", [16, 1000, 8192])
def test_log_mel_fft_reference_rejects_n_fft(n_fft):
    """16, 1000 and 8192, once the DFT kernel's, take the mixed-radix FFT
    kernel: its twin takes them, within 5e-6 of the float64 plain version
    (log-mel; energy 1e-6 relative) and 2e-6 of the DFT twin.  It rejects
    only the odd n_fft past the mixed-radix kernel's buffers, which the
    DFT kernel keeps."""
    cfg = port_stft.MelSpectrogramConfig(n_fft=n_fft, win_length=n_fft,
                                         hop_length=max(n_fft // 4, 1))
    assert log_mel_route(n_fft) == "mixed"
    odd = max_odd_n_fft("mixed") + 2
    assert log_mel_route(odd) == "dft"
    with pytest.raises(ValueError, match="odd n_fft past 7263"):
        log_mel_fft_reference(torch.zeros(1, 10000),
                              port_stft.MelSpectrogramConfig(
                                  n_fft=odd, win_length=odd))
    y = torch.from_numpy(_tones_with_pause(2, 10000, seed=n_fft))
    mel, energy = log_mel_fft_reference(y, cfg)
    e_mel, e_energy = port_stft.mel_spectrogram(y.double(), cfg)
    assert mel.dtype == energy.dtype == torch.float32
    np.testing.assert_allclose(mel.double().numpy(), e_mel.numpy(), rtol=0,
                               atol=FFT_MEL_ATOL)
    np.testing.assert_allclose(energy.double().numpy(), e_energy.numpy(),
                               rtol=FFT_ENERGY_RTOL, atol=0)
    d_mel, d_energy = log_mel_dft_reference(y, cfg)
    np.testing.assert_allclose(mel.numpy(), d_mel.numpy(), rtol=0, atol=2e-6)
    np.testing.assert_allclose(energy.numpy(), d_energy.numpy(),
                               rtol=FFT_ENERGY_RTOL, atol=0)


@pytest.mark.parametrize("n_fft", [16, 400, 882, 1001, 1200, 1201, 8192])
def test_log_mel_fft_reference_mixed_near_float64(n_fft):
    """The mixed-radix kernel's twin at a power of two outside 32-4096,
    7-smooth sizes of users' configurations (400, 882, 1200), odd sizes with
    generic radices (1001 = 7·11·13) and a prime (1201): within 5e-6 of the
    float64 plain version (energy 1e-6 relative) on tones with a pause and
    on noise."""
    cfg = port_stft.MelSpectrogramConfig(n_fft=n_fft, win_length=n_fft,
                                         hop_length=max(n_fft // 4, 1))
    assert log_mel_route(n_fft) == "mixed"
    S = 10000 if n_fft > 16 else 2000
    for y in (_tones_with_pause(2, S, seed=n_fft),
              _signal("noise", 2, S, seed=n_fft)):
        y = torch.from_numpy(y)
        mel, energy = log_mel_fft_reference(y, cfg)
        e_mel, e_energy = port_stft.mel_spectrogram(y.double(), cfg)
        np.testing.assert_allclose(mel.double().numpy(), e_mel.numpy(),
                                   rtol=0, atol=FFT_MEL_ATOL)
        np.testing.assert_allclose(energy.double().numpy(), e_energy.numpy(),
                                   rtol=FFT_ENERGY_RTOL, atol=0)


@pytest.mark.parametrize("n_fft", [400, 1000, 1001, 1200])
def test_log_mel_fft_reference_mixed_matches_pallas_kernel(n_fft):
    """The mixed-radix kernel's twin against the JAX Pallas kernel in
    interpret mode, at that kernel's tolerances."""
    kw = dict(n_fft=n_fft, win_length=n_fft, hop_length=n_fft // 4)
    cfg = jax_stft.MelSpectrogramConfig(**kw)
    tcfg = port_stft.MelSpectrogramConfig(**kw)
    y = _signal("speech", 2, 6000, seed=n_fft)
    mel, energy = log_mel_fft_reference(torch.from_numpy(y), tcfg)
    e_mel, e_energy = jax_fused_log_mel(jnp.asarray(y), cfg, block_f=16,
                                        interpret=True)
    assert mel.shape == e_mel.shape and energy.shape == e_energy.shape
    np.testing.assert_allclose(mel.numpy(), np.asarray(e_mel),
                               atol=MEL_ATOL, rtol=KERNEL_RTOL)
    np.testing.assert_allclose(energy.numpy(), np.asarray(e_energy),
                               atol=ENERGY_ATOL, rtol=KERNEL_RTOL)


@pytest.mark.parametrize("n_fft", [800, 1200])
def test_log_mel_dft_reference_near_float64(n_fft):
    """At the ``filter_length`` of a user's preprocess.yaml, once the DFT
    kernel's and now the mixed-radix kernel's: both twins within 5e-6 of
    the float64 plain version on tones with a pause and on noise (the DFT
    twin's schedule is the one the odd n_fft past 7,263 still take)."""
    cfg = port_stft.MelSpectrogramConfig(n_fft=n_fft, win_length=n_fft,
                                         hop_length=n_fft // 4)
    assert log_mel_route(n_fft) == "mixed"
    for y in (_tones_with_pause(2, 8192, seed=n_fft),
              _signal("noise", 2, 8192, seed=n_fft)):
        y = torch.from_numpy(y)
        e_mel, e_energy = port_stft.mel_spectrogram(y.double(), cfg)
        for twin in (log_mel_dft_reference, log_mel_fft_reference):
            mel, energy = twin(y, cfg)
            np.testing.assert_allclose(mel.double().numpy(), e_mel.numpy(),
                                       rtol=0, atol=FFT_MEL_ATOL)
            np.testing.assert_allclose(energy.double().numpy(),
                                       e_energy.numpy(),
                                       rtol=FFT_ENERGY_RTOL, atol=0)


@pytest.mark.parametrize("n_fft", [1000, 1024])
def test_log_mel_dft_reference_matches_fft_and_pallas_kernel(n_fft):
    """The DFT twin's DFT against ``torch.fft`` in float64 (1e-9 of the
    magnitude's peak), and its outputs against the JAX Pallas kernel in
    interpret mode at that kernel's tolerances and against the FFT
    kernels' twin (2e-6): the mixed-radix schedule at n_fft 1000, the
    radix-2/4 one at 1024."""
    kw = dict(n_fft=n_fft, win_length=n_fft, hop_length=256)
    cfg = jax_stft.MelSpectrogramConfig(**kw)
    tcfg = port_stft.MelSpectrogramConfig(**kw)
    y = _signal("speech", 2, 6000, seed=n_fft)
    yt = torch.from_numpy(y)
    tables = log_mel_tables(tcfg)
    frames = port_stft.frame_signal(yt.double(), n_fft, 256) \
        * torch.from_numpy(tables.window)
    j, k = torch.arange(n_fft), torch.arange(n_fft // 2 + 1)
    rows = torch.from_numpy(tables.twiddles)[(j[:, None] * k) % n_fft]
    spec = torch.fft.rfft(frames, dim=-1)
    tol = 1e-9 * spec.abs().max().item()
    np.testing.assert_allclose((frames @ rows[..., 0]).numpy(),
                               spec.real.numpy(), rtol=0, atol=tol)
    np.testing.assert_allclose((frames @ rows[..., 1]).numpy(),
                               spec.imag.numpy(), rtol=0, atol=tol)
    mel, energy = log_mel_dft_reference(yt, tcfg)
    e_mel, e_energy = jax_fused_log_mel(jnp.asarray(y), cfg, block_f=16,
                                        interpret=True)
    np.testing.assert_allclose(mel.numpy(), np.asarray(e_mel),
                               atol=MEL_ATOL, rtol=KERNEL_RTOL)
    np.testing.assert_allclose(energy.numpy(), np.asarray(e_energy),
                               atol=ENERGY_ATOL, rtol=KERNEL_RTOL)
    assert log_mel_route(n_fft) == ("mixed" if n_fft == 1000 else "fft")
    f_mel, f_energy = log_mel_fft_reference(yt, tcfg)
    np.testing.assert_allclose(mel.numpy(), f_mel.numpy(), rtol=0, atol=2e-6)
    np.testing.assert_allclose(energy.numpy(), f_energy.numpy(),
                               rtol=FFT_ENERGY_RTOL, atol=0)
