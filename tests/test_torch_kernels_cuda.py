"""The port's CUDA kernels against their plain versions, on a card.

These tests import no JAX, so they run on a machine with a card and no JAX,
from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_cuda.py

Without a card they skip (the kernels have no CPU mode).  Tolerances: the
flash kernel rounds its operands to bf16, so it agrees with the f32 plain
version to 2e-2, and with the plain version that rounds at the same points
(``attention_bf16_reference``, a two-pass softmax) to
``attention_bf16_tolerance``: 1e-3 + 2^-8·Σp|v|/l (a probability's bf16
rounding tipped by one ulp), + 2^-7·|ref| for a bf16 output, and on average
to 1e-5 where every item's valid keys sit in one 128-key tile, so that the
online softmax is the two-pass one (a moved rounding point costs ≥ 1.6e-4
there); the upsampling kernel is
f32 throughout and agrees with the dense plain version to 1e-5 (f32
rounding of sums of at most L terms; the phonemes it leaves out weigh below
exp(-36)); the alignment kernel is f32
throughout: ``out`` 1e-5, ``idx`` exact, ``gnum`` rtol 1e-5 / atol 1e-4 (the
JAX package's kernel test), and ``gnum`` bit-equal from run to run.  The
backward passes recompute the plain versions, so a gradient through a
kernel's ``autograd.Function`` equals autograd through its plain version to
f32 rounding: 1e-4.  The log-mel kernel is f32 FMA against cuFFT in the
plain version: mel atol 2e-4 / rtol 1e-4, energy atol 2e-3 / rtol 1e-4 (the
JAX package's kernel test), on noise, the port's synthesised speech and
silence, which gives exactly log(1e-5) and 0; on tones with a pause under a
faint noise floor, where the f32 plain version is itself off, against the
plain version run in float64.
"""

import numpy as np
import pytest
import torch

from smart_nar_fast_tts_tpu_torch.audio import (MelSpectrogramConfig,
                                                mel_spectrogram)
from smart_nar_fast_tts_tpu_torch.kernels import (
    alignment_attention, alignment_reference, attention_bf16_reference,
    attention_bf16_tolerance, attention_reference, flash_attention,
    fused_log_mel, gaussian_upsample_banded)
from smart_nar_fast_tts_tpu_torch.ops import gaussian_upsample

BF16_TOL = 2e-2
ONE_TILE_MEAN = 1e-5
F32_ATOL = 1e-5
GNUM_ATOL, GNUM_RTOL = 1e-4, 1e-5
GRAD_TOL = 1e-4
MEL_ATOL, ENERGY_ATOL, MEL_RTOL = 2e-4, 2e-3, 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _key_valid(rng, B, Lk, kind):
    """Item 0 fully masked; ``prefix`` lengths spread over [0, Lk];
    ``holes`` each key valid with probability 0.3; ``last tile`` valid keys
    only in the kernel's last 128-key tile."""
    if kind == "prefix":
        lens = np.linspace(0, Lk, B).astype(int)
        valid = np.arange(Lk)[None, :] < lens[:, None]
    elif kind == "holes":
        valid = rng.random((B, Lk)) < 0.3
    else:
        valid = np.zeros((B, Lk), bool)
        valid[:, (Lk - 1) // 128 * 128:] = True
    valid[0] = False
    return torch.from_numpy(valid)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, kind", [
    ((8, 2, 128, 128, 128), "prefix"),
    ((2, 2, 1000, 1000, 128), "prefix"),
    ((2, 3, 70, 45, 64), "prefix"),
    ((3, 2, 1000, 1000, 128), "holes"),
    ((3, 2, 300, 1000, 128), "last tile"),
    ((2, 2, 333, 700, 128), "holes"),
    ((3, 2, 200, 300, 64), "holes")])
def test_flash_attention(card, shape, kind, dtype):
    B, H, Lq, Lk, D = shape
    rng = np.random.default_rng(8)
    q, k, v = (_randn(rng, B, H, L, D).to(card, dtype)
               for L in (Lq, Lk, Lk))
    valid = _key_valid(rng, B, Lk, kind).to(card)
    got = flash_attention(q, k, v, valid)
    expect = attention_reference(q, k, v, valid)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), expect.float(), atol=BF16_TOL,
                               rtol=BF16_TOL)
    expect = attention_bf16_reference(q, k, v, valid)
    tol = attention_bf16_tolerance(q, k, v, valid, expect)
    gap = (got.float() - expect.float()).abs()
    assert (gap <= tol).all()
    if Lk <= 128 or kind == "last tile":   # every item in one key tile
        assert gap.mean() <= ONE_TILE_MEAN
    assert (got[0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("max_len", [50, 1000])
def test_gaussian_upsample(card, max_len):
    rng = np.random.default_rng(9)
    x = _randn(rng, 4, 128, 256).to(card)
    d = torch.from_numpy(rng.integers(0, 15, (4, 128))).float().to(card)
    lens = torch.tensor([128, 100, 64, 1], device=card)
    valid = (torch.arange(128, device=card)[None] < lens[:, None]).float()
    out, mel_len = gaussian_upsample_banded(x, d, max_len, valid)
    e_out, e_len, _ = gaussian_upsample(x, d, max_len, valid)
    torch.testing.assert_close(out, e_out, atol=F32_ATOL, rtol=0)
    torch.testing.assert_close(mel_len, e_len)


def _alignment_inputs(card, B, H, T, L, D, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (_randn(rng, B, H, n, D).to(card) for n in (T, L, L))
    src = torch.from_numpy(rng.integers(max(L // 2, 1), L + 1, B)).to(card)
    src[-1] = max(L - 3, 1)                           # an item with src < L
    mel = torch.from_numpy(rng.integers(T // 2, T + 1, B)).to(card)
    valid = torch.arange(L, device=card)[None, :] < src[:, None]
    return q, k, v, valid, src, mel


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(48, 2, 896, 128, 128),
                                   (3, 2, 45, 13, 128),
                                   (2, 3, 100, 70, 32)])
def test_alignment_attention(card, shape):
    args = _alignment_inputs(card, *shape, seed=10)
    out, idx, gnum = alignment_attention(*args)
    _, idx2, gnum2 = alignment_attention(*args)
    e_out, e_idx, e_gnum = alignment_reference(*args)
    torch.testing.assert_close(out, e_out, atol=F32_ATOL, rtol=0)
    assert torch.equal(idx, e_idx)
    torch.testing.assert_close(gnum, e_gnum, atol=GNUM_ATOL, rtol=GNUM_RTOL)
    assert torch.equal(idx2, idx)
    assert torch.equal(gnum2, gnum)                   # bit-equal


def _grads_of(fn, leaves, cotangents):
    leaves = [t.detach().clone().requires_grad_() for t in leaves]
    outs = fn(*leaves)
    assert all(o.grad_fn is not None for o in outs)
    total = sum((o.float() * c).sum() for o, c in zip(outs, cotangents))
    return torch.autograd.grad(total, leaves)


@pytest.mark.cuda
def test_backward_passes_match_the_plain_versions(card):
    rng = np.random.default_rng(11)
    # flash attention: decoder-like (2, 2, 300, 128)
    q, k, v = (_randn(rng, 2, 2, 300, 128).to(card) for _ in range(3))
    valid = torch.arange(300, device=card)[None, :] < torch.tensor(
        [[300], [211]], device=card)
    ct = [_randn(rng, 2, 2, 300, 128).to(card)]
    got = _grads_of(lambda *a: (flash_attention(*a, valid),), (q, k, v), ct)
    want = _grads_of(lambda *a: (attention_reference(*a, valid),),
                     (q, k, v), ct)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=GRAD_TOL, rtol=GRAD_TOL)
    # upsampling: x (4, 128, 256) → 900 frames
    x = _randn(rng, 4, 128, 256).to(card)
    d = torch.from_numpy(rng.integers(0, 12, (4, 128))).float().to(card)
    pv = (torch.arange(128, device=card)[None] < torch.tensor(
        [[128], [100], [64], [9]], device=card)).float()
    ct = [_randn(rng, 4, 900, 256).to(card)]
    got = _grads_of(lambda x: (gaussian_upsample_banded(x, d, 900, pv)[0],),
                    (x,), ct)
    want = _grads_of(lambda x: (gaussian_upsample(x, d, 900, pv)[0],),
                     (x,), ct)
    torch.testing.assert_close(got[0], want[0], atol=GRAD_TOL, rtol=GRAD_TOL)
    # alignment attention: out and gnum
    q, k, v, valid, src, mel = _alignment_inputs(card, 4, 2, 200, 40, 128,
                                                 seed=12)
    ct = [_randn(rng, 4, 2, 200, 128).to(card), _randn(rng, 4).to(card)]

    def pick(fn):
        return lambda *a: (lambda r: (r[0], r[2]))(fn(*a, valid, src, mel))
    got = _grads_of(pick(alignment_attention), (q, k, v), ct)
    want = _grads_of(pick(alignment_reference), (q, k, v), ct)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=GRAD_TOL, rtol=GRAD_TOL)


@pytest.fixture(scope="module")
def speech_segments():
    """16 segments of 8192 samples of the port's own synthesis (committed
    weights, four seeded texts), drawn as the GAN step draws them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import json

    from smart_nar_fast_tts_tpu_torch.serving import RESULTS_DIR, Synthesizer
    from smart_nar_fast_tts_tpu_torch.training import sample_segments
    meta = json.loads((RESULTS_DIR / "flagship_meta.json").read_text())
    texts = np.random.default_rng(0).choice(np.asarray(meta["phone_ids"]),
                                            size=(4, 96))
    synth = Synthesizer.from_committed()
    wav, mel_lens = synth.synthesize(texts, np.full(4, 96))
    clips = [w[:int(n) * synth.hop_length].cpu().numpy()
             for w, n in zip(wav, mel_lens)]
    return torch.from_numpy(sample_segments(clips, 16, 8192,
                                            np.random.default_rng(0)))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["noise", "speech", "zeros"])
@pytest.mark.parametrize("shape, kw", [
    ((16, 8192), {}),
    ((3, 300), dict(n_fft=32, hop_length=8, win_length=32, n_mels=8,
                    mel_fmax=None))])
def test_fused_log_mel(card, speech_segments, shape, kw, kind):
    cfg = MelSpectrogramConfig(**kw)
    rng = np.random.default_rng(13)
    if kind == "noise":
        y = torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))
    elif kind == "speech":
        y = speech_segments[:shape[0], :shape[1]].contiguous()
    else:
        y = torch.zeros(shape)
    y = y.to(card)
    mel, energy = fused_log_mel(y, cfg)
    torch.cuda.synchronize()
    ref_mel, ref_energy = mel_spectrogram(y, cfg)
    assert mel.shape == ref_mel.shape and energy.shape == ref_energy.shape
    torch.testing.assert_close(mel, ref_mel, atol=MEL_ATOL, rtol=MEL_RTOL)
    torch.testing.assert_close(energy, ref_energy, atol=ENERGY_ATOL,
                               rtol=MEL_RTOL)
    if kind == "zeros":
        assert torch.equal(mel, torch.log(torch.full_like(
            mel, cfg.compression_clip)))
        assert not energy.any()


@pytest.mark.cuda
def test_fused_log_mel_quiet_bins(card):
    """Harmonic tones with a pause under a noise floor 100 dB down: bins
    ~110 dB below a frame's loudest, where log compression magnifies the
    f32 sums' rounding.  Against the plain version run in float64, the
    kernel stays within the tolerance and no further off than the f32
    plain version (cuFFT)."""
    cfg = MelSpectrogramConfig()
    rng = np.random.default_rng(14)
    t = np.arange(8192) / 22050.0
    y = np.zeros((8, 8192))
    for b in range(8):
        y[b] = sum(np.sin(2 * np.pi * (90.0 + 15.0 * b) * h * t
                          + rng.uniform(0, 6)) / h ** 2 for h in range(1, 30))
        y[b] *= 0.4 * np.exp(-4.0 * t / t[-1])
        y[b, 8192 // 3: 8192 // 2] = 0.0
    y = torch.from_numpy((y + 1e-5 * rng.standard_normal(y.shape)).astype(
        np.float32)).to(card)
    mel, energy = fused_log_mel(y, cfg)
    exact_mel, exact_energy = (t.float() for t in mel_spectrogram(
        y.double(), cfg))
    torch.testing.assert_close(mel, exact_mel, atol=MEL_ATOL, rtol=MEL_RTOL)
    torch.testing.assert_close(energy, exact_energy, atol=ENERGY_ATOL,
                               rtol=MEL_RTOL)
    plain_err = (mel_spectrogram(y, cfg)[0] - exact_mel).abs().max()
    assert (mel - exact_mel).abs().max() <= plain_err
