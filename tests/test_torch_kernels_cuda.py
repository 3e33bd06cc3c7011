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
exp(-104), which f32 exp rounds to 0); the alignment kernel runs both products in 3xTF32 (tf32 hi
and lo parts of each operand, rounded to nearest, lo·lo dropped: about f32
accuracy), and is held to the f32 plain version at the f32 tolerances:
``out`` 1e-5, ``idx`` exact, ``gnum`` rtol 1e-5 / atol 1e-4 (the JAX
package's kernel test), ``idx`` and ``gnum`` bit-equal from run to run; and
to ``alignment_tf32x3_reference``, which rounds its operands where the kernel
does, with ``out`` within 8e-6 at most and 1e-6 on average and ``gnum`` as
above.  That bound is only a little tighter than 1e-5 because what separates
the kernel from either plain version is not operand rounding but the order
of its f32 sums (mma.sync accumulating 3·D/8 k-steps into a score): score
errors of a few 1e-5, carried into ``out`` through ``p·v`` (``chip_smoke.py``
on an H100 at (48, 2, 896, 128, 128): 5.2e-6 at most, 1.9e-7 on average,
against 6.2e-6 and 1.9e-7 from the f32 plain version).  Single-pass TF32
would miss both by ~100×.  ``idx`` is held to the f32 plain version only:
the 3xTF32 plain version, which sums its three products apart, settles
near-ties its own way (at seed 10 of the training shape it takes key 16
where the f32 plain version, the kernel and float64 take key 45: a top-two
gap of 5.9e-6).  Head dims 129-256 run on the same tensor-core kernels
(flash: 64-key tiles, D zero-padded to 192 or 256; alignment: 32- or
16-key chunks, the small 3xTF32 passes summed apart) and are held to the
same tolerances; past 256 the wide tensor-core kernels (flash: D padded to
a multiple of 64, output slices of at most 256 columns, 64-key tiles;
alignment: output slices of at most 192 columns, scores summed over
chunks of D), held to the same tolerances too (``.wide_launches`` counts
them).  Where the alignment kernel's argmax differs from the f32 plain
version's past head dim 128, both picks must lie within their versions'
score error bounds of the float64 maximum (``_assert_argmax``): 3xTF32
resolves a score to ~2^-21 of each product, f32 to 2^-24, and a near-tie
of 7.9e-7 at a score of 2.649 (D 256, v = identity) went the other way on
an H100; up to 256 the argmax is held exact in ``test_alignment_attention``.
The backward passes recompute the plain versions, so a gradient through a
kernel's ``autograd.Function`` equals autograd through its plain version to
f32 rounding: 1e-4.  The log-mel kernel is f32 FMA against cuFFT in the
plain version: mel atol 2e-4 / rtol 1e-4, energy atol 2e-3 / rtol 1e-4 (the
JAX package's kernel test), on noise, the port's synthesised speech and
silence, which gives exactly log(1e-5) and 0; on tones with a pause under a
faint noise floor, where the f32 plain version is itself off, against the
plain version run in float64.  Its FFT is f64 up to an f32 epilogue, so it
is also held within 5e-6 of the float64 plain version in log-mel and 1e-6
relative in energy (f32 rounding of the mel value and ``logf``'s last ulp,
~1e-6), and within 2e-6 of ``log_mel_fft_reference``, which runs its
schedule in float64 torch; its outputs are bit-equal from launch to launch.
So are the mixed-radix FFT kernel (an n_fft that is not a power of two from
32 to 4096; ``.mixed_launches``) and the DFT kernel (an odd n_fft past
7,263; ``.dft_launches``, twin ``log_mel_dft_reference``).
"""

import numpy as np
import pytest
import torch

from smart_nar_fast_tts_tpu_torch.audio import (MelSpectrogramConfig,
                                                mel_spectrogram)
from smart_nar_fast_tts_tpu_torch.kernels import (
    alignment_attention, alignment_reference, alignment_tf32x3_reference,
    attention_bf16_reference,
    attention_bf16_tolerance, attention_reference, flash_attention,
    fused_log_mel, gaussian_upsample_banded, log_mel_dft_reference,
    log_mel_fft_reference)
from smart_nar_fast_tts_tpu_torch.kernels import resblock as kresblock
from smart_nar_fast_tts_tpu_torch.kernels import stft as kstft
from smart_nar_fast_tts_tpu_torch.ops import gaussian_upsample

BF16_TOL = 2e-2
ONE_TILE_MEAN = 1e-5
F32_ATOL = 1e-5
GNUM_ATOL, GNUM_RTOL = 1e-4, 1e-5
TF32X3_ATOL, TF32X3_MEAN = 8e-6, 1e-6
GRAD_TOL = 1e-4
ARGMAX_EXACT_MAX_D = 128
TF32X3_PRODUCT_EPS, F32_U = 3 * 2.0 ** -22, 2.0 ** -24
MEL_ATOL, ENERGY_ATOL, MEL_RTOL = 2e-4, 2e-3, 1e-4
FFT_MEL_ATOL, FFT_REF_ATOL, FFT_ENERGY_RTOL = 5e-6, 2e-6, 1e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _key_valid(rng, B, Lk, kind, tile=128):
    """Item 0 fully masked; ``prefix`` lengths spread over [0, Lk];
    ``holes`` each key valid with probability 0.3; ``last tile`` valid keys
    only in the kernel's last key tile (``tile`` keys: 128 up to head dim
    128, 64 past it)."""
    if kind == "prefix":
        lens = np.linspace(0, Lk, B).astype(int)
        valid = np.arange(Lk)[None, :] < lens[:, None]
    elif kind == "holes":
        valid = rng.random((B, Lk)) < 0.3
    else:
        valid = np.zeros((B, Lk), bool)
        valid[:, (Lk - 1) // tile * tile:] = True
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
    ((3, 2, 200, 300, 64), "holes"),
    ((3, 2, 300, 300, 32), "prefix"),
    ((3, 2, 300, 300, 80), "holes"),
    ((3, 2, 300, 300, 96), "prefix"),
    ((3, 2, 333, 300, 192), "prefix"),
    ((3, 2, 300, 333, 256), "holes"),
    ((3, 2, 300, 333, 160), "prefix"),
    ((3, 2, 1000, 1000, 160), "holes"),
    ((3, 2, 1000, 1000, 192), "holes"),
    ((2, 2, 200, 1000, 192), "last tile"),
    ((8, 2, 128, 128, 192), "prefix"),
    ((3, 2, 333, 300, 256), "prefix"),
    ((2, 2, 333, 700, 256), "last tile"),
    ((3, 2, 200, 300, 320), "prefix"),
    ((3, 2, 300, 333, 288), "prefix"),
    ((3, 2, 300, 333, 288), "holes"),
    ((3, 2, 300, 333, 288), "last tile"),
    ((3, 2, 300, 333, 320), "holes"),
    ((2, 2, 333, 700, 320), "last tile"),
    ((8, 2, 128, 128, 320), "prefix"),
    ((3, 2, 300, 333, 384), "prefix"),
    ((3, 2, 300, 333, 384), "holes"),
    ((3, 2, 300, 333, 384), "last tile"),
    ((3, 2, 333, 300, 512), "prefix"),
    ((3, 2, 300, 333, 512), "holes"),
    ((3, 2, 300, 333, 512), "last tile"),
    ((3, 2, 300, 333, 1024), "prefix"),
    ((3, 2, 300, 333, 1024), "holes"),
    ((3, 2, 300, 333, 1024), "last tile")])
def test_flash_attention(card, shape, kind, dtype):
    """Head dims 64, 128, 192 and 256 run the tensor-core kernel (128-key
    tiles up to 128, 64-key tiles past it), 32, 80, 96 and 160 the same
    kernel on D zero-padded to the next of them; 288 (padded to 320), 320,
    384, 512 and 1024 the wide kernel (``flash_attention.wide_launches``;
    q staying in shared memory up to D 704, streamed with the K chunks at
    1024); all are held alike, and two launches are bit-equal."""
    B, H, Lq, Lk, D = shape
    rng = np.random.default_rng(8)
    q, k, v = (_randn(rng, B, H, L, D).to(card, dtype)
               for L in (Lq, Lk, Lk))
    tile = 128 if D <= 128 else 64
    valid = _key_valid(rng, B, Lk, kind, tile).to(card)
    wide = flash_attention.wide_launches
    launches = flash_attention.launches
    got = flash_attention(q, k, v, valid)
    assert flash_attention.wide_launches - wide == (D > 256)
    assert flash_attention.launches - launches == 1
    assert torch.equal(flash_attention(q, k, v, valid), got)
    expect = attention_reference(q, k, v, valid)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), expect.float(), atol=BF16_TOL,
                               rtol=BF16_TOL)
    expect = attention_bf16_reference(q, k, v, valid)
    tol = attention_bf16_tolerance(q, k, v, valid, expect)
    gap = (got.float() - expect.float()).abs()
    assert (gap <= tol).all()
    if Lk <= tile or kind == "last tile":  # every item in one key tile
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


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["D 70", "L 300", "all zero", "T 4096",
                                  "d 132", "d_last 120-190"])
def test_gaussian_upsample_cases(card, case):
    """A channel tail (D not a multiple of 4: scalar staging and stores);
    300 phonemes of 0 or 1 frames, ~180 of them in one tile's band (the
    32-phoneme chunks run many rounds); all durations 0 (zeros, mel_len 0);
    T 4096 with Σd about 1200 (most tiles past Σd); phonemes longer than
    12σ, whose frames far from every center a band of 6σ lost: one of 132
    frames at T 140, and [7, 9, 4, 11, 6, d_last] for d_last 120-190."""
    if case in ("d 132", "d_last 120-190"):
        rows = [[132]] if case == "d 132" else [
            [7, 9, 4, 11, 6, n] for n in range(120, 191)]
        d = torch.tensor(rows, dtype=torch.float32, device=card)
        T = 140 if case == "d 132" else 37 + 190 + 8
        x = _randn(np.random.default_rng(16), *d.shape, 256).to(card)
        valid = torch.ones_like(d)
        out, mel_len = gaussian_upsample_banded(x, d, T, valid)
        e_out, e_len, _ = gaussian_upsample(x, d, T, valid)
        torch.testing.assert_close(out, e_out, atol=F32_ATOL, rtol=0)
        assert torch.equal(mel_len, e_len)
        return
    B, L, D, T, durations = {
        "D 70": (4, 128, 70, 1000, (0, 15)),
        "L 300": (2, 300, 256, 400, (0, 2)),
        "all zero": (3, 128, 256, 500, (0, 1)),
        "T 4096": (8, 128, 256, 4096, (8, 12))}[case]
    rng = np.random.default_rng(10)
    x = _randn(rng, B, L, D).to(card)
    d = torch.from_numpy(rng.integers(*durations, (B, L))).float().to(card)
    lens = torch.from_numpy(rng.integers(L - 32, L + 1, B)).to(card)
    valid = (torch.arange(L, device=card)[None] < lens[:, None]).float()
    out, mel_len = gaussian_upsample_banded(x, d, T, valid)
    e_out, e_len, _ = gaussian_upsample(x, d, T, valid)
    torch.testing.assert_close(out, e_out, atol=F32_ATOL, rtol=0)
    assert torch.equal(mel_len, e_len)
    total = (d * valid).sum(1)
    past = torch.arange(T, device=card)[None] >= total[:, None]
    assert not out[past].any()
    if case == "all zero":
        assert not mel_len.any()
    elif case == "T 4096":
        assert 1000 < total.mean() < 1400


def _alignment_inputs(card, B, H, T, L, D, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (_randn(rng, B, H, n, D).to(card) for n in (T, L, L))
    src = torch.from_numpy(rng.integers(max(L // 2, 1), L + 1, B)).to(card)
    src[-1] = max(L - 3, 1)                           # an item with src < L
    mel = torch.from_numpy(rng.integers(T // 2, T + 1, B)).to(card)
    valid = torch.arange(L, device=card)[None, :] < src[:, None]
    return q, k, v, valid, src, mel


def _assert_argmax(args, idx, e_idx):
    """``idx`` equals the f32 plain version's ``e_idx`` up to head dim
    ARGMAX_EXACT_MAX_D.  Past it (3xTF32 at DP 192/256) a differing index
    passes where each pick's float64 score lies within its version's error
    bound of the float64 maximum: a score scale·Σ q_i k_i is off by at most
    eps·scale·Σ|q_i k_i|, eps = D·F32_U for the f32 sum and
    TF32X3_PRODUCT_EPS more for the kernel's products (as chip_smoke.py's
    ``argmax_ties``)."""
    q, k, _, valid = args[:4]
    D = q.shape[-1]
    differ = (idx != e_idx).nonzero().tolist()
    assert D > ARGMAX_EXACT_MAX_D or not differ, differ[:4]
    eps = {"kernel": TF32X3_PRODUCT_EPS + D * F32_U, "plain": D * F32_U}
    for b, t in differ:
        qt, kb = q[b, 0, t].double(), k[b, 0].double()
        s64 = torch.where(valid[b], kb @ qt, -1e30) / D ** 0.5
        mag = (kb.abs() @ qt.abs()) / D ** 0.5
        top = int(torch.nonzero(s64 == s64.max())[0, 0])
        for who, pick in (("kernel", idx[b, t]), ("plain", e_idx[b, t])):
            limit = eps[who] * (mag[pick] + mag[top])
            assert s64[top] - s64[pick] <= limit, (b, t, who, int(pick))


def _check_tf32x3(args, out, gnum):
    """The kernel's outputs against the plain version that rounds its
    operands where it does (``idx`` is held to the f32 one)."""
    e_out, _, e_gnum = alignment_tf32x3_reference(*args)
    gap = (out - e_out).abs()
    assert gap.max() <= TF32X3_ATOL and gap.mean() <= TF32X3_MEAN
    torch.testing.assert_close(gnum, e_gnum, atol=GNUM_ATOL, rtol=GNUM_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(48, 2, 896, 128, 128),
                                   (3, 2, 45, 13, 128),
                                   (2, 3, 100, 70, 32),
                                   (2, 2, 1500, 1000, 128),
                                   (3, 2, 200, 70, 30),
                                   (3, 2, 200, 70, 96),
                                   (3, 2, 200, 70, 192),
                                   (3, 2, 200, 70, 150),
                                   (3, 2, 200, 70, 256),
                                   (2, 2, 300, 128, 192),
                                   (2, 2, 1500, 1000, 192),
                                   (3, 2, 45, 13, 256),
                                   (3, 2, 200, 70, 320),
                                   (3, 2, 45, 13, 300),
                                   (2, 2, 1500, 1000, 300),
                                   (3, 2, 45, 13, 320),
                                   (2, 2, 1500, 1000, 320),
                                   (48, 2, 896, 128, 320),
                                   (3, 2, 45, 13, 384),
                                   (2, 2, 1500, 1000, 384),
                                   (3, 2, 45, 13, 512),
                                   (2, 2, 1500, 1000, 512),
                                   (3, 2, 200, 70, 640),
                                   (2, 2, 300, 1000, 1024)])
def test_alignment_attention(card, shape):
    """Head dims up to 256 run the tensor-core kernel (30 and 150
    zero-padded to a multiple of 4, then to the kernel's 32, 64, 128, 192
    or 256), 300-1024 the wide one (``alignment_attention.wide_launches``;
    in teams up to 512): held to the f32 plain version alike (idx exact up
    to 256, past it as ``_assert_argmax``) and to the 3xTF32 one; two
    launches are bit-equal."""
    args = _alignment_inputs(card, *shape, seed=10)
    wide = alignment_attention.wide_launches
    launches = alignment_attention.launches
    out, idx, gnum = alignment_attention(*args)
    D = shape[-1]
    assert alignment_attention.wide_launches - wide == (D > 256)
    assert alignment_attention.launches - launches == 1
    out2, idx2, gnum2 = alignment_attention(*args)
    e_out, e_idx, e_gnum = alignment_reference(*args)
    torch.testing.assert_close(out, e_out, atol=F32_ATOL, rtol=0)
    if D > 256:
        _assert_argmax(args, idx, e_idx)
    else:
        assert torch.equal(idx, e_idx)
    torch.testing.assert_close(gnum, e_gnum, atol=GNUM_ATOL, rtol=GNUM_RTOL)
    assert torch.equal(idx2, idx)
    assert torch.equal(gnum2, gnum)                   # bit-equal
    assert torch.equal(out2, out)
    _check_tf32x3(args, out, gnum)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [128, 150, 192, 256, 320])
@pytest.mark.parametrize("case", ["q zero", "v identity"])
def test_alignment_attention_products_apart(card, case, D):
    """q = 0: uniform probabilities, so ``out`` is the PV product alone (the
    mean of the valid v rows); v = identity (L = D keys): ``out`` is P
    itself, the QKᵀ product through the softmax alone.  At each padded
    depth of the tensor-core kernel (150 padded to 152, then 192; chunks of
    64 keys up to 128, 32 at 192, 16 at 256) and on the wide kernel at 320;
    idx as ``_assert_argmax``."""
    q, k, v, valid, src, mel = _alignment_inputs(
        card, 4, 2, 300, D, D, seed=15 if D == 128 else 17)
    if case == "q zero":
        q = torch.zeros_like(q)
    else:
        v = torch.eye(D, device=card).expand(4, 2, D, D).contiguous()
    args = (q, k, v, valid, src, mel)
    wide = alignment_attention.wide_launches
    out, idx, gnum = alignment_attention(*args)
    assert alignment_attention.wide_launches - wide == (D > 256)
    e_out, e_idx, e_gnum = alignment_reference(*args)
    torch.testing.assert_close(out, e_out, atol=F32_ATOL, rtol=0)
    _assert_argmax(args, idx, e_idx)
    torch.testing.assert_close(gnum, e_gnum, atol=GNUM_ATOL, rtol=GNUM_RTOL)
    _check_tf32x3(args, out, gnum)


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


def _tones_with_pause(rng, B, S):
    t = np.arange(S) / 22050.0
    y = np.zeros((B, S))
    for b in range(B):
        y[b] = sum(np.sin(2 * np.pi * (90.0 + 15.0 * b) * h * t
                          + rng.uniform(0, 6)) / h ** 2 for h in range(1, 30))
        y[b] *= 0.4 * np.exp(-4.0 * t / t[-1])
        y[b, S // 3: S // 2] = 0.0
    return torch.from_numpy((y + 1e-5 * rng.standard_normal(y.shape)).astype(
        np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["quiet bins", "noise", "ragged",
                                  "n_fft 4096", "tiny"])
def test_fused_log_mel_fft(card, case):
    """The f64 FFT kernel against the float64 plain version and against
    ``log_mel_fft_reference`` (its schedule in float64 torch), on the tones
    with a pause, noise at the GAN shape, (3, 5000) (20 frames an item,
    S not a multiple of the hop, reflect padding at both ends), n_fft 4096 and n_fft 32;
    two launches bit-equal."""
    kw = {"n_fft 4096": dict(n_fft=4096, win_length=4096, hop_length=1024),
          "tiny": dict(n_fft=32, hop_length=8, win_length=32, n_mels=8,
                       mel_fmax=None)}.get(case, {})
    cfg = MelSpectrogramConfig(**kw)
    rng = np.random.default_rng(15)
    if case == "quiet bins":
        y = _tones_with_pause(rng, 8, 8192)
    else:
        shape = {"ragged": (3, 5000), "n_fft 4096": (4, 20000),
                 "tiny": (3, 300)}.get(case, (16, 8192))
        y = torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))
    y = y.to(card)
    launched = fused_log_mel.launches
    mel, energy = fused_log_mel(y, cfg)
    assert fused_log_mel.launches == launched + 1
    mel2, energy2 = fused_log_mel(y, cfg)
    exact_mel, exact_energy = mel_spectrogram(y.double(), cfg)
    torch.testing.assert_close(mel.double(), exact_mel, atol=FFT_MEL_ATOL,
                               rtol=0)
    torch.testing.assert_close(energy.double(), exact_energy, atol=0,
                               rtol=FFT_ENERGY_RTOL)
    ref_mel, ref_energy = log_mel_fft_reference(y, cfg)
    torch.testing.assert_close(mel, ref_mel, atol=FFT_REF_ATOL, rtol=0)
    torch.testing.assert_close(energy, ref_energy, atol=0,
                               rtol=FFT_ENERGY_RTOL)
    assert torch.equal(mel, mel2) and torch.equal(energy, energy2)


def _log_mel_route_check(card, n_fft, counter, twin, S=16384):
    """One route of ``fused_log_mel`` on the tones with a pause, (3, S), hop
    n_fft/4: its counter, the float64 plain version (5e-6; energy 1e-6
    relative), its twin (2e-6) and two launches bit-equal."""
    cfg = MelSpectrogramConfig(n_fft=n_fft, win_length=n_fft,
                               hop_length=max(n_fft // 4, 1))
    y = _tones_with_pause(np.random.default_rng(n_fft), 3, S).to(card)
    before = getattr(fused_log_mel, counter)
    mel, energy = fused_log_mel(y, cfg)
    assert getattr(fused_log_mel, counter) == before + 1
    mel2, energy2 = fused_log_mel(y, cfg)
    exact_mel, exact_energy = mel_spectrogram(y.double(), cfg)
    torch.testing.assert_close(mel.double(), exact_mel, atol=FFT_MEL_ATOL,
                               rtol=0)
    torch.testing.assert_close(energy.double(), exact_energy, atol=0,
                               rtol=FFT_ENERGY_RTOL)
    ref_mel, ref_energy = twin(y, cfg)
    torch.testing.assert_close(mel, ref_mel, atol=FFT_REF_ATOL, rtol=0)
    torch.testing.assert_close(energy, ref_energy, atol=0,
                               rtol=FFT_ENERGY_RTOL)
    assert torch.equal(mel, mel2) and torch.equal(energy, energy2)


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft", [16, 400, 882, 1001, 1200, 1201, 8192])
def test_fused_log_mel_rejects_n_fft(card, n_fft):
    """An n_fft that the first FFT kernel does not take (a power of two
    from 32 to 4096) goes to the mixed-radix FFT kernel: a power of two
    outside that range, 7-smooth sizes, generic radices (1001 = 7·11·13)
    and a prime (1201), each held as :func:`_log_mel_route_check` holds
    it, against its twin ``log_mel_fft_reference``."""
    _log_mel_route_check(card, n_fft, "mixed_launches",
                         log_mel_fft_reference)


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft", [7263, 14526])
def test_fused_log_mel_mixed_largest(card, n_fft):
    """The mixed-radix kernel's largest odd and even n_fft (plan [3, 3, 3,
    269] both): its buffers fill a block's shared memory."""
    _log_mel_route_check(card, n_fft, "mixed_launches",
                         log_mel_fft_reference, S=4 * n_fft)


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft", [7265, 14527])
def test_fused_log_mel_dft(card, n_fft):
    """The odd n_fft past the mixed-radix kernel's buffers keep the DFT
    kernel, held against its twin ``log_mel_dft_reference``."""
    _log_mel_route_check(card, n_fft, "dft_launches", log_mel_dft_reference,
                         S=2 * n_fft)


@pytest.mark.cuda
def test_log_mel_smem_rule(card):
    """The host's route rule reads the kernels' shared memory as the
    source computes it, at every n_fft of the domain."""
    from smart_nar_fast_tts_tpu_torch.kernels import _build
    lib = _build.load("log_mel", kstft._SIGNATURES)
    assert lib.log_mel_max_smem_bytes() == kstft.MAX_SMEM
    for n in range(2, kstft.max_odd_n_fft("dft") + 2):
        assert lib.log_mel_mixed_smem_bytes(n) == kstft.mixed_smem_bytes(n)
        assert lib.log_mel_dft_smem_bytes(n) == kstft.dft_smem_bytes(n)


# HiFi-GAN's resblock conv kernel (3xTF32 wgmma): its largest error against
# float64, over the largest |output|, at most RESBLOCK_ERR_RATIO times
# cuDNN float32's own (TF32 off), or RESBLOCK_FLOOR where both are tiny
RESBLOCK_ERR_RATIO, RESBLOCK_FLOOR = 2.0, 1e-6
V1_CONVS = [(256, 11, 5), (256, 3, 1), (128, 7, 3), (64, 11, 1), (32, 3, 5)]
V3_CONVS = [(128, 3, 1), (64, 5, 6), (32, 7, 12), (16, 7, 3)]


def _resblock_inputs(card, B, C, T, k, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, C, T, generator=g) * 2
    w = torch.randn(C, C, k, generator=g) / (C * k) ** 0.5
    b = torch.randn(C, generator=g) * 0.1
    r, a = (torch.randn(B, C, T, generator=g) for _ in range(2))
    return [t.to(card) for t in (x, w, b, r, a)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["first conv", "residual", "sum"])
@pytest.mark.parametrize("B, T", [(1, 997), (16, 640), (3, 5)])
@pytest.mark.parametrize("C, k, d", V1_CONVS + V3_CONVS)
def test_hifigan_resblock_conv(card, C, k, d, B, T, mode):
    torch.backends.cudnn.allow_tf32 = False
    x, w, b, r, a = _resblock_inputs(card, B, C, T, k, seed=C + k + d + T)
    kw = {"first conv": {}, "residual": {"res": r},
          "sum": {"res": r, "acc": a, "div": 3.0}}[mode]
    with torch.inference_mode():
        got = kresblock.hifigan_resblock_conv(x, w, b, d, 0.1, **kw)
        f32 = kresblock.resblock_conv_reference(x, w, b, d, 0.1, **kw)
        f64 = kresblock.resblock_conv_reference(
            x.double(), w.double(), b.double(), d, 0.1,
            **{n: v.double() if torch.is_tensor(v) else v
               for n, v in kw.items()})
        twin = kresblock.resblock_conv_tf32x3_reference(x, w, b, d, 0.1,
                                                        **kw)
    scale = float(f64.abs().max())
    err = float((got.double() - f64).abs().max()) / scale
    cudnn = float((f32.double() - f64).abs().max()) / scale
    assert err <= max(RESBLOCK_ERR_RATIO * cudnn, RESBLOCK_FLOOR), (err,
                                                                   cudnn)
    # the 3xTF32 twin rounds at the kernel's points: as close as either is
    # to float64
    twin_err = float((twin.double() - f64).abs().max()) / scale
    assert float((got - twin).abs().max()) / scale <= 2 * max(
        err, twin_err, RESBLOCK_FLOOR / 2)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["V1", "V3"])
def test_hifigan_generator_on_the_kernel(card, kind):
    """One launch a resblock conv a forward; the whole generator within
    twice the module chain's distance from float64."""
    import copy

    from smart_nar_fast_tts_tpu_torch import kernels
    from smart_nar_fast_tts_tpu_torch.vocoder import (HiFiGANConfig,
                                                      HiFiGANGenerator)
    torch.backends.cudnn.allow_tf32 = False
    cfg = HiFiGANConfig() if kind == "V1" else HiFiGANConfig(
        resblock="2", upsample_rates=(8, 8, 4),
        upsample_kernel_sizes=(16, 16, 8), upsample_initial_channel=256,
        resblock_kernel_sizes=(3, 5, 7),
        resblock_dilation_sizes=((1, 2), (2, 6), (3, 12)))
    torch.manual_seed(3)
    gen = HiFiGANGenerator(cfg).to(card).eval()
    mel = torch.randn(2, 40, 80, device=card) - 5.0
    kernels.reset_launches()
    with torch.inference_mode():
        got = gen(mel)
    per_conv = 2 if kind == "V1" else 1
    want = len(cfg.upsample_rates) * sum(
        per_conv * len(ds) for ds in cfg.resblock_dilation_sizes)
    assert kernels.launches()["hifigan_resblock_conv"] == want
    with torch.no_grad(), torch.enable_grad():
        for p in gen.parameters():
            p.requires_grad_(False)
        chain = gen(mel)
    with torch.inference_mode():
        f64 = copy.deepcopy(gen).double()(mel.double())
    assert kernels.launches()["hifigan_resblock_conv"] == want
    err = float((got.double() - f64).abs().max())
    chain_err = float((chain.double() - f64).abs().max())
    assert err <= max(2 * chain_err, 1e-6), (err, chain_err)


@pytest.mark.cuda
def test_streaming_vocoder_on_the_kernel(card):
    from smart_nar_fast_tts_tpu_torch import kernels
    from smart_nar_fast_tts_tpu_torch.vocoder import (HiFiGANGenerator,
                                                      StreamingVocoder)
    torch.manual_seed(4)
    gen = HiFiGANGenerator().to(card).eval()
    mel = (torch.randn(150, 80) - 5.0).numpy()
    sv = StreamingVocoder(gen, chunk_frames=64)
    kernels.reset_launches()
    chunks = np.concatenate(list(sv.synthesize_chunks(mel)))
    assert kernels.launches()["hifigan_resblock_conv"] > 0
    with torch.inference_mode():
        full = gen(torch.from_numpy(mel[None]).to(card))[0].cpu().numpy()
    assert chunks.shape == full.shape
    np.testing.assert_allclose(chunks, full, atol=1e-4)


@pytest.mark.cuda
def test_export_keeps_the_resblock_kernel(card):
    from smart_nar_fast_tts_tpu_torch import kernels
    from smart_nar_fast_tts_tpu_torch.vocoder import (HiFiGANConfig,
                                                      HiFiGANGenerator)
    cfg = HiFiGANConfig(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
                        upsample_initial_channel=64)
    gen = HiFiGANGenerator(cfg).to(card).eval()
    mel = torch.randn(1, 12, 80, device=card)
    with torch.no_grad():
        ep = torch.export.export(gen, (mel,), strict=False)
        want = gen(mel)
    ops = [n for n in ep.graph.nodes if n.op == "call_function"
           and "hifigan_resblock_conv" in str(n.target)]
    assert len(ops) == 2 * 2 * 9
    kernels.reset_launches()
    with torch.no_grad():
        got = ep.module()(mel)
    assert kernels.launches()["hifigan_resblock_conv"] == len(ops)
    torch.testing.assert_close(got, want, atol=0, rtol=0)

