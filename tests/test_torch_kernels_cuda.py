"""The port's CUDA kernels against their plain versions, on a card.

These tests import no JAX, so they run on a machine with a card and no JAX,
from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_cuda.py

Without a card they skip (the kernels have no CPU mode).  Tolerances: the
flash kernel rounds its operands to bf16, so it agrees with the f32 plain
version to 2e-2; the upsampling kernel is f32 throughout and agrees with the
dense plain version to 1e-5 (f32 rounding of sums of at most L terms; the
phonemes it leaves out weigh below exp(-36)); the alignment kernel is f32
throughout: ``out`` 1e-5, ``idx`` exact, ``gnum`` rtol 1e-5 / atol 1e-4 (the
JAX package's kernel test), and ``gnum`` bit-equal from run to run.  The
backward passes recompute the plain versions, so a gradient through a
kernel's ``autograd.Function`` equals autograd through its plain version to
f32 rounding: 1e-4.
"""

import numpy as np
import pytest
import torch

from smart_nar_fast_tts_tpu_torch.kernels import (
    alignment_attention, alignment_reference, attention_reference,
    flash_attention, gaussian_upsample_banded)
from smart_nar_fast_tts_tpu_torch.ops import gaussian_upsample

BF16_TOL = 2e-2
F32_ATOL = 1e-5
GNUM_ATOL, GNUM_RTOL = 1e-4, 1e-5
GRAD_TOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 2, 128, 128, 128),
                                   (2, 2, 1000, 1000, 128),
                                   (2, 3, 70, 45, 64)])
def test_flash_attention(card, shape, dtype):
    B, H, Lq, Lk, D = shape
    rng = np.random.default_rng(8)
    q, k, v = (_randn(rng, B, H, L, D).to(card, dtype)
               for L in (Lq, Lk, Lk))
    lens = np.linspace(0, Lk, B).astype(int)         # item 0 fully masked
    valid = torch.from_numpy(np.arange(Lk)[None, :] < lens[:, None]).to(card)
    got = flash_attention(q, k, v, valid)
    expect = attention_reference(q, k, v, valid)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), expect.float(), atol=BF16_TOL,
                               rtol=BF16_TOL)
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
