"""The port's CUDA kernels against their plain versions, on a card.

These tests import no JAX, so they run on a machine with a card and no JAX,
from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_cuda.py

Without a card they skip (the kernels have no CPU mode).  Tolerances: the
flash kernel rounds its operands to bf16, so it agrees with the f32 plain
version to 2e-2; the upsampling kernel is f32 throughout and agrees with the
dense plain version to 1e-5 (f32 rounding of sums of at most L terms; the
phonemes it leaves out weigh below exp(-36)).
"""

import numpy as np
import pytest
import torch

from smart_nar_fast_tts_tpu_torch.kernels import (
    attention_reference, flash_attention, gaussian_upsample_banded)
from smart_nar_fast_tts_tpu_torch.ops import gaussian_upsample

BF16_TOL = 2e-2
F32_ATOL = 1e-5


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
