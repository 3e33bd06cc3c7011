"""Parity of the port's ops and of the kernels' plain versions with the JAX
package, on the CPU.

Inputs are made with numpy from a seed and handed to both.  Tolerances:
1e-5 where both sides compute the same f32 math (only summation order
differs); 2e-2 against the Pallas flash kernel, which rounds its operands to
bf16 (the tolerance of ``tests/test_pallas_kernels.py``).  The CUDA kernels
themselves run only on a card; ``tests/test_torch_kernels_cuda.py``, which
imports no JAX, holds them against the plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_nar_fast_tts_tpu.models.layers import masked_softmax as jax_softmax
from smart_nar_fast_tts_tpu.ops import masks as jax_masks
from smart_nar_fast_tts_tpu.ops import upsample as jax_upsample
from smart_nar_fast_tts_tpu.ops.pallas.attention import (
    _attention_reference, flash_attention as jax_flash)
from smart_nar_fast_tts_tpu.ops.pallas.upsample import (
    gaussian_upsample_banded as jax_banded)
from smart_nar_fast_tts_tpu.ops.positional import (
    sinusoid_table as jax_sinusoid)
from smart_nar_fast_tts_tpu_torch import kernels
from smart_nar_fast_tts_tpu_torch.kernels import (
    attention_reference, flash_attention, gaussian_upsample_banded,
    masked_softmax)
from smart_nar_fast_tts_tpu_torch.ops import (
    gaussian_upsample, hard_upsample, length_to_valid, sinusoid_table)

F32_ATOL = 1e-5
BF16_ATOL = BF16_RTOL = 2e-2


def _attn_data(B=2, H=2, Lq=40, Lk=33, D=32, seed=0, lens=None):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, Lq, D).astype(np.float32)
    k = rng.randn(B, H, Lk, D).astype(np.float32)
    v = rng.randn(B, H, Lk, D).astype(np.float32)
    lens = rng.randint(1, Lk + 1, size=B) if lens is None else np.asarray(lens)
    valid = np.arange(Lk)[None, :] < lens[:, None]
    return q, k, v, valid


def _upsample_data(B=3, L=20, D=16, seed=0, max_d=9):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, L, D).astype(np.float32)
    d = rng.randint(0, max_d, size=(B, L)).astype(np.float32)
    lens = rng.randint(L // 2, L + 1, size=B)
    lens[0] = L
    valid = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
    d[0, 3] = 0.0                      # a zero-duration phoneme
    return x, d, valid


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("max_len", [1, 7, 12])
def test_length_to_valid(max_len):
    lens = np.array([0, 3, 7, 12], np.int32)
    expect = np.asarray(jax_masks.length_to_valid(jnp.asarray(lens), max_len))
    np.testing.assert_array_equal(
        length_to_valid(_t(lens), max_len).numpy(), expect)


@pytest.mark.parametrize("n,d", [(1001, 256), (17, 64), (5, 6)])
def test_sinusoid_table(n, d):
    np.testing.assert_array_equal(sinusoid_table(n, d), jax_sinusoid(n, d))


@pytest.mark.parametrize("max_len", [40, 200])
def test_hard_upsample(max_len):
    x, d, _ = _upsample_data()
    out, mel_len = hard_upsample(_t(x), _t(d), max_len)
    e_out, e_len = jax_upsample.hard_upsample(jnp.asarray(x), jnp.asarray(d),
                                              max_len)
    np.testing.assert_allclose(out.numpy(), np.asarray(e_out), atol=F32_ATOL)
    np.testing.assert_array_equal(mel_len.numpy(), np.asarray(e_len))


@pytest.mark.parametrize("max_len", [40, 200])
def test_gaussian_upsample(max_len):
    x, d, valid = _upsample_data()
    out, mel_len, w = gaussian_upsample(_t(x), _t(d), max_len, _t(valid))
    e_out, e_len, e_w = jax_upsample.gaussian_upsample(
        jnp.asarray(x), jnp.asarray(d), max_len, jnp.asarray(valid))
    np.testing.assert_allclose(out.numpy(), np.asarray(e_out), atol=F32_ATOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(e_w), atol=F32_ATOL)
    np.testing.assert_array_equal(mel_len.numpy(), np.asarray(e_len))


def test_masked_softmax_matches_jax_with_fully_masked_row():
    rng = np.random.RandomState(4)
    scores = rng.randn(3, 5, 9).astype(np.float32)
    valid = rng.rand(3, 1, 9) > 0.4
    valid[1] = False                   # every row of item 1 fully masked
    got = masked_softmax(_t(scores), _t(valid)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_softmax(jnp.asarray(scores), jnp.asarray(valid))),
        atol=F32_ATOL)
    np.testing.assert_array_equal(got[1], 0.0)


def test_attention_reference_matches_jax_oracle():
    q, k, v, valid = _attn_data(seed=1)
    got = attention_reference(_t(q), _t(k), _t(v), _t(valid))
    expect = _attention_reference(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=F32_ATOL)


@pytest.mark.parametrize("lq,lk", [(40, 33), (17, 50)])
def test_flash_plain_version_matches_pallas_kernel(lq, lk):
    q, k, v, valid = _attn_data(Lq=lq, Lk=lk, seed=2)
    got = flash_attention(_t(q), _t(k), _t(v), _t(valid))
    expect = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(valid), 16, 16, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect),
                               atol=BF16_ATOL, rtol=BF16_RTOL)


def test_flash_fully_masked_item_is_zero():
    q, k, v, valid = _attn_data(lens=[0, 20], seed=3)
    got = flash_attention(_t(q), _t(k), _t(v), _t(valid)).numpy()
    np.testing.assert_array_equal(got[0], 0.0)
    assert np.isfinite(got).all()


def test_flash_bf16_input_keeps_dtype_on_cpu():
    q, k, v, valid = _attn_data(seed=5)
    bq, bk, bv = (_t(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention(bq, bk, bv, _t(valid))
    assert got.dtype == torch.bfloat16
    expect = attention_reference(bq.float(), bk.float(), bv.float(),
                                 _t(valid))
    np.testing.assert_allclose(got.float().numpy(), expect.numpy(),
                               atol=BF16_ATOL, rtol=BF16_RTOL)


@pytest.mark.parametrize("max_len", [30, 64, 300])
def test_banded_plain_version_matches_pallas_kernel(max_len):
    # max_len 30 and 64 cut Σd short; 300 leaves trailing zero frames
    x, d, valid = _upsample_data(L=40, seed=6)
    out, mel_len = gaussian_upsample_banded(_t(x), _t(d), max_len, _t(valid))
    e_out, e_len = jax_banded(jnp.asarray(x), jnp.asarray(d), max_len,
                              jnp.asarray(valid), block_l=16, block_t=32,
                              interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(e_out), atol=F32_ATOL)
    np.testing.assert_array_equal(mel_len.numpy(), np.asarray(e_len))


def test_cpu_tensors_take_the_plain_versions():
    kernels.reset_launches()
    q, k, v, valid = _attn_data(seed=7)
    flash_attention(_t(q), _t(k), _t(v), _t(valid))
    x, d, pv = _upsample_data(seed=7)
    gaussian_upsample_banded(_t(x), _t(d), 50, _t(pv))
    src_lens = torch.from_numpy(valid.sum(1))
    kernels.alignment_attention(_t(q), _t(k), _t(v), _t(valid), src_lens,
                                torch.full_like(src_lens, q.shape[2]))
    assert kernels.launches() == {"flash_attention": 0,
                                  "gaussian_upsample_banded": 0,
                                  "alignment_attention": 0}
