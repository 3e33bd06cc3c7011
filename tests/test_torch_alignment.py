"""The port's alignment pieces against the JAX package on the CPU: the
alignment attention's plain version, the gradients of the three kernel
wrappers, duration extraction, and BatchNorm's training statistics.

Tolerances: alignment ``out`` 1e-5, ``idx`` exact, ``gnum`` 1e-4 (the JAX
package's own kernel test, ``tests/test_pallas_kernels.py``), for the f32
plain version and for the plain version that rounds as the CUDA kernel does
(``alignment_tf32x3_reference``: 3xTF32 products, about f32 accuracy);
gradients 1e-4 (the same test's); durations exact; BatchNorm 1e-5.
Everything is f32 on both sides.  The JAX kernels run in interpret mode; the port's wrappers take
their plain versions on the CPU, and each ``torch.autograd.Function`` that
the CUDA branch uses is driven here with the plain version as its forward,
so its backward is held to JAX's too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_nar_fast_tts_tpu.models.layers import (
    MaskedBatchNorm as JaxMaskedBatchNorm)
from smart_nar_fast_tts_tpu.ops import duration as jax_duration
from smart_nar_fast_tts_tpu.ops.pallas.alignment import (
    _alignment_reference, alignment_attention as jax_alignment)
from smart_nar_fast_tts_tpu.ops.pallas.attention import (
    flash_attention as jax_flash)
from smart_nar_fast_tts_tpu.ops.pallas.upsample import (
    gaussian_upsample_banded as jax_banded)
from smart_nar_fast_tts_tpu_torch.kernels import (
    alignment_attention, alignment_reference, attention_reference,
    flash_attention, gaussian_upsample_banded)
from smart_nar_fast_tts_tpu_torch.kernels.alignment import (
    _AlignmentAttention, alignment_tf32x3_reference, tf32_round)
from smart_nar_fast_tts_tpu_torch.kernels.attention import _FlashAttention
from smart_nar_fast_tts_tpu_torch.kernels.upsample import _GaussianUpsample
from smart_nar_fast_tts_tpu_torch.models.layers import MaskedBatchNorm
from smart_nar_fast_tts_tpu_torch.ops import (
    durations_from_argmax, durations_from_attention, gaussian_upsample)

OUT_ATOL = 1e-5
GNUM_ATOL = 1e-4
GRAD_TOL = 1e-4
BN_ATOL = 1e-5
SIGMA = 0.2


def _alignment_data(B=2, H=2, T=45, L=13, D=32, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, n, D).astype(np.float32)
               for n in (T, L, L))
    src_lens = np.array([L, L - 4][:B], np.int32)      # item 1: src_len < L
    mel_lens = np.array([T, T - 12][:B], np.int32)
    valid = np.arange(L)[None, :] < src_lens[:, None]
    return q, k, v, valid, src_lens, mel_lens


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("shape", [(2, 2, 45, 13, 32), (2, 2, 48, 16, 16)])
def test_alignment_plain_version_matches_jax(shape):
    B, H, T, L, D = shape
    data = _alignment_data(B, H, T, L, D, seed=T)
    out, idx, gnum = alignment_attention(*_torch(*data), SIGMA)
    jx = [jnp.asarray(a) for a in data]
    for expect in (_alignment_reference(*jx, SIGMA),
                   jax_alignment(*jx, SIGMA, 16, True)):
        e_out, e_idx, e_gnum = (np.asarray(a) for a in expect)
        np.testing.assert_allclose(out.numpy(), e_out, atol=OUT_ATOL)
        np.testing.assert_array_equal(idx.numpy(), e_idx)
        np.testing.assert_allclose(gnum.numpy(), e_gnum, atol=GNUM_ATOL)
    assert idx.dtype == torch.int32 and gnum.shape == (B,)


@pytest.mark.parametrize("shape", [(2, 2, 45, 13, 32), (2, 2, 48, 16, 16)])
def test_alignment_tf32x3_plain_version_matches_jax(shape):
    B, H, T, L, D = shape
    data = _alignment_data(B, H, T, L, D, seed=T)
    out, idx, gnum = alignment_tf32x3_reference(*_torch(*data), SIGMA)
    jx = [jnp.asarray(a) for a in data]
    for expect in (_alignment_reference(*jx, SIGMA),
                   jax_alignment(*jx, SIGMA, 16, True)):
        e_out, e_idx, e_gnum = (np.asarray(a) for a in expect)
        np.testing.assert_allclose(out.numpy(), e_out, atol=OUT_ATOL)
        np.testing.assert_array_equal(idx.numpy(), e_idx)
        np.testing.assert_allclose(gnum.numpy(), e_gnum, atol=GNUM_ATOL)
    assert idx.dtype == torch.int32 and gnum.shape == (B,)


def test_alignment_tf32x3_argmax_at_the_card_check_inputs():
    """``chip_smoke.py``'s seeded alignment inputs at the flagship training
    shape (``alignment_inputs``, ``default_rng(3)``, its first draw): the
    3xTF32 plain version's head-0 argmax equals the f32 plain version's on
    all 43,008 rows.  Only head 0 goes in: ``idx`` reads no other head."""
    rng = np.random.default_rng(3)
    b, h, t, l, d = 48, 2, 896, 128, 128
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32)
               for n in (t, l, l))
    src = rng.integers(max(3 * l // 4, 1), l + 1, size=b)
    src[-1] = max(l - 5, 1)
    mel = rng.integers(3 * t // 4, t + 1, size=b)
    valid = np.arange(l)[None, :] < src[:, None]
    args = _torch(q[:, :1], k[:, :1], v[:, :1], valid, src, mel)
    _, idx_f32, _ = alignment_reference(*args)
    _, idx_3x, _ = alignment_tf32x3_reference(*args)
    exact = np.einsum("btd,bnd->btn", q[:, 0].astype(np.float64),
                      k[:, 0].astype(np.float64))
    top2 = np.sort(np.where(valid[:, None, :], exact, -np.inf), axis=-1)
    gap = (top2[..., -1] - top2[..., -2]).min()
    differ = int((idx_3x != idx_f32).sum())
    assert differ == 0, (f"{differ} of {b * t} rows differ; the smallest "
                         f"f64 top-two gap of the unscaled scores is {gap:.3e}")


@pytest.mark.parametrize("x, expect", [
    (1.0, 1.0), (1 + 2**-11, 1 + 2**-10), (-(1 + 2**-11), -(1 + 2**-10)),
    (1 + 2**-11 - 2**-20, 1.0), (1 + 2**-10 + 2**-11, 1 + 2**-9),
    (2 - 2**-12, 2.0), (0.0, 0.0)])
def test_tf32_round_is_to_nearest_ties_away(x, expect):
    """``cvt.rna.tf32.f32``: 10 explicit mantissa bits, to nearest, ties
    away from zero, a carry moving into the exponent."""
    got = tf32_round(torch.tensor([x], dtype=torch.float32))
    assert got.item() == expect


def test_alignment_argmax_takes_the_first_of_equal_maxima():
    q, k, v, valid, sl, ml = _alignment_data(B=1, H=1, T=8, L=6, D=4)
    k[0, 0, 3] = k[0, 0, 1]                    # keys 1 and 3 score alike
    q[0, 0] = k[0, 0, 1] * 5.0                 # and above every other key
    _, idx, _ = alignment_reference(*_torch(q, k, v, valid, sl, ml))
    _, e_idx, _ = _alignment_reference(
        *(jnp.asarray(a) for a in (q, k, v, valid, sl, ml)), SIGMA)
    assert (idx == 1).all()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(e_idx))


def _leaves(tensors):
    return [t.detach().clone().requires_grad_() for t in tensors]


def _port_grads(fn, inputs, cotangents):
    outs = fn(*inputs)
    total = sum((o * c).sum() for o, c in zip(outs, cotangents))
    return torch.autograd.grad(total, inputs)


def _check(port, expect):
    for got, want in zip(port, expect):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)


@pytest.mark.parametrize("through", ["wrapper", "function"])
def test_flash_attention_gradient_matches_jax(through):
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(2, 2, n, 32).astype(np.float32)
               for n in (40, 24, 24))
    valid = np.arange(24)[None, :] < np.array([24, 17])[:, None]
    ct = rng.randn(2, 2, 40, 32).astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(
        q, k, v, jnp.asarray(valid), 16, 16, True), *map(jnp.asarray,
                                                          (q, k, v)))
    expect = vjp(jnp.asarray(ct))
    tvalid = torch.from_numpy(valid)
    if through == "wrapper":
        def fn(q, k, v):
            return (flash_attention(q, k, v, tvalid),)
    else:
        def fn(q, k, v):
            return (_FlashAttention.apply(q, k, v, tvalid,
                                          attention_reference),)
    _check(_port_grads(fn, _leaves(_torch(q, k, v)), _torch(ct)), expect)


@pytest.mark.parametrize("through", ["wrapper", "function"])
def test_gaussian_upsample_gradient_matches_jax(through):
    rng = np.random.RandomState(6)
    x = rng.randn(2, 12, 16).astype(np.float32)
    d = rng.randint(0, 6, (2, 12)).astype(np.float32)
    pv = (np.arange(12)[None, :] < np.array([12, 8])[:, None]).astype(
        np.float32)
    ct = rng.randn(2, 48, 16).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jax_banded(
        x, jnp.asarray(d), 48, jnp.asarray(pv), interpret=True)[0],
        jnp.asarray(x))
    expect = vjp(jnp.asarray(ct))
    td, tpv = _torch(d, pv)
    if through == "wrapper":
        def fn(x):
            return (gaussian_upsample_banded(x, td, 48, tpv)[0],)
    else:
        def plain(x, d, pv, max_len, sigma):
            return gaussian_upsample(x, d, max_len, pv, sigma=sigma)[:2]

        def fn(x):
            return (_GaussianUpsample.apply(x, td, tpv, 48, 10.0, plain)[0],)
    _check(_port_grads(fn, _leaves(_torch(x)), _torch(ct)), expect)


@pytest.mark.parametrize("through", ["wrapper", "function"])
def test_alignment_attention_gradient_matches_jax(through):
    q, k, v, valid, sl, ml = _alignment_data(T=30, L=11, D=16, seed=7)
    rng = np.random.RandomState(8)
    ct_out = rng.randn(*q.shape).astype(np.float32)
    ct_gnum = rng.randn(2).astype(np.float32)
    jfixed = [jnp.asarray(a) for a in (valid, sl, ml)]
    _, vjp = jax.vjp(lambda q, k, v: (lambda r: (r[0], r[2]))(
        jax_alignment(q, k, v, *jfixed, SIGMA, 16, True)),
        *map(jnp.asarray, (q, k, v)))
    expect = vjp((jnp.asarray(ct_out), jnp.asarray(ct_gnum)))
    fixed = _torch(valid, sl, ml)
    if through == "wrapper":
        def fn(q, k, v):
            out, _, gnum = alignment_attention(q, k, v, *fixed, SIGMA)
            return out, gnum
    else:
        def fn(q, k, v):
            out, idx, gnum = _AlignmentAttention.apply(
                q, k, v, *fixed, SIGMA, alignment_reference)
            assert not idx.requires_grad
            return out, gnum
    _check(_port_grads(fn, _leaves(_torch(q, k, v)),
                       _torch(ct_out, ct_gnum)), expect)


def _attention_maps(B=2, H=2, T=48, L=16, seed=9, decimals=None):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, H, T, L).astype(np.float32) * 2.0
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    if decimals is not None:                   # coarse maps: exact ties
        attn = np.round(attn, decimals).astype(np.float32)
    src_lens = np.array([L, L - 5], np.int32)
    mel_lens = np.array([T, T - 13], np.int32)
    return attn, src_lens, mel_lens


@pytest.mark.parametrize("decimals", [None, 1])
@pytest.mark.parametrize("mode,head_reduce", [
    ("intended", "first"), ("intended", "mean"), ("soft", "first"),
    ("soft", "mean"), ("buggy", "first")])
def test_durations_from_attention_match_jax(mode, head_reduce, decimals):
    attn, sl, ml = _attention_maps(decimals=decimals)
    got = durations_from_attention(*_torch(attn, sl, ml), mode=mode,
                                   head_reduce=head_reduce)
    expect = jax_duration.durations_from_attention(
        jnp.asarray(attn), jnp.asarray(sl), jnp.asarray(ml), mode=mode,
        head_reduce=head_reduce)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))
    if mode != "buggy" and decimals is None:  # every row has mass
        np.testing.assert_array_equal(got.sum(1).numpy(), ml)


def test_durations_from_argmax_match_jax():
    rng = np.random.RandomState(10)
    idx = rng.randint(0, 16, (3, 40)).astype(np.int32)
    sl = np.array([16, 9, 1], np.int32)
    ml = np.array([40, 22, 0], np.int32)
    got = durations_from_argmax(*_torch(idx, sl, ml), 16)
    expect = jax_duration.durations_from_argmax(
        jnp.asarray(idx), jnp.asarray(sl), jnp.asarray(ml), 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))


@pytest.mark.parametrize("with_cap", [True, False])
def test_masked_batch_norm_training_statistics(with_cap):
    rng = np.random.RandomState(11)
    B, T, C = 3, 20, 8
    x = (rng.randn(B, T, C) * 2.0 + 0.5).astype(np.float32)
    cap = np.arange(T) < 14
    scale, bias = (rng.randn(C).astype(np.float32) for _ in range(2))
    mean, var = rng.randn(C).astype(np.float32), rng.rand(C).astype(
        np.float32) + 0.5
    expect, mutated = JaxMaskedBatchNorm().apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean, "var": var}},
        jnp.asarray(x), use_running_average=False,
        cap_valid=jnp.asarray(cap) if with_cap else None,
        mutable=["batch_stats"])
    bn = MaskedBatchNorm(C).train()
    bn.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean),
                        "running_var": torch.from_numpy(var)})
    got = bn(torch.from_numpy(x).transpose(1, 2),
             torch.from_numpy(cap) if with_cap else None).transpose(1, 2)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(expect),
                               atol=BN_ATOL)
    stats = mutated["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), atol=BN_ATOL)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), atol=BN_ATOL)
