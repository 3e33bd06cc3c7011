"""The port's multi-device axes against the JAX package on the CPU: four
gloo ranks of the port (one spawned job for the whole module,
``torch_parallel_cases.run_ranks``) beside JAX on four of the conftest's
host devices.

- ``make_mesh`` with ``-1``, its coordinates, rows and axis groups.
- Ring attention (``sequence_parallel_self_attention`` over a 4-way axis)
  against JAX's on a ``(4,)`` mesh: full, ragged inside an interior shard,
  and no valid key (zero rows); atol/rtol 1e-5, the JAX test's bar.  Its
  q/k/v gradients against dense autograd at 2e-5, and alike on every rank.
- The ring at logits of 3e2–1.6e3 (the committed weights' reach ~2.5e3),
  in one block without a group and in 2 and 4 blocks over the ranks: its
  output and gradients within JAX's SP bar of the dense f32 branch, and
  at most ``WITNESS_FACTOR`` times as far from float64 as that branch; in
  one block, equal to ``kernels.einsum_attention`` bit for bit.
- The channel-sharded HiFi-GAN on a ``(2, 2)`` data × model mesh against
  JAX's ``shard_hifigan`` at 1e-5, each rank holding half of every conv's
  output channels but ``conv_post``'s.
- The errors: two meshes, the ring without a mesh, a frame axis the seq
  axis does not divide, an ``sp_axis`` that is not a mesh axis, a mesh tail
  the ranks cannot hold (JAX's message), and a batch that would leave
  ranks idle.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from smart_nar_fast_tts_tpu.parallel.mesh import make_mesh as jax_mesh
from smart_nar_fast_tts_tpu.parallel.sequence import (
    sequence_parallel_self_attention as jax_ring)
from smart_nar_fast_tts_tpu.vocoder import HiFiGANConfig as JaxGenConfig
from smart_nar_fast_tts_tpu.vocoder.sharding import (
    shard_hifigan as jax_shard_hifigan)
from smart_nar_fast_tts_tpu_torch.kernels import (einsum_attention,
                                                  masked_softmax)
from smart_nar_fast_tts_tpu_torch.models import FastSpeech2Align
from smart_nar_fast_tts_tpu_torch.parallel import ring_self_attention
from smart_nar_fast_tts_tpu_torch.vocoder import (HiFiGANConfig,
                                                  HiFiGANGenerator)
from smart_nar_fast_tts_tpu_torch.weights import jax_to_torch_hifigan
from torch_parallel_cases import (parallel_cases, port_configs,
                                  run_ranks)
from torch_port_util import flatten, init_vocoder, random_variables

RING_TOL = 1e-5
GRAD_TOL = 2e-5
TP_TOL = 1e-5
# JAX's SP gradient bar (tests/test_sequence_parallel.py:209-211)
SP_ATOL, SP_RTOL = 2e-5, 2e-3
# the ring's largest distance from float64 over the dense f32 branch's
WITNESS_FACTOR = 1.5
# q and k's standard deviation: logits up to ~320, ~980 and ~1600
LARGE_LOGIT_SCALES = (8.0, 14.0, 18.0)
HIFIGAN = dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
               upsample_initial_channel=16, resblock_kernel_sizes=(3,),
               resblock_dilation_sizes=((1, 2),), n_mels=8)


def _ring_inputs():
    """JAX's ring test inputs (``tests/test_sequence_parallel.py``), each
    at B 2 (one JAX compile for all three), and a seeded cotangent for
    each."""
    def data(seed):
        rng = np.random.RandomState(seed)
        q, k, v = (rng.randn(2, 2, 64, 16).astype(np.float32)
                   for _ in range(3))
        lens = rng.randint(32, 65, size=2)
        return q, k, v, np.arange(64)[None, :] < lens[:, None]
    full = data(0)
    ragged = data(1)[:3] + (np.arange(64)[None, :] < np.array([[23], [9]]),)
    none = data(2)[:3] + (np.zeros((2, 64), bool),)
    ring = {"full": full, "ragged": ragged, "none": none}
    rng = np.random.RandomState(9)
    cot = {k: rng.randn(*v[0].shape).astype(np.float32)
           for k, v in ring.items()}
    return ring, cot


def _large_logit_case(scale):
    """B 2, H 2, T 512, D 128: q and k of standard deviation ``scale``,
    row 1's keys padded past frame 300 (whole blocks of it at 4 blocks),
    and a seeded cotangent."""
    rng = np.random.RandomState(0)
    q, k = ((rng.randn(2, 2, 512, 128) * scale).astype(np.float32)
            for _ in range(2))
    v = rng.randn(2, 2, 512, 128).astype(np.float32)
    valid = np.ones((2, 512), bool)
    valid[1, 300:] = False
    return q, k, v, valid, rng.randn(*q.shape).astype(np.float32)


@pytest.fixture(scope="module")
def jax_hifigan():
    gen, shapes = init_vocoder("hifigan",
                               JaxGenConfig(**HIFIGAN, tail_impl="plain"))
    return gen, random_variables(shapes, seed=21)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_hifigan):
    _, variables = jax_hifigan
    ring, cot = _ring_inputs()
    inputs = dict(
        ring=ring, cotangent=cot,
        ring_large={c: _large_logit_case(c) for c in LARGE_LOGIT_SCALES},
        hifigan_config=HIFIGAN,
        hifigan_state=jax_to_torch_hifigan(flatten(variables),
                                           HiFiGANConfig(**HIFIGAN)),
        tp_mels=np.random.RandomState(3).randn(4, 12, 8).astype(np.float32))
    return inputs, run_ranks(parallel_cases,
                             tmp_path_factory.mktemp("parallel"), inputs)


def test_make_mesh(ranks):
    _, results = ranks
    for r, res in enumerate(results):
        m = res["meshes"]
        assert m["flat"] == ({"data": 4}, {"data": r})
        assert m["grid"] == ({"data": 2, "seq": 2},
                             {"data": r // 2, "seq": r % 2})
        assert m["default"] == {"data": 4, "model": 1}
        assert m["rows"] == slice(4 * (r // 2), 4 * (r // 2) + 4)
        assert m["grid_groups"] == [[r % 2, r % 2 + 2],
                                    [r - r % 2, r - r % 2 + 1]]


@pytest.mark.parametrize("case", ["full", "ragged", "none"])
def test_ring_matches_jax(ranks, case):
    inputs, results = ranks
    expect = np.asarray(_jax_ring()(*inputs["ring"][case]))
    for res in results:
        got = res["ring"][case]["out"]
        if case == "none":
            np.testing.assert_array_equal(got, 0.0)
        np.testing.assert_allclose(got, expect, atol=RING_TOL, rtol=RING_TOL)


@functools.cache
def _jax_ring():
    mesh = jax_mesh((4,), ("data",), devices=jax.devices()[:4])
    return jax.jit(lambda q, k, v, valid: jax_ring(mesh, q, k, v, valid))


def _dense(q, k, v, valid):
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / q.shape[-1] ** 0.5
    p = masked_softmax(scores, valid[:, None, None, :])
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def _grads(fn, q, k, v, valid, cot, dtype=torch.float32):
    """``fn``'s output and its q, k, v gradients under ``cot``, in
    ``dtype``, as numpy arrays keyed out/dq/dk/dv."""
    q, k, v = (torch.from_numpy(x).to(dtype).requires_grad_()
               for x in (q, k, v))
    out = fn(q, k, v, torch.from_numpy(valid))
    (out * torch.from_numpy(cot).to(dtype)).sum().backward()
    return dict(out=out.detach().numpy(), dq=q.grad.numpy(),
                dk=k.grad.numpy(), dv=v.grad.numpy())


@pytest.mark.parametrize("case", ["full", "ragged", "none"])
def test_ring_gradients_match_dense(ranks, case):
    inputs, results = ranks
    want = _grads(_dense, *inputs["ring"][case], inputs["cotangent"][case])
    first = results[0]["ring"][case]
    for name in ("dq", "dk", "dv"):
        np.testing.assert_allclose(first[name], want[name],
                                   atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=name)
        for res in results[1:]:       # every seq rank: the same gradient
            np.testing.assert_array_equal(res["ring"][case][name],
                                          first[name])


@functools.cache
def _dense_at_large_logits(scale):
    case = _large_logit_case(scale)
    return (_grads(_dense, *case), _grads(_dense, *case, torch.float64))


def _assert_rounds_as_dense(got, scale):
    """The ring's out/dq/dk/dv on ``_large_logit_case(scale)``: within
    JAX's SP bar of the dense f32 branch (atol SP_ATOL·max(scale, 1), the
    scale that of each dense tensor, rtol SP_RTOL), and at most
    WITNESS_FACTOR times as far from float64 as the dense branch."""
    dense, f64 = _dense_at_large_logits(scale)
    for name, want in dense.items():
        np.testing.assert_allclose(
            got[name], want, rtol=SP_RTOL,
            atol=SP_ATOL * max(float(np.abs(want).max()), 1.0),
            err_msg=name)
        ring_err = np.abs(got[name] - f64[name]).max()
        dense_err = np.abs(want - f64[name]).max()
        assert ring_err <= WITNESS_FACTOR * dense_err, (name, ring_err,
                                                        dense_err)


@pytest.mark.parametrize("scale", LARGE_LOGIT_SCALES)
def test_ring_rounds_as_dense_at_large_logits(scale):
    """The ring of one (no group, one block)."""
    _assert_rounds_as_dense(
        _grads(ring_self_attention, *_large_logit_case(scale)), scale)


@pytest.mark.parametrize("scale", LARGE_LOGIT_SCALES)
def test_ring_of_one_is_the_dense_branch(scale):
    """One block: the dense branch's rounding exactly, the backward's
    recomputed scores included."""
    case = _large_logit_case(scale)
    got = _grads(ring_self_attention, *case)
    want = _grads(lambda *x: einsum_attention(*x)[0], *case)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("blocks", [2, 4])
@pytest.mark.parametrize("scale", LARGE_LOGIT_SCALES)
def test_ring_blocks_round_as_dense_at_large_logits(ranks, blocks, scale):
    _, results = ranks
    _assert_rounds_as_dense(results[0]["ring_large"][blocks, scale], scale)


def test_tp_hifigan_matches_jax(ranks, jax_hifigan):
    inputs, results = ranks
    gen, variables = jax_hifigan
    mesh = jax_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
    expect = np.asarray(jax_shard_hifigan(gen, variables, mesh)(
        jnp.asarray(inputs["tp_mels"])))
    assert expect.shape == (4, 12 * 8)
    whole = {n: tuple(p.shape) for n, p in HiFiGANGenerator(
        HiFiGANConfig(**HIFIGAN)).named_parameters()}
    for res in results:
        np.testing.assert_allclose(res["tp_wavs"], expect, atol=TP_TOL)
        # each rank holds half of every conv's output channels but
        # conv_post's (dim 1 of a ConvTranspose1d's weight)
        shapes = {n.replace(".conv.", "."): s
                  for n, s in res["tp_shapes"].items()}
        assert shapes.keys() == whole.keys()
        for name, shape in whole.items():
            dim = 1 if name.startswith("ups.") and name.endswith(
                "weight") else 0
            want = list(shape)
            if not name.startswith("conv_post"):
                want[dim] //= 2
            assert shapes[name] == tuple(want), name


@pytest.mark.parametrize("case,message", [
    ("two_meshes", "ValueError: hybrid DP×SP requires one shared 2-D mesh"),
    ("indivisible", "ValueError: ModelConfig.sequence_parallel=True: the "
                    "frame capacity 30 must divide the size 4"),
    ("sp_axis", "ValueError: model.tpu.sp_axis='seq' is not a mesh axis "
                "('data', 'model')"),
    ("tail", "ValueError: mesh_shape tail (8,) needs 8 devices per data "
             "slot but only 4 are local"),
    ("idle", "ValueError: batch_size 2 over 1 node(s) shards over 2 data "
             "slot(s) of 1 rank(s), 2 of the 4 ranks per node")])
def test_errors(ranks, case, message):
    _, results = ranks
    for res in results:
        assert res["errors"][case].startswith(message), res["errors"][case]


def test_sequence_parallel_needs_the_mesh():
    model_cfg, pre = port_configs(sequence_parallel=True)
    model = FastSpeech2Align(model_cfg, pre).eval()
    texts = torch.randint(2, 300, (1, 8))
    with pytest.raises(ValueError, match="requires the mesh: pass sp_mesh="):
        model(texts, torch.tensor([8]), max_mel_len=64)
