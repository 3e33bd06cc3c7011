"""The port's acoustic-model training against the JAX package on the CPU, at
a small width (d 64, 2 + 2 layers, 2 heads, B 2, L 14, T 48) with seeded
weights.

- The training forward on the alignment kernel's configuration
  (``intended``/``first``) against JAX with ``SMART_TTS_PALLAS=interpret``
  (its fused Pallas path in interpret mode) and against JAX's full-map path:
  duration targets exact, guided numerators 1e-4, each loss term rtol 1e-5,
  the total rtol 1e-4, updated BatchNorm running statistics 1e-5.
- The same on the default configuration (``soft``/``mean``), with the
  attention maps at 1e-4.
- One train step against JAX's ``make_train_step``: every parameter's
  gradient at atol 1e-4 / rtol 1e-3 (mapped through ``weights.py``).  The
  optimizer alone, fed JAX's gradients, reproduces optax's updates of steps
  1–3 at rtol 1e-5, and the Noam rates of steps 1–3 at rtol 1e-6.
- Gradient accumulation over two microbatches, on the port alone: 1e-5.

JAX's dropout is switched off inside these tests only (``monkeypatch`` of
``flax.linen.Dropout.__call__``), as the port's is by passing no generator;
both sides then compute the same f32 function.
"""

import copy

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_nar_fast_tts_tpu.config import (
    FeatureStats, ModelConfig, OptimizerConfig, PreprocessConfig,
    TransformerConfig)
from smart_nar_fast_tts_tpu.models import FastSpeech2Loss as JaxLoss
from smart_nar_fast_tts_tpu.training import (
    create_train_state as jax_create_state, make_eval_step as jax_eval_step,
    make_optimizer as jax_make_optimizer, make_train_step as jax_train_step,
    noam_schedule as jax_noam)
from smart_nar_fast_tts_tpu.training.step import Batch as JaxBatch
from smart_nar_fast_tts_tpu.training.step import _forward_loss
from smart_nar_fast_tts_tpu_torch import config as tcfg
from smart_nar_fast_tts_tpu_torch.data import Batch
from smart_nar_fast_tts_tpu_torch.models import (FastSpeech2Align,
                                                 FastSpeech2Loss)
from smart_nar_fast_tts_tpu_torch.training import (
    compute_gradients, create_train_state, make_eval_step, make_train_step)
from smart_nar_fast_tts_tpu_torch.weights import (jax_params_to_torch,
                                                  jax_to_torch_acoustic)
from torch_port_util import flatten, init_acoustic, random_variables

EXTRACTION = {"fused": ("intended", "first"), "default": ("soft", "mean")}
WIDTHS = dict(encoder_layer=2, encoder_head=2, encoder_hidden=64,
              decoder_layer=2, decoder_head=2, decoder_hidden=64,
              conv_filter_size=128)
STATS = dict(pitch_min=-2.0, pitch_max=2.0, energy_min=-2.0, energy_max=2.0)
LOSS_RTOL, TOTAL_RTOL = 1e-5, 1e-4
GNUM_ATOL, MAP_ATOL, BN_ATOL = 1e-4, 1e-4, 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3
ACC_TOL = 1e-5


def _configs(kind):
    extraction, head_reduce = EXTRACTION[kind]
    jcfg = ModelConfig(transformer=TransformerConfig(**WIDTHS),
                       duration_extraction=extraction,
                       duration_head_reduce=head_reduce)
    pcfg = tcfg.ModelConfig(transformer=tcfg.TransformerConfig(**WIDTHS),
                            duration_extraction=extraction,
                            duration_head_reduce=head_reduce)
    return jcfg, pcfg


@pytest.fixture(scope="module")
def setup():
    """Both models of each configuration on one seeded tree, and a seeded
    batch: item 1 shorter than the capacity in text and frames."""
    pre = PreprocessConfig(stats=FeatureStats(**STATS))
    out = {}
    for kind in EXTRACTION:
        jcfg, pcfg = _configs(kind)
        jax_model, shapes = init_acoustic(jcfg, pre)
        variables = random_variables(shapes, seed=31)
        port = FastSpeech2Align(pcfg, tcfg.PreprocessConfig(
            stats=tcfg.FeatureStats(**STATS)))
        port.load_state_dict(jax_to_torch_acoustic(flatten(variables), pcfg))
        out[kind] = (jax_model, variables, port)
    rng = np.random.RandomState(32)
    B, L, T = 2, 14, 48
    arrays = dict(
        texts=rng.randint(2, 300, (B, L)).astype(np.int32),
        src_lens=np.array([14, 9], np.int32),
        mels=rng.randn(B, T, 80).astype(np.float32),
        mel_lens=np.array([48, 31], np.int32),
        pitch=rng.randn(B, T).astype(np.float32),
        energy=rng.randn(B, T).astype(np.float32))
    return out, arrays


@pytest.fixture
def no_jax_dropout(monkeypatch):
    monkeypatch.setattr(flax_nn.Dropout, "__call__",
                        lambda self, x, *args, **kwargs: x)


def _jax_batch(arrays):
    return JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})


def _port_batch(arrays):
    return Batch(**{k: torch.from_numpy(v) for k, v in arrays.items()})


def _jax_forward(model, variables, arrays):
    """JAX's training forward (batch statistics, dropout patched off) and
    its loss terms."""
    b = _jax_batch(arrays)
    out, mutated = jax.jit(lambda v: model.apply(
        v, b.texts, b.src_lens, mels=b.mels, mel_lens=b.mel_lens,
        p_targets=b.pitch, e_targets=b.energy, deterministic=False,
        rngs={"dropout": jax.random.PRNGKey(0)},
        mutable=["batch_stats"]))(variables)
    losses = JaxLoss(PreprocessConfig(stats=FeatureStats(**STATS)))(
        out, b.mels, b.pitch, b.energy)
    return out, mutated["batch_stats"], losses


def _port_forward(port, arrays):
    model = copy.deepcopy(port).train()
    b = _port_batch(arrays)
    with torch.no_grad():
        out = model(b.texts, b.src_lens, mels=b.mels, mel_lens=b.mel_lens,
                    p_targets=b.pitch, e_targets=b.energy)
    losses = FastSpeech2Loss(tcfg.PreprocessConfig())(out, b.mels, b.pitch,
                                                      b.energy)
    return out, model, losses


def _check_losses(got, expect):
    for name in got._fields:
        rtol = TOTAL_RTOL if name == "total" else LOSS_RTOL
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(expect, name)), rtol=rtol,
                                   err_msg=name)


def _check_batch_stats(model, stats):
    for i in range(5):
        bn = model.postnet.convolutions[i][1]
        s = stats["postnet"][f"bn_{i}"]
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(s["mean"]), atol=BN_ATOL)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(s["var"]), atol=BN_ATOL)


@pytest.mark.parametrize("pallas", ["interpret", "off"])
def test_training_forward_fused_config(setup, no_jax_dropout, monkeypatch,
                                       pallas):
    models, arrays = setup
    jax_model, variables, port = models["fused"]
    if pallas == "interpret":
        monkeypatch.setenv("SMART_TTS_PALLAS", "interpret")
    else:
        monkeypatch.delenv("SMART_TTS_PALLAS", raising=False)
    expect, stats, e_losses = _jax_forward(jax_model, variables, arrays)
    got, model, losses = _port_forward(port, arrays)

    assert got.alignments is None and got.guided_numerators.shape == (2, 2)
    np.testing.assert_array_equal(got.duration_targets.numpy(),
                                  np.asarray(expect.duration_targets))
    np.testing.assert_array_equal(got.duration_targets.sum(1).numpy(),
                                  arrays["mel_lens"])
    if pallas == "interpret":           # JAX's fused path: the numerators
        np.testing.assert_allclose(got.guided_numerators.numpy(),
                                   np.asarray(expect.guided_numerators),
                                   atol=GNUM_ATOL)
    else:                               # JAX's full maps
        assert expect.guided_numerators is None
    _check_losses(losses, e_losses)
    _check_batch_stats(model, stats)


def test_training_forward_default_config(setup, no_jax_dropout,
                                         monkeypatch):
    models, arrays = setup
    jax_model, variables, port = models["default"]
    monkeypatch.delenv("SMART_TTS_PALLAS", raising=False)
    expect, stats, e_losses = _jax_forward(jax_model, variables, arrays)
    got, model, losses = _port_forward(port, arrays)

    assert got.guided_numerators is None
    assert got.alignments.shape == (2, 2, 2, 48, 14)
    np.testing.assert_allclose(got.alignments.numpy(),
                               np.asarray(expect.alignments), atol=MAP_ATOL)
    np.testing.assert_array_equal(got.duration_targets.numpy(),
                                  np.asarray(expect.duration_targets))
    _check_losses(losses, e_losses)
    _check_batch_stats(model, stats)


def _zero_state(port, cfg=tcfg.OptimizerConfig()):
    """A train state whose parameters are all 0: with no weight decay,
    each update then is exactly the optimizer's output."""
    model = copy.deepcopy(port)
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    return create_train_state(model, cfg, device="cpu")


@pytest.mark.parametrize("kind", ["fused", "default"])
def test_train_step_matches_jax(setup, no_jax_dropout, monkeypatch, kind):
    """Gradients on both configurations; on the kernel's configuration
    (the main path) also the whole update of JAX's ``make_train_step``, and
    the optimizer alone over three updates."""
    models, arrays = setup
    jax_model, variables, port = models[kind]
    monkeypatch.setenv("SMART_TTS_PALLAS", "interpret")
    jcfg, pcfg = _configs(kind)
    jloss = JaxLoss(PreprocessConfig(stats=FeatureStats(**STATS)))
    jbatch = _jax_batch(arrays)
    grads, (jlosses, jstats, _) = jax.jit(jax.grad(
        lambda p: _forward_loss(jax_model, jloss, p,
                                variables["batch_stats"], jbatch,
                                jax.random.PRNGKey(1), True),
        has_aux=True))(variables["params"])

    # the port: make_train_step's two halves, gradients then the update
    state = create_train_state(copy.deepcopy(port), device="cpu")
    losses, _ = compute_gradients(state, FastSpeech2Loss(),
                                  _port_batch(arrays))
    expect = jax_params_to_torch(flatten({"params": grads}), pcfg)
    for name, p in state.model.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got.numpy(), expect[name].numpy(),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)
    _check_losses(losses, jlosses)
    _check_batch_stats(state.model, jstats)
    if kind != "fused":
        return

    # JAX's whole step on its full-map path, which the forward test above
    # holds equal to its fused one: the kernel's interpret mode would double
    # this test's compile time
    monkeypatch.delenv("SMART_TTS_PALLAS")
    tx = jax_make_optimizer(OptimizerConfig(),
                            jcfg.transformer.encoder_hidden)
    new_jstate, step_losses = jax_train_step(jax_model, jloss)(
        jax_create_state(variables, tx), jbatch, jax.random.PRNGKey(1))
    state.apply_gradients()
    _check_losses(losses, step_losses)
    _check_batch_stats(state.model, new_jstate.batch_stats)
    # every update is at most lr(1) ≈ 4.9e-7 in size; a gradient element
    # within the tolerance of 0 may take either sign, so the new parameters
    # agree within 2·lr(1)
    new_expect = jax_params_to_torch(flatten({"params": new_jstate.params}),
                                     pcfg)
    bound = 2.0 * state.lr(1) + 1e-7
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   new_expect[name].numpy(), atol=bound,
                                   rtol=0, err_msg=name)
    assert state.step == 1 and int(new_jstate.step) == 1

    # the optimizer alone, fed JAX's gradients, over three updates
    zstate = _zero_state(port)
    opt_state = tx.init(jax.tree.map(jnp.zeros_like, variables["params"]))
    total = jax.tree.map(jnp.zeros_like, variables["params"])
    update = jax.jit(tx.update)
    for _ in range(3):
        for name, p in zstate.model.named_parameters():
            p.grad = expect[name].clone()
        zstate.apply_gradients()
        updates, opt_state = update(grads, opt_state)
        total = jax.tree.map(jnp.add, total, updates)
        want = jax_params_to_torch(flatten({"params": total}), pcfg)
        for name, p in zstate.model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       want[name].numpy(), rtol=1e-5,
                                       atol=1e-12, err_msg=name)
    for step in (1, 2, 3):
        np.testing.assert_allclose(
            zstate.lr(step), float(jax_noam(jnp.asarray(step), 64, 4000)),
            rtol=1e-6)


def test_eval_step_matches_jax(setup, monkeypatch):
    models, arrays = setup
    jax_model, variables, port = models["fused"]
    monkeypatch.setenv("SMART_TTS_PALLAS", "interpret")
    jloss = JaxLoss(PreprocessConfig(stats=FeatureStats(**STATS)))
    jstate = jax_create_state(variables, jax_make_optimizer(
        OptimizerConfig(), 64))
    e_losses, e_weights = jax_eval_step(jax_model, jloss)(
        jstate, _jax_batch(arrays))
    state = create_train_state(copy.deepcopy(port), device="cpu")
    losses, weights = make_eval_step(FastSpeech2Loss())(
        state, _port_batch(arrays))
    _check_losses(losses, e_losses)
    for name in weights._fields:
        assert float(getattr(weights, name)) == float(
            getattr(e_weights, name)), name


def _grads(state):
    return {n: p.grad.clone() for n, p in state.model.named_parameters()
            if p.grad is not None}


def test_grad_accumulation_averages_microbatches(setup):
    models, arrays = setup
    port = models["fused"][2]
    loss_fn = FastSpeech2Loss()
    batch = _port_batch(arrays)
    halves = batch.split(2)

    def run(b, acc):
        state = create_train_state(copy.deepcopy(port), device="cpu")
        losses, _ = compute_gradients(state, loss_fn, b, acc)
        return state, losses, _grads(state)

    # two distinct microbatches: the mean of their gradients
    acc_state, acc_losses, acc = run(batch, 2)
    parts = [run(h, 1) for h in halves]
    for name, g in acc.items():
        mean = (parts[0][2][name] + parts[1][2][name]) / 2
        torch.testing.assert_close(g, mean, atol=ACC_TOL, rtol=ACC_TOL)
    for name in acc_losses._fields:
        torch.testing.assert_close(
            getattr(acc_losses, name),
            (getattr(parts[0][1], name) + getattr(parts[1][1], name)) / 2,
            atol=ACC_TOL, rtol=ACC_TOL)
    # the running statistics move once per microbatch, in order
    seq = create_train_state(copy.deepcopy(port), device="cpu")
    for h in halves:
        compute_gradients(seq, loss_fn, h, 1)
    for a, b in zip(acc_state.model.buffers(), seq.model.buffers()):
        torch.testing.assert_close(a, b, atol=ACC_TOL, rtol=ACC_TOL)

    # a batch of two copies of one microbatch: one step on the whole batch
    twice = Batch(*(None if t is None else torch.cat([t, t])
                    for t in halves[0]))
    _, _, whole = run(twice, 1)
    _, _, split = run(twice, 2)
    assert whole.keys() == split.keys()
    for name, g in whole.items():
        torch.testing.assert_close(split[name], g, atol=ACC_TOL,
                                   rtol=ACC_TOL)


def test_train_step_device_rule(setup, monkeypatch):
    port = setup[0]["fused"][2]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(copy.deepcopy(port))
    state = create_train_state(copy.deepcopy(port), device="cpu")
    step = make_train_step(FastSpeech2Loss(), keep_outputs=True)
    before = [p.detach().clone() for p in state.model.parameters()]
    losses, outs = step(state, _port_batch(setup[1]),
                        torch.Generator().manual_seed(0))
    assert state.step == 1 and torch.isfinite(losses.total)
    assert outs[0].duration_targets.sum() == int(setup[1]["mel_lens"].sum())
    assert any(not torch.equal(a, p) for a, p in
               zip(before, state.model.parameters()))
