"""The port's training on a mesh against the JAX package on the CPU: four
gloo ranks of the port (one spawned job for the whole module,
``torch_parallel_cases.training_cases``) beside JAX's sharded steps on four
of the conftest's host devices, from one set of seeded weights, dropout off
on both sides (flax's ``Dropout`` patched inside the module's fixture).

- The DP train step on a ``(4,)`` mesh, a batch whose rows hold other text
  and frame lengths on every rank, against JAX's train step on the global
  batch (its step body: ``_forward_loss`` gradients, then optax; JAX's own
  ``test_train_step_sharded_matches_single_device`` holds its sharded step
  to it): losses rtol 1e-4, gradients at JAX's bar (atol 2e-5·max(scale,
  1), rtol 2e-3), parameters and BatchNorm running statistics 1e-5; the
  same with ``grad_acc_step`` 2 on a global batch of 16 rows (JAX's
  microbatches: rows of the global batch, the statistics carried from one
  to the next); and the DP step on a ``(2, 2)`` data × model mesh, whose
  ranks along ``model`` compute the same rows, against the same step.
  Every rank holds the same parameters after each.
- The SP step (the ring over the 4-way axis) and the hybrid ``(2, 2)`` data
  × seq step against the same: losses 1e-4, gradients at JAX's bar, alike
  on every rank.
- The DP eval step's losses and weights against JAX's
  ``make_eval_step(mesh=)``.
- The DP GAN step against JAX's ``make_vocoder_train_step(mesh=)``: metrics
  rtol 1e-3, both trees 1e-5.
- Two steps of ``Trainer.fit`` on a ``(2, 2)`` data × seq mesh: the same
  parameters on every rank, only the first rank's files, and those on
  disk when ``fit`` returns on any rank.

JAX runs its Pallas kernels off (the alignment path's full maps, the plain
log-mel); the port's CPU wrappers run their plain versions.
"""

import functools
import glob
import os

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smart_nar_fast_tts_tpu.audio.stft import (
    MelSpectrogramConfig as JaxMelConfig)
from smart_nar_fast_tts_tpu.config import (FeatureStats, ModelConfig,
                                           OptimizerConfig, PreprocessConfig,
                                           TransformerConfig)
from smart_nar_fast_tts_tpu.models import FastSpeech2Loss as JaxLoss
from smart_nar_fast_tts_tpu.parallel.mesh import batch_sharding
from smart_nar_fast_tts_tpu.parallel.mesh import make_mesh as jax_mesh
from smart_nar_fast_tts_tpu.training import (
    create_train_state as jax_create_state, make_eval_step as jax_eval_step,
    make_optimizer as jax_make_optimizer)
from smart_nar_fast_tts_tpu.training import vocoder as jax_voc
from smart_nar_fast_tts_tpu.training.step import Batch as JaxBatch
from smart_nar_fast_tts_tpu.training.step import _forward_loss
from smart_nar_fast_tts_tpu.vocoder import HiFiGANConfig as JaxGenConfig
from smart_nar_fast_tts_tpu.vocoder import HiFiGANGenerator as JaxGenerator
from smart_nar_fast_tts_tpu.vocoder.discriminators import (
    HiFiGANDiscriminator as JaxDiscriminator)
from smart_nar_fast_tts_tpu_torch import config as tcfg
from smart_nar_fast_tts_tpu_torch.vocoder import HiFiGANDiscriminator
from smart_nar_fast_tts_tpu_torch.weights import (
    jax_params_to_torch, jax_to_torch_acoustic, jax_to_torch_discriminator,
    jax_to_torch_hifigan)
from torch_parallel_cases import (EXTRACTION, GAN_B, STATS, WIDTHS, Ranks,
                                  acoustic_arrays, training_cases)
from torch_port_util import (GAN_DISC, GAN_MEL, GAN_SEG, flatten,
                             init_acoustic, make_trainer_corpus,
                             random_variables, write_trainer_triplet)

LOSS_RTOL = 1e-4
PARAM_ATOL = BN_ATOL = 1e-5
GAN_RTOL = 1e-3
GAN_GEN = dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
               upsample_initial_channel=16, resblock_kernel_sizes=(3,),
               resblock_dilation_sizes=((1, 2),), n_mels=8)


def _jax_config():
    return ModelConfig(transformer=TransformerConfig(**WIDTHS),
                       max_seq_len=64, **EXTRACTION)


def _gan_wavs():
    rng = np.random.default_rng(40)
    t = np.arange(GAN_SEG) / 22050.0
    tone = np.sin(2 * np.pi * 440.0 * t) * np.exp(-4.0 * t / t[-1])
    return (0.3 * tone + 0.05 * rng.standard_normal((GAN_B, GAN_SEG))
            ).astype(np.float32)


def _jax_gan_state(gen, disc, tx):
    """JAX's GAN state of seeded trees of the init's shapes (nothing of the
    init is compiled) and its numpy trees."""
    shapes = jax.eval_shape(functools.partial(
        jax_voc.create_vocoder_state, gen, disc, tx, tx,
        segment_size=GAN_SEG, seed=0))
    gen_params, disc_params, disc_stats = (
        jax.tree_util.tree_map(jnp.asarray, random_variables(tree, seed))
        for seed, tree in enumerate((shapes.gen_params, shapes.disc_params,
                                     shapes.disc_stats), 41))
    state = jax_voc.VocoderState(
        step=jnp.zeros((), jnp.int32), gen_params=gen_params,
        gen_opt=tx.init(gen_params), disc_params=disc_params,
        disc_stats=disc_stats, disc_opt=tx.init(disc_params))
    return state, _gan_snap(state)


def _gan_snap(state):
    return jax.tree_util.tree_map(
        np.asarray, (state.gen_params, state.disc_params, state.disc_stats))


def _jax_gan_step(gen, disc, tx, state):
    """JAX's GAN step on a (4, 1) mesh: the trees after it and its
    metrics."""
    mesh = jax_mesh((4, 1), devices=jax.devices()[:4])
    step = jax_voc.make_vocoder_train_step(gen, disc, JaxMelConfig(**GAN_MEL),
                                           tx, tx, mesh=mesh)
    state, m = step(state, jnp.asarray(_gan_wavs()))
    return _gan_snap(state), {k: float(getattr(m, k)) for k in (
        "disc", "gen_adv", "feature", "mel", "gen_total")}


def _port_trees(gen_params, disc_params, disc_stats):
    return (jax_to_torch_hifigan(flatten({"params": gen_params}),
                                 tcfg_hifigan()),
            jax_to_torch_discriminator(flatten(
                {"params": disc_params, "batch_stats": disc_stats}),
                HiFiGANDiscriminator(**GAN_DISC)))


def tcfg_hifigan():
    from smart_nar_fast_tts_tpu_torch.vocoder import HiFiGANConfig
    return HiFiGANConfig(**GAN_GEN)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The port's ranks, started first, and JAX's side computed meanwhile
    (flax's dropout patched off)."""
    root = tmp_path_factory.mktemp("parallel_training")
    pre = PreprocessConfig(stats=FeatureStats(**STATS))
    jax_model, shapes = init_acoustic(_jax_config(), pre)
    variables = random_variables(shapes, seed=31)
    arrays = acoustic_arrays()
    acc_arrays = acoustic_arrays(6, microbatches=2)
    pcfg = tcfg.ModelConfig(transformer=tcfg.TransformerConfig(**WIDTHS),
                            max_seq_len=64, **EXTRACTION)
    gan = (JaxGenerator(JaxGenConfig(**GAN_GEN, tail_impl="plain")),
           JaxDiscriminator(**GAN_DISC), jax_voc.make_vocoder_optimizer(2e-4))
    gan_state, gan_initial = _jax_gan_state(*gan)
    g, d = _port_trees(*gan_initial)
    corpus = make_trainer_corpus(root / "corpus", n_utts=8, val_size=4)
    triplet = write_trainer_triplet(
        root, "fit", corpus,
        tpu={"mesh_shape": [2, 2], "mesh_axis_names": ["data", "seq"]},
        model={"tpu": {"sequence_parallel": True, "sp_axis": "seq"}},
        step={"synth_step": 2, "val_step": 2, "save_step": 3})
    ranks = Ranks(training_cases, root, dict(
        arrays=arrays, acc_arrays=acc_arrays,
        acoustic=jax_to_torch_acoustic(flatten(variables), pcfg),
        gan=dict(gen_config=GAN_GEN, disc_config=GAN_DISC, mel=GAN_MEL,
                 gen_state=g, disc_state=d, wavs=_gan_wavs()),
        triplet=triplet, stats=os.path.join(corpus, "stats.json")))

    jloss = JaxLoss(pre)
    tx = jax_make_optimizer(OptimizerConfig(), WIDTHS["encoder_hidden"])
    key = jax.random.PRNGKey(1)
    jax_side = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_nn.Dropout, "__call__",
                   lambda self, x, *args, **kwargs: x)
        mp.delenv("SMART_TTS_PALLAS", raising=False)
        # JAX's step body (training/step.py:_make_step_fn there) on the
        # global batch: gradients of each microbatch, the BatchNorm
        # statistics carried from one to the next, then optax
        grad_fn = jax.jit(jax.grad(
            lambda p, stats, b: _forward_loss(jax_model, jloss, p, stats, b,
                                              key, True), has_aux=True))
        update = jax.jit(tx.update)
        for name, acc, a in (("dp", 1, arrays), ("acc", 2, acc_arrays)):
            grads, stats, losses = [], variables["batch_stats"], []
            for i in range(acc):
                mb = JaxBatch(**{k: jnp.asarray(np.split(v, acc)[i])
                                 for k, v in a.items()})
                g, (lb, stats, _) = grad_fn(variables["params"], stats, mb)
                grads.append(g)
                losses.append(lb)
            mean = jax.tree_util.tree_map(lambda *x: sum(x) / acc, *grads)
            updates, _ = update(mean, tx.init(variables["params"]),
                                variables["params"])
            params = jax.tree_util.tree_map(jnp.add, variables["params"],
                                            updates)
            jax_side[name] = dict(
                losses=jax.tree_util.tree_map(lambda *x: sum(x) / acc,
                                              *losses),
                grads=jax_params_to_torch(flatten({"params": mean}), pcfg),
                params=jax_params_to_torch(flatten({"params": params}), pcfg),
                bn=stats)
        flat = jax_mesh((4,), ("data",), devices=jax.devices()[:4])
        batch = JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
        jax_side["eval"] = jax_eval_step(jax_model, jloss, mesh=flat)(
            jax_create_state(variables, tx),
            jax.device_put(batch, batch_sharding(flat)))
    gan_after, gan_metrics = _jax_gan_step(*gan, gan_state)
    jax_side["gan"] = (_port_trees(*gan_after), gan_metrics)
    return ranks.wait(), jax_side, root


def _check_losses(got, expect):
    for name, value in got.items():
        np.testing.assert_allclose(value, float(getattr(expect, name)),
                                   rtol=LOSS_RTOL, err_msg=name)


def _check_grads(got, want):
    scale = max(float(np.abs(g.numpy()).max()) for g in want.values())
    for name, g in got.items():
        np.testing.assert_allclose(g, want[name].numpy(),
                                   atol=2e-5 * max(scale, 1.0), rtol=2e-3,
                                   err_msg=name)


@pytest.mark.parametrize("case", ["dp", "acc", "tail"])
def test_data_parallel_step_matches_jax(run, case):
    """``tail`` is the DP step on a (2, 2) data × model mesh, held to the
    same global-batch step as ``dp``."""
    results, jax_side, _ = run
    want = jax_side["dp" if case == "tail" else case]
    for res in results:
        # every rank holds the same parameters after the update
        for name, p in res[case]["params"].items():
            np.testing.assert_array_equal(
                p, results[0][case]["params"][name], err_msg=name)
        got = res[case]
        _check_losses(got["losses"], want["losses"])
        _check_grads(got["grads"], want["grads"])
        for name, p in got["params"].items():
            np.testing.assert_allclose(p, want["params"][name].numpy(),
                                       atol=PARAM_ATOL, err_msg=name)
        for i, (mean, var) in enumerate(got["bn"]):
            s = want["bn"]["postnet"][f"bn_{i}"]
            np.testing.assert_allclose(mean, np.asarray(s["mean"]),
                                       atol=BN_ATOL)
            np.testing.assert_allclose(var, np.asarray(s["var"]),
                                       atol=BN_ATOL)
    # make_train_step is those two halves
    for name, p in results[0]["step"].items():
        np.testing.assert_array_equal(p, results[0]["acc"]["params"][name])


@pytest.mark.parametrize("case", ["sp", "hybrid"])
def test_sequence_parallel_step_matches_jax(run, case):
    """Against JAX's global-batch step, to which JAX's own tests hold its
    SP and hybrid steps at this bar (``tests/test_sequence_parallel.py``)."""
    results, jax_side, _ = run
    want = jax_side["dp"]
    first = results[0][case]["grads"]
    for res in results:
        _check_losses(res[case]["losses"], want["losses"])
        _check_grads(res[case]["grads"], want["grads"])
        for name, g in res[case]["grads"].items():
            # replicas of the decoder around the ring: the same gradient
            np.testing.assert_array_equal(g, first[name], err_msg=name)


def test_data_parallel_eval_step_matches_jax(run):
    results, jax_side, _ = run
    losses, weights = jax_side["eval"]
    for res in results:
        _check_losses(res["eval"]["losses"], losses)
        for name, w in res["eval"]["weights"].items():
            assert w == float(getattr(weights, name)), name


def test_data_parallel_gan_step_matches_jax(run):
    results, jax_side, _ = run
    (want_g, want_d), metrics = jax_side["gan"]
    for res in results:
        for k, v in res["gan"]["metrics"].items():
            np.testing.assert_allclose(v, metrics[k], rtol=GAN_RTOL,
                                       err_msg=k)
        for got, want in ((res["gan"]["gen"], want_g),
                          (res["gan"]["disc"], want_d)):
            assert got.keys() == want.keys()
            for name in want:
                np.testing.assert_allclose(got[name].numpy(),
                                           want[name].numpy(),
                                           atol=PARAM_ATOL, err_msg=name)


def test_trainer_fit_on_data_seq_mesh(run):
    results, _, root = run
    for res in results:
        fit = res["fit"]
        assert fit["step"] == 2 and fit["sp"]
        # no rank returns before the first one's checkpoints are written
        assert fit["saved"] == [1, 2]
        assert fit["mesh"] == {"data": 2, "seq": 2}
        np.testing.assert_array_equal(fit["params"],
                                      results[0]["fit"]["params"])
    out = root / "fit"
    # one writer: an event file per split, one log, the checkpoints of
    # steps 1 (the first save) and 2 (the last step, saved after the loop)
    for split in ("train", "val"):
        assert len(glob.glob(str(out / "log" / split / "events.*"))) == 1
    assert sorted(os.listdir(out / "ckpt")) == ["1", "2"]
    lines = (out / "log" / "train" / "log.txt").read_text().splitlines()
    assert [ln.split(",")[0] for ln in lines] == ["Step 1/2", "Step 2/2"]
