"""The port's training data path against the JAX package's, on the CPU.

- ``data.wavio.load_wav``: int16, int32, uint8, float32, stereo and a
  16 kHz → 22,050 Hz resample, equal to JAX's sample for sample.
- ``data.dataset.BucketBatcher`` on the synthetic corpus of
  ``tests/test_trainer.py`` (6 train and 4 val utterances, three text and
  three mel buckets, so that items spread over buckets and get
  truncated): every array, id and raw text identical to JAX's over epochs
  0 and 1, ``skip``, ``pad_short`` "repeat" and "mask", and each host of
  ``num_hosts`` 2 under both.
- ``training.evaluate.weighted_average`` on the val split, the JAX model's
  seeded parameters carried across (``weights.jax_to_torch_acoustic``):
  equal to JAX's at rtol 1e-5 (the loss tolerance of
  ``tests/test_torch_training.py``) at batch sizes 1, 2 and 4; and
  ``tests/test_trainer.py``'s partition-invariance test on the port.
"""

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from smart_nar_fast_tts_tpu.config import Config as JaxConfig
from smart_nar_fast_tts_tpu.data import dataset as jax_dataset
from smart_nar_fast_tts_tpu.data import wavio as jax_wavio
from smart_nar_fast_tts_tpu.training import Trainer as JaxTrainer
from smart_nar_fast_tts_tpu.training.evaluate import (
    weighted_average as jax_weighted_average)
from smart_nar_fast_tts_tpu.training.step import (
    make_eval_step as jax_make_eval_step)
from smart_nar_fast_tts_tpu_torch.config import Config
from smart_nar_fast_tts_tpu_torch.data import (AcousticDataset,
                                               BucketBatcher, load_wav)
from smart_nar_fast_tts_tpu_torch.data import dataset as port_dataset
from smart_nar_fast_tts_tpu_torch.models import (FastSpeech2Align,
                                                 FastSpeech2Loss)
from smart_nar_fast_tts_tpu_torch.training import (create_train_state,
                                                   make_eval_step,
                                                   weighted_average)
from smart_nar_fast_tts_tpu_torch.weights import jax_to_torch_acoustic
from torch_port_util import (flatten, make_trainer_corpus, one_torch_thread,
                             write_trainer_triplet)

EVAL_RTOL = 1e-5
TEXT_BUCKETS, MEL_BUCKETS = (6, 8, 12), (48, 96, 128)


def _wav_cases():
    rng = np.random.default_rng(0)
    x = np.sin(np.linspace(0.0, 40.0, 1600)) * 0.8
    return {
        "int16": (22050, (x * 32767).astype(np.int16)),
        "int32": (22050, (x * 2 ** 31 * 0.99).astype(np.int32)),
        "uint8": (22050, (x * 127 + 128).astype(np.uint8)),
        "float32": (22050, (x * 0.5).astype(np.float32)),
        "stereo": (22050, (np.stack([x, rng.uniform(-1, 1, x.size)], 1)
                           * 20000).astype(np.int16)),
        "resample_16k": (16000, (x * 32767).astype(np.int16)),
    }


@pytest.mark.parametrize("case", list(_wav_cases()))
def test_load_wav_matches_jax(tmp_path, case):
    rate, data = _wav_cases()[case]
    path = str(tmp_path / f"{case}.wav")
    wavfile.write(path, rate, data)
    got, got_sr = load_wav(path, 22050)
    expect, expect_sr = jax_wavio.load_wav(path, 22050)
    assert got_sr == expect_sr == 22050 and got.dtype == np.float32
    np.testing.assert_array_equal(got, expect)
    if case == "resample_16k":
        assert len(got) == 2205


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_dataset")
    pre = make_trainer_corpus(root, n_utts=10, val_size=4)
    paths = write_trainer_triplet(root, "cfg", pre)
    return (JaxConfig.from_yaml_triplet(*paths),
            Config.from_yaml_triplet(*paths))


BATCHER_CASES = {
    "repeat": dict(batch_size=3),
    "mask": dict(batch_size=4, pad_short="mask"),
    "host0": dict(batch_size=4, num_hosts=2, host_id=0),
    "host1": dict(batch_size=4, num_hosts=2, host_id=1, pad_short="mask"),
    "host1_repeat": dict(batch_size=4, num_hosts=2, host_id=1),
}


@pytest.mark.parametrize("case", list(BATCHER_CASES))
def test_bucket_batcher_matches_jax(corpus, case):
    jcfg, pcfg = corpus
    kw = dict(text_buckets=TEXT_BUCKETS, mel_buckets=MEL_BUCKETS, seed=7,
              **BATCHER_CASES[case])
    jax_b = jax_dataset.BucketBatcher(
        jax_dataset.AcousticDataset("train.txt", jcfg.preprocess), **kw)
    port_b = BucketBatcher(AcousticDataset("train.txt", pcfg.preprocess),
                           **kw)
    assert port_b.steps_per_epoch() == jax_b.steps_per_epoch()
    assert len(port_b._assignments) > 1        # several buckets
    for epoch, skip in ((0, 0), (1, 0), (1, 1)):
        got = list(port_b.batches(epoch, skip=skip))
        expect = list(jax_b.batches(epoch, skip=skip))
        assert len(got) == len(expect) > 0
        for (pb, pids, praws), (jb, jids, jraws) in zip(got, expect):
            assert pids == jids and praws == jraws
            for name in jb._fields:
                p, j = getattr(pb, name), np.asarray(getattr(jb, name))
                assert isinstance(p, torch.Tensor) and p.device.type == "cpu"
                np.testing.assert_array_equal(p.numpy(), j, err_msg=name)


@pytest.fixture(scope="module")
def eval_setup(corpus):
    """JAX's init_state() and the port's state on the same variables."""
    jcfg, pcfg = corpus
    trainer = JaxTrainer(jcfg)
    jstate = trainer.init_state()
    model = FastSpeech2Align(pcfg.model, pcfg.preprocess)
    model.load_state_dict(jax_to_torch_acoustic(flatten(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}),
        pcfg.model))
    pstate = create_train_state(model, pcfg.train.optimizer, "cpu")
    return (jax_make_eval_step(trainer.model, trainer.loss), jstate,
            make_eval_step(FastSpeech2Loss(
                pcfg.preprocess, guided_sigma=pcfg.model.guided_sigma)),
            pstate)


def _val_batchers(cfg, module, bs):
    ds = module.AcousticDataset("val.txt", cfg.preprocess)
    return module.BucketBatcher(ds, batch_size=bs,
                                text_buckets=cfg.train.text_buckets,
                                mel_buckets=cfg.train.mel_buckets,
                                pad_short="mask")


@pytest.mark.parametrize("bs", [1, 2, 4])
def test_weighted_average_matches_jax(corpus, eval_setup, bs):
    jcfg, pcfg = corpus
    jax_step, jstate, port_step, pstate = eval_setup
    port = _val_batchers(pcfg, port_dataset, bs)
    jax = _val_batchers(jcfg, jax_dataset, bs)
    got = weighted_average(port_step, pstate, port.batches(0))
    expect = jax_weighted_average(jax_step, jstate, jax.batches(0))
    assert type(got)._fields == type(expect)._fields
    np.testing.assert_allclose(np.asarray(got), np.asarray(expect),
                               rtol=EVAL_RTOL)


def test_val_loss_invariant_to_batch_partitioning(corpus, eval_setup):
    """``tests/test_trainer.py::test_val_loss_invariant_to_batch_
    partitioning`` on the port, over its 4 val items: masked padding slots
    leave the average unchanged (bs 4 against 8: the same items in one
    batch, 3e-5); smaller batches change each batch's capacities, which
    moves only the variance predictors' conv tails (bs 1 and 2, 2e-2)."""
    _, pcfg = corpus
    _, _, port_step, pstate = eval_setup
    results = {}
    for bs in (1, 2, 4, 8):
        r = weighted_average(port_step, pstate,
                             _val_batchers(pcfg, port_dataset, bs).batches(0))
        assert np.all(np.isfinite(np.asarray(r)))
        results[bs] = np.asarray(r)
    np.testing.assert_allclose(results[4], results[8], rtol=3e-5)
    np.testing.assert_allclose(results[1], results[4], rtol=2e-2)
    np.testing.assert_allclose(results[2], results[4], rtol=2e-2)


def test_empty_split_gives_none(eval_setup):
    _, _, port_step, pstate = eval_setup
    assert weighted_average(port_step, pstate, []) is None
