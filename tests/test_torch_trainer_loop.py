"""The port's fit loop (``training/trainer.py``) on the CPU, on the corpus
and tiny model of ``tests/test_torch_trainer.py`` (which holds the loop
against the JAX trainer):

- a run stopped at step 2 (the end of an epoch) and resumed to step 3 is
  bit-equal to one that ran 3 steps straight, parameters, BatchNorm statistics and Adam moments,
  with dropout on (its generator re-seeded from (seed, step));
- the NaN guard raises ``FloatingPointError``; SIGTERM stops the loop after
  the current step and saves it;
- ``steps_per_dispatch`` K > 1: checked as JAX checks it, the cadences and
  saves after each group of K, as ``tests/test_trainer.py``'s K-step run;
  ``configs/scaled/train.yaml`` (K 20) loads;
- without a process group, a sequence-parallel model raises naming
  torchrun and a mesh tail larger than the world raises JAX's message;
  without ``device="cpu"`` the trainer needs a card;
- with ``train.vocoder_ckpt``, each sample is vocoded into the event file.
"""

import dataclasses
import os
import signal

import pytest
import torch

from smart_nar_fast_tts_tpu_torch.config import Config, FeatureStats
from smart_nar_fast_tts_tpu_torch.training import CheckpointManager, Trainer
from torch_port_util import (REPO, make_trainer_corpus, one_torch_thread,
                             write_trainer_triplet, write_upstream_hifigan)


# a HiFi-GAN narrower than the tests' TINY_HIFIGAN (hop 8): the samples
# only need a vocoder of 80 mels
NARROW_HIFIGAN = {"resblock": "1", "upsample_rates": [4, 2],
                  "upsample_kernel_sizes": [8, 4],
                  "upsample_initial_channel": 16,
                  "resblock_kernel_sizes": [3],
                  "resblock_dilation_sizes": [[1, 2]], "num_mels": 80,
                  "sampling_rate": 22050}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_trainer_loop")
    return root, make_trainer_corpus(root)


def _params(state):
    return {k: v.clone() for k, v in state.model.state_dict().items()}


def test_resume_is_bit_equal(corpus):
    root, pre = corpus
    straight = Config.from_yaml_triplet(*write_trainer_triplet(
        root, "straight", pre, step={"val_step": 10, "synth_step": 10}))
    parted = Config.from_yaml_triplet(*write_trainer_triplet(
        root, "parted", pre, step={"val_step": 10, "synth_step": 10}))
    want = Trainer(straight, device="cpu").fit(total_steps=3)
    Trainer(parted, device="cpu").fit(total_steps=2)
    got = Trainer(parted, device="cpu").fit(total_steps=3)
    assert got.step == want.step == 3
    a, b = _params(want), _params(got)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    sa, sb = want.optimizer.state_dict(), got.optimizer.state_dict()
    for i, s in sa["state"].items():
        for name, value in s.items():
            assert torch.equal(value, sb["state"][i][name]), (i, name)
    # dropout was on: the masks moved the parameters off a dropout-free run
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Trainer, "_dropout_generator", lambda self, step: None)
        quiet = Config.from_yaml_triplet(*write_trainer_triplet(
            root, "quiet", pre, step={"val_step": 10, "synth_step": 10}))
        no_dropout = Trainer(quiet, device="cpu").fit(total_steps=3)
    assert any(not torch.equal(a[k], v)
               for k, v in _params(no_dropout).items())


def test_nan_guard(corpus):
    root, pre = corpus
    cfg = Config.from_yaml_triplet(*write_trainer_triplet(root, "nan", pre))
    trainer = Trainer(cfg, device="cpu")
    step = trainer.train_step

    def nan_step(state, batch, generator):
        losses = step(state, batch, generator)
        return losses._replace(total=torch.tensor(float("nan")))
    trainer.train_step = nan_step
    with pytest.raises(FloatingPointError, match="step 1"):
        trainer.fit()


def test_sigterm_stops_and_saves(corpus):
    root, pre = corpus
    cfg = Config.from_yaml_triplet(*write_trainer_triplet(
        root, "sigterm", pre, step={"total_step": 10, "save_step": 100,
                                    "val_step": 100, "synth_step": 100}))
    trainer = Trainer(cfg, device="cpu")
    step = trainer.train_step

    def preempted(state, batch, generator):
        losses = step(state, batch, generator)
        if state.step == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return losses
    trainer.train_step = preempted
    state = trainer.fit()
    assert state.step == 3
    # the first save (step 1, the directory empty) and the forced one
    assert CheckpointManager(cfg.train.ckpt_path).all_steps() == [1, 3]
    assert signal.getsignal(signal.SIGTERM) is not None


def test_steps_per_dispatch(corpus):
    root, pre = corpus
    cfg = Config.from_yaml_triplet(*write_trainer_triplet(
        root, "k2", pre, step={"total_step": 4, "log_step": 2,
                               "synth_step": 4, "val_step": 4,
                               "save_step": 2},
        tpu={"steps_per_dispatch": 2}))
    Trainer(cfg, device="cpu").fit()
    # tests/test_trainer.py's K-step run: saves after each group of 2
    assert CheckpointManager(cfg.train.ckpt_path).all_steps() == [2, 4]
    with open(f"{cfg.train.log_path}/train/log.txt") as f:
        assert [line.split(",")[0] for line in f] == ["Step 2/4",
                                                      "Step 4/4"]
    bad = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, step=dataclasses.replace(cfg.train.step, log_step=3)))
    with pytest.raises(ValueError, match="log_step=3 must be a multiple"):
        Trainer(bad, device="cpu")
    scaled = Config.from_yaml_triplet(*(
        os.path.join(REPO, "configs", "scaled", f"{k}.yaml")
        for k in ("preprocess", "model", "train")))
    assert scaled.train.steps_per_dispatch == 20
    Trainer(scaled.with_stats(FeatureStats(
        pitch_min=-2.0, pitch_max=2.0, energy_min=-2.0, energy_max=2.0)),
        device="cpu")


ONE_DEVICE_ERRORS = {
    "model": "sequence_parallel needs a process group: launch with torchrun",
    "train": r"mesh_shape tail \(4,\) needs 4 devices per data slot but "
             "only 1 are local"}


@pytest.mark.parametrize("change", [
    {"model": {"sequence_parallel": True}},
    {"train": {"mesh_shape": (2, 4)}}])
def test_one_device(corpus, change):
    """One process, no process group: a mesh of one rank."""
    root, pre = corpus
    cfg = Config.from_yaml_triplet(*write_trainer_triplet(root, "mesh", pre))
    assert cfg.train.mesh_shape == (-1, 1)
    assert Trainer(cfg, device="cpu").mesh.shape == {"data": 1, "model": 1}
    cfg = dataclasses.replace(cfg, **{
        part: dataclasses.replace(getattr(cfg, part), **fields)
        for part, fields in change.items()})
    with pytest.raises(ValueError, match=ONE_DEVICE_ERRORS[next(iter(
            change))]):
        Trainer(cfg, device="cpu")



def test_samples_vocoded(corpus):
    """``train.vocoder_ckpt`` (an upstream-layout HiFi-GAN torch file):
    each sample's reconstruction and ground truth are vocoded into the
    event file as audio, beside the figure."""
    from tensorboard.backend.event_processing import event_accumulator
    root, pre = corpus
    voc = write_upstream_hifigan(root / "voc", NARROW_HIFIGAN, seed=2)
    cfg = Config.from_yaml_triplet(*write_trainer_triplet(
        root, "vocoded", pre, step={"total_step": 2},
        tpu={"vocoder_ckpt": voc}))
    Trainer(cfg, device="cpu").fit()
    for writer in ("train", "val"):
        acc = event_accumulator.EventAccumulator(
            f"{cfg.train.log_path}/{writer}", size_guidance={"audio": 0})
        acc.Reload()
        (figure,) = acc.Tags()["images"]
        assert sorted(acc.Tags()["audio"]) == [
            f"{figure}_reconstructed_gt", f"{figure}_synthesized"]
        for tag in acc.Tags()["audio"]:
            (clip,) = acc.Audio(tag)
            assert clip.step == 2 and clip.sample_rate == 22050
            assert clip.length_frames > 0


def test_needs_a_card_unless_asked(corpus):
    root, pre = corpus
    cfg = Config.from_yaml_triplet(*write_trainer_triplet(root, "card", pre))
    if torch.cuda.is_available():
        pytest.skip("the no-card case needs a machine without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg)
