"""The comparison fails a broken program: the harness's run on the CPU at
small sizes, its look for a card skipped, with the timed path broken
underneath, reads ``correct`` false; unbroken, true.  One case for each
fault a cell can have: an answer altered where it is produced, half of the
batch left out; for training also a step that leaves its state unchanged,
half of the batch left out with the mean taken over the rest, and the
aligner's duration targets altered where the model produces them.  (One
card: no exchange between cards to leave out.)"""

import pytest
import torch

from portbench.tests import tiny

SERVING = ["fs2_hifigan_v1.batch", "fastspeech_vocos.longform",
           "fs2_hifigan_v1.online"]


def _wrap_wave(fault):
    """A Synthesizer whose waveforms are broken by ``fault`` where they
    are produced (the vocoder's output)."""
    def wrap(synth):
        stage_b = synth.stage_b

        def broken(mel):
            return fault(stage_b(mel).clone())
        synth.stage_b = broken
        return synth
    return wrap


def _altered(wav):
    wav[0] = wav[0] * 1.001
    return wav


def _half_left_out(wav):
    wav[wav.shape[0] // 2:] = 0.0
    return wav


@pytest.mark.parametrize("workload", SERVING)
def test_serving_sound_run_correct(workload):
    assert tiny.run(workload)["correct"] is True


@pytest.mark.parametrize("fault", [_altered, _half_left_out])
@pytest.mark.parametrize("workload", SERVING)
def test_serving_fault_incorrect(workload, fault):
    r = tiny.run(workload, wrap_synth=_wrap_wave(fault))
    assert r["correct"] is False
    assert r["checks"]["wav_gap"]["value"] > r["checks"]["wav_gap"]["limit"]


def _unchanged(step):
    def broken(state, batch, gen=None):
        keep = [p.detach().clone() for p in state.params]
        out = step(state, batch, gen)
        with torch.no_grad():
            for p, k in zip(state.params, keep):
                p.copy_(k)
        return out
    return broken


def _half_batch(step):
    def broken(state, batch, gen=None):
        n = batch.texts.shape[0] // 2
        return step(state, type(batch)(*(None if t is None else t[:n]
                                         for t in batch)), gen)
    return broken


def _targets_altered(step):
    """Each item's first phoneme takes one frame more in the aligner's
    duration targets, before the variance adaptor reads them: the step
    trains on the altered targets and returns them."""
    def alter(_module, _args, kwargs):
        kwargs["duration_target"][:, 0] += 1

    def broken(state, batch, gen=None):
        hook = state.model.variance_adaptor.register_forward_pre_hook(
            alter, with_kwargs=True)
        try:
            return step(state, batch, gen)
        finally:
            hook.remove()
    return broken


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _targets_altered])
def test_training_fault_incorrect(fault):
    r = tiny.run("fs2_hifigan_v1.train", wrap_step=fault)
    assert r["correct"] is False


def test_altered_targets_fail_on_their_own_number():
    """The reference follows the program's duration targets, so the loss
    agrees and ``target_mismatch`` sees them altered."""
    c = tiny.run("fs2_hifigan_v1.train", wrap_step=_targets_altered)["checks"]
    assert c["target_mismatch"]["value"] > c["target_mismatch"]["limit"]
    assert c["loss_gap"]["value"] <= c["loss_gap"]["limit"]
