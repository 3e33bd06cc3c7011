"""The port's training CLIs on the CPU (``--device cpu``).

- ``cli.train`` for 2 steps on the synthetic corpus of
  ``tests/test_trainer.py`` (a tiny model, 4 train and 2 val utterances),
  then again from ``--restore_step 2`` to 3, then ``cli.evaluate`` of step
  3: its losses equal ``weighted_average`` over the val split for the
  restored state, and its message is printed.  ``--distributed`` without
  torchrun's environment and a missing ``--restore_step`` are refused.
- ``cli.train_vocoder --debug_tiny`` for 2 GAN steps on two wavs (one at
  16 kHz, resampled): ``generator_2.pth.tar`` (``{"generator":
  state_dict}``), ``config.json`` and ``meta.json`` written; the port's
  ``load_vocoder`` reads the checkpoint back to the trained generator, and
  the JAX package's ``load_hifigan`` reads it to the same waveform within
  1e-4 (the HiFi-GAN parity tolerance of ``tests/test_torch_hifigan.py``).
  An unknown family, a warm start from another family's checkpoint and a
  missing one raise (the families and ``.msgpack`` warm starts are held in
  ``tests/test_torch_vocoder_checkpoint.py``).
- The new modules and CLIs import, and ``cli.evaluate`` runs, in a process
  where ``tensorboard``, ``matplotlib``, ``yaml``, ``jax``, ``flax`` and the
  JAX package cannot be imported (the card's machine has none of them).
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from smart_nar_fast_tts_tpu.vocoder import convert as jax_convert
from smart_nar_fast_tts_tpu.vocoder import hifigan_infer
from smart_nar_fast_tts_tpu_torch.cli import evaluate as evaluate_cli
from smart_nar_fast_tts_tpu_torch.cli import train as train_cli
from smart_nar_fast_tts_tpu_torch.cli import train_vocoder as vocoder_cli
from smart_nar_fast_tts_tpu_torch.config import Config
from smart_nar_fast_tts_tpu_torch.training import (CheckpointManager,
                                                   weighted_average)
from smart_nar_fast_tts_tpu_torch.vocoder import load_vocoder
from torch_port_util import (REPO, make_trainer_corpus, one_torch_thread,
                             write_trainer_triplet, write_upstream_hifigan)

WAV_ATOL = 1e-4
BLOCKED = ("tensorboard", "matplotlib", "yaml", "jax", "flax",
           "smart_nar_fast_tts_tpu")
NEW_MODULES = ("data.dataset", "data.wavio", "training.trainer",
               "training.evaluate", "training.profiling", "training.logging",
               "training.checkpoint", "cli.train", "cli.evaluate",
               "cli.train_vocoder")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_train_cli")
    paths = write_trainer_triplet(root, "cli", make_trainer_corpus(root))
    argv = ["-p", paths[0], "-m", paths[1], "-t", paths[2], "--device",
            "cpu"]
    train_cli.main(argv + ["--total_step", "2"])
    trainer = train_cli.main(argv + ["--restore_step", "2",
                                     "--total_step", "3"])
    return paths, argv, trainer


def test_train_then_resume(trained):
    paths, _, _ = trained
    cfg = Config.from_yaml_triplet(*paths)
    # the first save (the directory empty), every save_step, the last
    assert CheckpointManager(cfg.train.ckpt_path).all_steps() == [1, 2, 3]
    with open(f"{cfg.train.log_path}/train/log.txt") as f:
        assert [line.split(",")[0] for line in f] == [
            "Step 1/2", "Step 2/2", "Step 3/3"]


def test_evaluate_cli(trained, capsys):
    paths, argv, trainer = trained
    losses = evaluate_cli.main(argv + ["--restore_step", "3"])
    assert f"Validation Step 3, Total Loss: {losses.total:.4f}" in (
        capsys.readouterr().out)
    cfg = trainer.cfg
    state, _ = CheckpointManager(cfg.train.ckpt_path).restore(
        trainer.init_state(), step=3)
    expect = weighted_average(
        trainer.eval_step, state,
        trainer.make_batcher("val.txt", pad_short="mask").batches(0))
    assert losses == expect


def test_train_cli_refuses(trained):
    _, argv, _ = trained
    with pytest.raises(RuntimeError, match="--distributed needs the "
                                           "torchrun environment"):
        train_cli.main(argv + ["--distributed"])
    with pytest.raises(FileNotFoundError, match="step 7"):
        train_cli.main(argv + ["--restore_step", "7"])


def _write_wavs(directory):
    os.makedirs(directory / "sub")
    t = np.arange(6000) / 22050.0
    wavfile.write(str(directory / "a.wav"), 22050, (
        0.5 * np.sin(2 * np.pi * 220.0 * t) * 32767).astype(np.int16))
    t = np.arange(4000) / 16000.0
    wavfile.write(str(directory / "sub" / "b.wav"), 16000, (
        0.3 * np.sin(2 * np.pi * 330.0 * t) * 32767).astype(np.int16))


def test_train_vocoder_cli(tmp_path, capsys):
    _write_wavs(tmp_path / "wavs")
    out = tmp_path / "voc"
    res = vocoder_cli.main([
        "--wav_dir", str(tmp_path / "wavs"), "--steps", "2",
        "--batch_size", "2", "--segment_size", "512", "--save_every", "2",
        "--log_every", "1", "--debug_tiny", "--out_dir", str(out),
        "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "2 wavs" in printed and "step 2: disc=" in printed
    assert sorted(os.listdir(out)) == ["config.json", "generator_2.pth.tar",
                                       "meta.json"]
    with open(out / "config.json") as f:
        config = json.load(f)
    assert config["family"] == "hifigan" and config["num_mels"] == 8
    with open(out / "meta.json") as f:
        meta = json.load(f)
    assert meta["steps_completed"] == 2 and meta["device"] == "cpu"
    assert set(meta["final_losses"]) == {"disc", "gen_total", "mel"}
    raw = torch.load(out / "generator_2.pth.tar", weights_only=True)
    assert list(raw) == ["generator"]

    ckpt = str(out / "generator_2.pth.tar")
    gen = load_vocoder(ckpt)
    trained_sd = res["state"].generator.state_dict()
    for k, v in gen.state_dict().items():
        assert torch.equal(v, trained_sd[k]), k
    mel = (np.random.RandomState(4).randn(1, 12, 8) - 5.0).astype(
        np.float32)
    with torch.no_grad():
        got = gen(torch.from_numpy(mel)).numpy()
    jgen, variables = jax_convert.load_hifigan(ckpt)
    expect = np.asarray(hifigan_infer(jgen, variables, jnp.asarray(mel),
                                      max_wav_value=1.0))
    assert got.shape == expect.shape == (1, 12 * 8)
    np.testing.assert_allclose(got, expect, atol=WAV_ATOL, rtol=0)


@pytest.mark.parametrize("extra, error, match", [
    (["--generator", "wavenet"], SystemExit, "2"),
    (["--generator", "vocos", "--restore_generator", "hifigan"],
     RuntimeError, "state_dict"),
    (["--restore_generator", "missing.msgpack"], FileNotFoundError,
     "missing.msgpack"),
])
def test_train_vocoder_refuses(tmp_path, extra, error, match):
    """Every family trains now; an unknown one is an argparse error, and a
    warm start from another family's checkpoint or a missing file
    raises."""
    _write_wavs(tmp_path / "wavs")
    if "hifigan" in extra:
        extra = extra[:-1] + [write_upstream_hifigan(tmp_path / "voc")]
    with pytest.raises(error, match=match):
        vocoder_cli.main(["--wav_dir", str(tmp_path / "wavs"),
                          "--debug_tiny", "--device", "cpu",
                          "--out_dir", str(tmp_path / "out")] + extra)


def test_without_tensorboard_yaml_or_jax(trained):
    _, argv, _ = trained
    code = ("import runpy, sys\n"
            f"for name in {BLOCKED!r}:\n"
            "    sys.modules[name] = None\n"
            f"for m in {NEW_MODULES!r}:\n"
            "    __import__('smart_nar_fast_tts_tpu_torch.' + m)\n"
            "sys.argv = ['evaluate'] + sys.argv[1:]\n"
            "runpy.run_module('smart_nar_fast_tts_tpu_torch.cli.evaluate',"
            " run_name='__main__')\n")
    res = subprocess.run([sys.executable, "-c", code, *argv], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "Validation Step 3" in res.stdout
