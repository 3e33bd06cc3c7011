"""The port's synthesize CLI against the JAX package's, on the CPU.

One tiny seeded multi-speaker model (its duration predictor biased so that
an utterance lasts a few frames a phoneme) is saved twice from the same
weights: as an orbax checkpoint for the JAX CLI and as a port checkpoint
for the port's (``--device cpu``), beside one tiny upstream-layout HiFi-GAN
torch file that both CLIs load.  Both run ``--text`` and ``--source`` with
the same YAML triplet (their own checkpoint and result paths), small
``serving_mel_caps`` so that the capacity escalates, and two text buckets.
Per utterance: the ids are equal, the capacity and the durations exact, the
postnet mel within 1e-3 (the mel tolerance of the port's parity tests), and
the written wav samples within 1e-3 of full scale.  The JAX CLI is built and
run once per module.

Also: the capacity picker ``_auto_cap_forward`` on its four cases (as
``tests/test_long_form.py``), Griffin-Lim against JAX's from the same
starting phase (40 iterations, 1e-4), the PNG writer decoded back, and the
CLI run in a process where ``yaml``, ``matplotlib``, ``jax`` and the JAX
package cannot be imported (the card's machine has none of them).
"""

import os
import struct
import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from smart_nar_fast_tts_tpu.audio import stft as jax_stft
from smart_nar_fast_tts_tpu.cli import synthesize as jax_cli
from smart_nar_fast_tts_tpu.config import Config as JaxConfig
from smart_nar_fast_tts_tpu.training.checkpoint import (
    CheckpointManager as JaxCheckpointManager)
from smart_nar_fast_tts_tpu.training.schedule import make_optimizer
from smart_nar_fast_tts_tpu.training.state import (
    create_train_state as jax_train_state)
from smart_nar_fast_tts_tpu_torch.audio import stft as port_stft
from smart_nar_fast_tts_tpu_torch.cli import export as port_export
from smart_nar_fast_tts_tpu_torch.cli import synthesize as port_cli
from smart_nar_fast_tts_tpu_torch.config import Config
from smart_nar_fast_tts_tpu_torch.models import FastSpeech2Align
from smart_nar_fast_tts_tpu_torch.serving import ExportedTTS
from smart_nar_fast_tts_tpu_torch.training import (CheckpointManager,
                                                   create_train_state)
from smart_nar_fast_tts_tpu_torch.training.logging import (colorize,
                                                           save_mel_png)
from smart_nar_fast_tts_tpu_torch.weights import jax_to_torch_acoustic
from torch_port_util import (REPO, flatten, init_acoustic, random_variables,
                             write_upstream_hifigan)

MEL_ATOL = 1e-3
WAV_ATOL = 1e-3          # of full scale, in the int16 files written
GL_ATOL = 1e-4
STEP = 5
TEXT = "Hello world, this is test 42 of the port."
META = ["short|0|{HH AH0 L OW1 sp}|hello",
        "mid|2|{W ER1 L D sp DH AH0 K W IH1 K B R AW1 N}|the quick brown",
        "long|1|{DH AH0 K W IH1 K B R AW1 N F AA1 K S JH AH1 M P S OW1 V ER0"
        " DH AH0 L EY1 Z IY0 D AO1 G sp}|the quick brown fox",
        "two|1|{T UW1 sp}|two"]


def _triplet(root, name):
    pre = {"dataset": "Synthetic",
           "path": {"data_path": str(root), "lexicon_path": "",
                    "preprocessed_path": str(root / "pre")},
           "preprocessing": {
               "text": {"text_cleaners": ["english_cleaners"],
                        "language": "en"},
               "audio": {"sampling_rate": 22050, "max_wav_value": 32768.0},
               "stft": {"filter_length": 1024, "hop_length": 256,
                        "win_length": 1024},
               "mel": {"n_mel_channels": 80, "mel_fmin": 0,
                       "mel_fmax": 8000},
               "pitch": {"feature": "frame_level", "normalization": True},
               "energy": {"feature": "frame_level", "normalization": True}}}
    model = {"transformer": {
        "encoder_layer": 1, "encoder_head": 2, "encoder_hidden": 16,
        "decoder_layer": 1, "decoder_head": 2, "decoder_hidden": 16,
        "conv_filter_size": 32, "conv_kernel_size": [9, 1]},
        "variance_predictor": {"filter_size": 16, "kernel_size": 3},
        "variance_embedding": {"n_bins": 16},
        "multi_speaker": True, "n_speakers": 3, "max_seq_len": 256}
    train = {"path": {"ckpt_path": str(root / name / "ckpt"),
                      "result_path": str(root / name / "result")},
             "tpu": {"text_buckets": [8, 32],
                     "serving_mel_caps": [64, 128, 256]}}
    paths = []
    for kind, d in (("preprocess", pre), ("model", model), ("train", train)):
        path = root / f"{kind}_{name}.yaml"
        path.write_text(yaml.safe_dump(d))
        paths.append(str(path))
    return paths


def _seeded_variables(cfg):
    _, shapes = init_acoustic(cfg.model, cfg.preprocess)
    variables = random_variables(shapes, seed=23)
    # ~3 frames a phoneme, so that the text escalates past the 64-frame cap
    bias = variables["params"]["variance_adaptor"]["duration_predictor"][
        "linear_layer"]["bias"]
    bias += np.float32(np.log(4.0))
    return variables


def _save_jax_checkpoint(cfg, variables):
    tx = make_optimizer(cfg.train.optimizer,
                        cfg.model.transformer.encoder_hidden)
    state = jax_train_state(jax.tree_util.tree_map(jnp.asarray, variables),
                            tx)
    mngr = JaxCheckpointManager(cfg.train.ckpt_path)
    mngr.save(state.replace(step=jnp.asarray(STEP, jnp.int32)), force=True)
    mngr.wait()
    mngr.close()


def _save_port_checkpoint(cfg, variables):
    model = FastSpeech2Align(cfg.model, cfg.preprocess)
    model.load_state_dict(jax_to_torch_acoustic(flatten(variables),
                                                cfg.model))
    state = create_train_state(model, cfg.train.optimizer, "cpu")
    state.step = STEP
    CheckpointManager(cfg.train.ckpt_path).save(state)


def _run_jax_cli(argv):
    """The JAX CLI's main, recording each written item's model output and
    the ids it ran on."""
    records, inputs = [], []
    write, auto_cap = jax_cli._write_outputs, jax_cli._auto_cap_forward

    def recording_write(cfg, name, title, out, j, vocode):
        records.append((name, inputs[-1], out, j))
        return write(cfg, name, title, out, j, vocode)

    def recording_auto_cap(fwd_at, caps):
        fwd = auto_cap(fwd_at, caps)

        def run(*fargs):
            inputs.append(tuple(np.asarray(a) for a in fargs[2:]))
            return fwd(*fargs)
        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SMART_TTS_NO_COMPILE_CACHE", "1")
        mp.setattr(jax_cli, "_write_outputs", recording_write)
        mp.setattr(jax_cli, "_auto_cap_forward", recording_auto_cap)
        jax_cli.main(argv)
    return records


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    (root / "pre").mkdir()
    (root / "meta.txt").write_text("\n".join(META) + "\n")
    voc = write_upstream_hifigan(root / "voc", seed=2)
    jax_paths, port_paths = _triplet(root, "jax"), _triplet(root, "port")
    jax_cfg = JaxConfig.from_yaml_triplet(*jax_paths)
    variables = _seeded_variables(jax_cfg)
    _save_jax_checkpoint(jax_cfg, variables)
    port_cfg = Config.from_yaml_triplet(*port_paths)
    _save_port_checkpoint(port_cfg, variables)

    def args(paths):
        return ["-p", paths[0], "-m", paths[1], "-t", paths[2],
                "--vocoder_ckpt", voc, "--restore_step", str(STEP)]
    modes = {"text": ["--text", TEXT, "--speaker_id", "2"],
             "source": ["--source", str(root / "meta.txt"),
                        "--batch_size", "2"]}
    runs = {}
    for mode, extra in modes.items():
        runs[mode] = (_run_jax_cli(args(jax_paths) + extra),
                      port_cli.main(args(port_paths) + extra
                                    + ["--device", "cpu"]))
    return root, port_paths, runs


def _read_wav(path):
    rate, data = wavfile.read(path)
    assert rate == 22050 and data.dtype == np.int16
    return data.astype(np.float64) / 32767.0


@pytest.mark.parametrize("mode", ["text", "source"])
def test_cli_matches_jax_cli(workspace, mode):
    root, _, runs = workspace
    jax_records, utts = runs[mode]
    assert [r[0] for r in jax_records] == [u.name for u in utts]
    assert len(utts) == (1 if mode == "text" else len(META))
    for (name, (texts, src_lens, speakers), out, j), utt in zip(
            jax_records, utts):
        L = int(src_lens[j])
        np.testing.assert_array_equal(utt.ids, texts[j, :L])
        assert utt.speaker == int(speakers[j])
        assert utt.cap == out.postnet_mel.shape[1]
        np.testing.assert_array_equal(
            utt.duration, np.asarray(out.duration_rounded)[j, :L])
        assert utt.mel_len == int(out.mel_lens[j])
        n = utt.postnet_mel.shape[0]
        np.testing.assert_allclose(
            utt.postnet_mel, np.asarray(out.postnet_mel)[j, :n],
            atol=MEL_ATOL, rtol=0)
        for suffix in (".wav", ".png"):
            assert os.path.isfile(utt.base + suffix)
        theirs = _read_wav(str(root / "jax" / "result" / name) + ".wav")
        np.testing.assert_allclose(_read_wav(utt.base + ".wav"), theirs,
                                   atol=WAV_ATOL, rtol=0)
    caps = {u.cap for u in utts}
    if mode == "text":
        assert caps == {128}, "the text should escalate past 64 frames"
    else:
        assert len({u.batch[0].shape[1] for u in utts}) == 2   # 2 buckets


@pytest.mark.parametrize("case, durations, caps, expect", [
    ("short stays", [[100.0, 200.0]], [1000, 4096], [1000]),
    ("long escalates once", [[1500.0, 1000.0]], [1000, 2048, 4096],
     [1000, 4096]),
    ("past the largest fails", [[5000.0]], [1000, 4096], None),
    ("batch takes its longest", [[10.0, 20.0], [900.0, 800.0]],
     [1000, 2048], [1000, 2048]),
])
def test_auto_cap_forward(case, durations, caps, expect):
    calls = []

    class Out:
        duration_rounded = torch.tensor(durations)

    def fwd_at(cap):
        def run():
            calls.append(cap)
            return Out()
        return run

    fwd = port_cli._auto_cap_forward(fwd_at, caps)
    if expect is None:
        with pytest.raises(SystemExit, match="serving_mel_caps"):
            fwd()
    else:
        assert isinstance(fwd(), Out) and calls == expect


def test_griffin_lim_matches_jax():
    """The same starting phase (JAX's draw from PRNGKey(0)) through 40
    iterations: the waveforms agree within 1e-4 (f32 FFTs on both
    sides)."""
    cfg, tcfg = jax_stft.MelSpectrogramConfig(), \
        port_stft.MelSpectrogramConfig()
    mel = (np.random.default_rng(0).standard_normal((60, 80)) * 2 - 4)
    inv = np.linalg.pinv(np.asarray(cfg.mel_basis))
    mag = np.maximum(inv @ np.exp(mel.T), 0.0).astype(np.float32)[None]
    phase = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), mag.shape,
                                          minval=-np.pi, maxval=np.pi))
    expect = np.asarray(jax_stft.griffin_lim(jnp.asarray(mag), cfg,
                                             n_iters=40))
    got = port_stft.griffin_lim(torch.from_numpy(mag), tcfg, n_iters=40,
                                phase=torch.from_numpy(phase.copy()))
    assert got.shape == expect.shape == (1, 59 * 256)
    np.testing.assert_allclose(got.numpy(), expect, atol=GL_ATOL, rtol=0)
    seeded = port_stft.griffin_lim(torch.from_numpy(mag), tcfg, n_iters=2)
    assert torch.equal(seeded, port_stft.griffin_lim(
        torch.from_numpy(mag), tcfg, n_iters=2,
        generator=torch.Generator().manual_seed(0)))


def _decode_png(data):
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, color) == (8, 2) and b"IEND" in chunks
    raw = zlib.decompress(chunks[b"IDAT"])
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + 3 * w)
    assert not rows[:, 0].any()                      # filter type 0
    return rows[:, 1:].reshape(h, w, 3)


def test_png_writer(tmp_path):
    mel = np.random.default_rng(1).standard_normal((80, 37)).astype(
        np.float32)
    mel[0] = mel.max() + 1.0                         # channel 0 the loudest
    save_mel_png(str(tmp_path / "m.png"), mel)
    img = _decode_png((tmp_path / "m.png").read_bytes())
    assert img.shape == (80, 37, 3)
    np.testing.assert_array_equal(img, colorize(mel[::-1]))
    np.testing.assert_array_equal(img[-1], np.tile([253, 231, 37], (37, 1)))


BLOCKED = ("yaml", "matplotlib", "jax", "flax", "smart_nar_fast_tts_tpu")


def test_cli_without_yaml_matplotlib_or_jax(workspace):
    """The port's CLI in a fresh process where those modules cannot be
    imported, as on the card's machine: Griffin-Lim (no vocoder
    checkpoint) with a duration control, writing its wav and png."""
    root, paths, _ = workspace
    code = ("import runpy, sys\n"
            f"for name in {BLOCKED!r}:\n"
            "    sys.modules[name] = None\n"
            "sys.argv = ['synthesize'] + sys.argv[1:]\n"
            "runpy.run_module('smart_nar_fast_tts_tpu_torch.cli.synthesize',"
            " run_name='__main__')\n")
    argv = ["-p", paths[0], "-m", paths[1], "-t", paths[2], "--device",
            "cpu", "--text", "Griffin Lim", "--duration_control", "1.8"]
    res = subprocess.run([sys.executable, "-c", code, *argv], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    base = root / "port" / "result" / "Griffin_Lim"
    assert (base.with_suffix(".wav")).is_file()
    assert (base.with_suffix(".png")).is_file()
    assert "ckpt step 5" in res.stdout


def test_cli_refuses_what_it_cannot_run(workspace, capsys):
    _, paths, _ = workspace
    argv = ["-p", paths[0], "-m", paths[1], "-t", paths[2], "--text", "x"]
    with pytest.raises(SystemExit):
        port_cli.main(argv + ["--stream_chunk", "32", "--device", "cpu"])
    assert "--stream_chunk requires --vocoder_ckpt" in capsys.readouterr().err
    if torch.cuda.is_available():
        pytest.skip("the no-card case needs a machine without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cli.main(argv)


def test_stream_chunk_writes_the_same_wav(workspace):
    """``--stream_chunk 16`` vocodes in windows of 16 + 2·halo frames
    (``StreamingVocoder``): the same samples as the whole-mel forward
    within 1e-6 of full scale, and the same int16 file but at a rounding
    boundary (one step)."""
    root, paths, runs = workspace
    whole = runs["text"][1][0]
    wav_whole = _read_wav(whole.base + ".wav")
    argv = ["-p", paths[0], "-m", paths[1], "-t", paths[2],
            "--vocoder_ckpt", str(root / "voc" / "generator.pth.tar"),
            "--restore_step", str(STEP), "--text", TEXT, "--speaker_id", "2",
            "--device", "cpu", "--stream_chunk", "16"]
    streamed = port_cli.main(argv)[0]
    assert streamed.base == whole.base
    assert streamed.wav.shape == whole.wav.shape
    np.testing.assert_allclose(streamed.wav / 32768.0, whole.wav / 32768.0,
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(_read_wav(streamed.base + ".wav"), wav_whole,
                               atol=1.0 / 32767, rtol=0)


def test_cli_export_serves_the_checkpoint(workspace, tmp_path):
    """``cli.export`` of the workspace's port checkpoint and HiFi-GAN file
    (one text bucket, capacities 128 and 256, ``--device cpu``);
    ``ExportedTTS`` serves the ``--text`` run's ids and speaker: its
    acoustic outputs equal the checkpoint's live model on the same padded
    text at the same capacity, bit for bit; the waveform is finite and
    ``mel_len`` hops long."""
    import argparse

    from smart_nar_fast_tts_tpu_torch.cli._args import load_config
    root, paths, runs = workspace
    utt = runs["text"][1][0]
    with open(paths[2]) as f:
        train = yaml.safe_load(f)
    train["tpu"] = {"text_buckets": [40], "serving_mel_caps": [128],
                    "mel_buckets": [256]}
    train_yaml = tmp_path / "train.yaml"
    train_yaml.write_text(yaml.safe_dump(train))
    out = str(tmp_path / "artifact")
    manifest = port_export.main(
        ["-p", paths[0], "-m", paths[1], "-t", str(train_yaml),
         "--restore_step", str(STEP), "--out_dir", out, "--vocoder_ckpt",
         str(root / "voc" / "generator.pth.tar"), "--stream_chunk", "16",
         "--device", "cpu"])
    assert manifest["device"] == "cpu" and manifest["multi_speaker"]
    assert [e["mel_cap"] for e in manifest["acoustic"]] == [128, 256]
    assert [e["mel_bucket"] for e in manifest["vocoder"]] == [128, 256]
    assert manifest["provenance"]["ckpt_step"] == STEP
    tts = ExportedTTS(out, device="cpu")
    got = tts.acoustic(utt.ids, speaker=utt.speaker)
    cfg = load_config(argparse.Namespace(
        preprocess_config=paths[0], model_config=paths[1],
        train_config=str(train_yaml)))
    model, restored = port_cli.load_model(cfg, STEP, torch.device("cpu"))
    assert restored == STEP
    texts = np.zeros((1, 40), np.int64)
    texts[0, :len(utt.ids)] = utt.ids
    with torch.no_grad():
        live = model(torch.from_numpy(texts), torch.tensor([len(utt.ids)]),
                     max_mel_len=got["postnet_mel"].shape[1],
                     speakers=torch.tensor([utt.speaker]))
    for key in ("postnet_mel", "mel_lens", "duration_rounded"):
        np.testing.assert_array_equal(got[key], getattr(live, key).numpy(),
                                      key)
    wav = tts.synthesize(utt.ids, speaker=utt.speaker)
    assert wav.shape == (int(got["mel_lens"][0]) * 256,)
    assert np.isfinite(wav).all()
