"""The port's vocoder checkpoints of every family, its flax ``.msgpack``
reader and the vocoder CLIs with Vocos and MelGAN, on the CPU.

- The committed indexes ``assets/vocos_leaves.json`` and
  ``melgan_leaves.json`` equal JAX's ``tree_flatten_with_path`` of each
  family's init at the config of its ``*_meta.json``, and name every leaf
  of the ``.npz``.
- ``vocoder/msgpack.py`` reads ``flax.serialization.to_bytes`` of narrow
  HiFi-GAN, Vocos and MelGAN parameter trees back bit-equal, and numpy
  scalars, bf16 (widened to f32), ints, bools, strings and nested maps; a
  leaf flax chunked raises, naming it.
- ``load_vocoder`` of each family in both formats (the JAX CLI's
  ``.msgpack`` and the port's ``.pth.tar``) with the ``config.json`` the
  JAX CLI writes: within 1e-5 of the JAX package's ``load_vocoder`` of the
  ``.msgpack``.
- ``cli.train_vocoder --generator vocos|melgan --debug_tiny --device cpu``
  for 2 steps, warm-started from a JAX ``.msgpack``; its checkpoint loads,
  and ``cli.synthesize --vocoder_ckpt`` on it writes a wav, with
  ``--stream_chunk`` the same one.
- An export with a narrow Vocos: ``ExportedTTS.synthesize`` equals the
  live model's acoustic output vocoded by the live Vocos, and ``stream``
  equals ``synthesize``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from smart_nar_fast_tts_tpu.vocoder import HiFiGANConfig as JaxHiFiGAN
from smart_nar_fast_tts_tpu.vocoder import MelGANConfig as JaxMelGAN
from smart_nar_fast_tts_tpu.vocoder import VocosConfig as JaxVocos
from smart_nar_fast_tts_tpu.vocoder import convert as jax_convert
from smart_nar_fast_tts_tpu_torch import weights
from smart_nar_fast_tts_tpu_torch.cli import synthesize as port_cli
from smart_nar_fast_tts_tpu_torch.cli import train_vocoder as vocoder_cli
from smart_nar_fast_tts_tpu_torch.config import Config
from smart_nar_fast_tts_tpu_torch.serving import ExportedTTS
from smart_nar_fast_tts_tpu_torch.vocoder import (load_vocoder,
                                                  read_flax_msgpack)
from smart_nar_fast_tts_tpu_torch.vocoder.convert import FAMILIES
from torch_port_util import (RESULTS, flatten, init_vocoder,
                             jax_leaf_index,
                             one_torch_thread,  # noqa: F401
                             random_variables)

WAV_ATOL = 1e-5
STEP = 5
TEXT = "Hello world, this is a test."
JAX_TINY = {"hifigan": JaxHiFiGAN(upsample_rates=(4, 2),
                                  upsample_kernel_sizes=(8, 4),
                                  upsample_initial_channel=16,
                                  resblock_kernel_sizes=(3,),
                                  resblock_dilation_sizes=((1, 2),),
                                  n_mels=8, tail_impl="plain"),
            "vocos": JaxVocos(**vocoder_cli.TINY_GENERATORS["vocos"]),
            "melgan": JaxMelGAN(**vocoder_cli.TINY_GENERATORS["melgan"])}


def _jax_tree(family, seed):
    """JAX generator and seeded params of a family's narrow config."""
    gen, shapes = init_vocoder(family, JAX_TINY[family])
    return gen, random_variables(shapes, seed)["params"]


def _write_jax_checkpoint(directory, family, seed):
    """The JAX CLI's files: ``generator_1.msgpack`` and ``config.json``
    (``{"family": ..., **config.to_dict()}``)."""
    gen, params = _jax_tree(family, seed)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "generator_1.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(params))
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump({"family": family, **gen.config.to_dict()}, f)
    return path, gen, params


@pytest.mark.parametrize("family", ["vocos", "melgan"])
def test_leaf_index_equals_jax_flatten(family):
    index = getattr(weights, f"{family.upper()}_INDEX")
    with open(index) as f:
        doc = json.load(f)
    assert doc["leaves"] == jax_leaf_index(family)
    flat = weights.load_committed(f"{RESULTS}/{family}_params.npz", index)
    assert len(flat) == {"vocos": 80, "melgan": 84}[family]


@pytest.mark.parametrize("family", ["hifigan", "vocos", "melgan"])
def test_msgpack_reads_flax_trees(family):
    _, params = _jax_tree(family, seed=61)
    got = read_flax_msgpack(serialization.to_bytes(params))
    expect = flatten({"params": params})
    assert got.keys() == expect.keys()
    for k in expect:
        assert got[k].dtype == expect[k].dtype, k
        np.testing.assert_array_equal(got[k], expect[k], err_msg=k)


def test_msgpack_value_types(monkeypatch):
    tree = {"a": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                  "i": np.arange(300, dtype=np.int64) - 150,
                  "b": jnp.asarray([1.5, -2.25], jnp.bfloat16)},
            "s": np.float32(3.5), "n": 7, "neg": -40000, "f": 0.125,
            "t": True, "e": {}, "big": np.zeros(70000, np.uint8)}
    got = {k[len("params/"):]: v for k, v in read_flax_msgpack(
        serialization.to_bytes(tree)).items()}
    assert sorted(got) == ["a/b", "a/i", "a/w", "big", "f", "n", "neg", "s",
                           "t"]
    np.testing.assert_array_equal(got["a/w"], tree["a"]["w"])
    np.testing.assert_array_equal(got["a/i"], tree["a"]["i"])
    assert got["a/b"].dtype == np.float32
    np.testing.assert_array_equal(got["a/b"], [1.5, -2.25])
    assert got["s"] == 3.5 and got["n"] == 7 and got["neg"] == -40000
    assert got["f"] == 0.125 and got["t"]
    assert got["big"].shape == (70000,)
    # flax splits a leaf above MAX_CHUNK_SIZE bytes into chunks
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    with pytest.raises(ValueError, match="'params/a/i' was chunked"):
        read_flax_msgpack(serialization.to_bytes(tree))


@pytest.fixture(scope="module")
def jax_loaded(tmp_path_factory):
    """Per family: the JAX CLI's files of a seeded narrow tree, a seeded
    mel, and the JAX package's ``load_vocoder`` waveform of that mel."""
    root = tmp_path_factory.mktemp("jax_vocoders")
    mel = (np.random.RandomState(63).randn(2, 11, 8) - 2.0).astype(
        np.float32)
    out = {}
    for family in FAMILIES:
        path, _, _ = _write_jax_checkpoint(root / family, family, seed=62)
        jax_gen, jax_vars = jax_convert.load_vocoder(path)
        out[family] = (path, np.asarray(jax.jit(jax_gen.apply)(
            jax_vars, jnp.asarray(mel))))
    return mel, out


@pytest.mark.parametrize("fmt", ["msgpack", "pth.tar"])
@pytest.mark.parametrize("family", ["hifigan", "vocos", "melgan"])
def test_load_vocoder_both_formats(jax_loaded, tmp_path, family, fmt):
    """Both files of one tree load to the JAX loader's waveform; the
    ``.pth.tar`` is the port's own save of the ``.msgpack``'s generator,
    beside the same ``config.json``."""
    mel, loaded = jax_loaded
    path, expect = loaded[family]
    if fmt == "pth.tar":
        sd = load_vocoder(path).state_dict()
        path = str(tmp_path / "generator_1.pth.tar")
        torch.save({"generator": sd}, path)
        with open(os.path.join(os.path.dirname(loaded[family][0]),
                               "config.json")) as f:
            (tmp_path / "config.json").write_text(f.read())
    gen = load_vocoder(path)
    assert isinstance(gen, FAMILIES[family][1]) and not gen.training
    with torch.no_grad():
        got = gen(torch.from_numpy(mel)).numpy()
    assert got.shape == expect.shape == (2, 11 * 8)
    np.testing.assert_allclose(got, expect, atol=WAV_ATOL)


# ---------------------------------------------------------------------------
# the CLIs: a narrow acoustic model of 8 mel channels, the narrow vocoders'


def _triplet(root):
    pre = {"dataset": "Synthetic",
           "path": {"data_path": str(root), "lexicon_path": "",
                    "preprocessed_path": str(root / "pre")},
           "preprocessing": {
               "text": {"text_cleaners": ["english_cleaners"],
                        "language": "en"},
               "audio": {"sampling_rate": 22050, "max_wav_value": 32768.0},
               "stft": {"filter_length": 1024, "hop_length": 256,
                        "win_length": 1024},
               "mel": {"n_mel_channels": 8, "mel_fmin": 0,
                       "mel_fmax": 8000}}}
    model = {"transformer": {
        "encoder_layer": 1, "encoder_head": 2, "encoder_hidden": 16,
        "decoder_layer": 1, "decoder_head": 2, "decoder_hidden": 16,
        "conv_filter_size": 32, "conv_kernel_size": [9, 1]},
        "variance_predictor": {"filter_size": 16, "kernel_size": 3},
        "variance_embedding": {"n_bins": 16}, "max_seq_len": 256}
    train = {"path": {"ckpt_path": str(root / "ckpt"),
                      "result_path": str(root / "result")},
             "tpu": {"text_buckets": [32], "mel_buckets": [64, 256],
                     "serving_mel_caps": [128]}}
    paths = []
    for kind, d in (("preprocess", pre), ("model", model), ("train", train)):
        path = root / f"{kind}.yaml"
        path.write_text(yaml.safe_dump(d))
        paths.append(str(path))
    return paths


@pytest.fixture(scope="module")
def acoustic(tmp_path_factory):
    """A seeded narrow acoustic model of 8 mel channels (its duration bias
    raised: ~3 frames a phoneme) saved as a port checkpoint, its YAML
    triplet and the live model."""
    from smart_nar_fast_tts_tpu_torch.models import FastSpeech2Align
    from smart_nar_fast_tts_tpu_torch.training import (CheckpointManager,
                                                       create_train_state)
    root = tmp_path_factory.mktemp("families_cli")
    (root / "pre").mkdir()
    paths = _triplet(root)
    cfg = Config.from_yaml_triplet(*paths)
    torch.manual_seed(64)
    model = FastSpeech2Align(cfg.model, cfg.preprocess)
    with torch.no_grad():
        model.variance_adaptor.duration_predictor.linear_layer.bias += (
            float(np.log(4.0)))
    state = create_train_state(model, cfg.train.optimizer, "cpu")
    state.step = STEP
    CheckpointManager(cfg.train.ckpt_path).save(state)
    wav_dir = root / "wavs"
    wav_dir.mkdir()
    from smart_nar_fast_tts_tpu_torch.data import save_wav
    rng = np.random.RandomState(0)
    for i in range(2):
        save_wav(str(wav_dir / f"{i}.wav"),
                 rng.randn(600).astype(np.float32) * 0.1, 22050)
    argv = ["-p", paths[0], "-m", paths[1], "-t", paths[2],
            "--restore_step", str(STEP), "--device", "cpu"]
    return root, argv, model.eval(), cfg


@pytest.mark.parametrize("family", ["vocos", "melgan"])
def test_train_vocoder_then_synthesize(acoustic, family):
    root, argv, _, _ = acoustic
    warm, _, params = _write_jax_checkpoint(root / f"jax_{family}", family,
                                            seed=65)
    out = root / f"voc_{family}"
    base = ["--wav_dir", str(root / "wavs"), "--batch_size", "2",
            "--segment_size", "128", "--debug_tiny", "--generator", family,
            "--out_dir", str(out), "--device", "cpu",
            "--restore_generator", warm]
    # 0 steps: the warm start alone, from the JAX CLI's .msgpack
    res = vocoder_cli.main(base + ["--steps", "0"])
    expect = getattr(weights, f"jax_to_torch_{family}")(
        flatten({"params": params}), res["state"].generator.config)
    for k, v in res["state"].generator.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), expect[k].numpy(), k)
    res = vocoder_cli.main(base + ["--steps", "2", "--save_every", "2",
                                   "--log_every", "1"])
    assert sorted(os.listdir(out)) == ["config.json", "generator_2.pth.tar",
                                       "meta.json"]
    config = json.loads((out / "config.json").read_text())
    assert config == {"family": family,
                      **res["state"].generator.config.to_dict()}
    meta = json.loads((out / "meta.json").read_text())
    assert meta["family"] == family and meta["steps_completed"] == 2
    ckpt = str(out / "generator_2.pth.tar")
    gen = load_vocoder(ckpt)
    trained = res["state"].generator.state_dict()
    assert all(torch.equal(v, trained[k]) for k, v in gen.state_dict()
               .items())
    utts = port_cli.main(argv + ["--text", TEXT, "--vocoder_ckpt", ckpt])
    wav = utts[0].wav
    assert wav.shape == (utts[0].mel_len * 8,) and np.isfinite(wav).all()
    assert os.path.getsize(utts[0].base + ".wav") > 44
    with torch.no_grad():
        live = gen(torch.from_numpy(utts[0].postnet_mel[None,
                                                        :utts[0].mel_len]))
    live = live[0].numpy()
    if family == "vocos":           # vocos_infer's clip
        live = np.clip(live, -1.0, 1.0)
    np.testing.assert_allclose(wav, live * 32768.0, atol=32768.0 * 1e-6)
    streamed = port_cli.main(argv + ["--text", TEXT, "--vocoder_ckpt", ckpt,
                                     "--stream_chunk", "8"])
    np.testing.assert_allclose(streamed[0].wav, wav,
                               atol=32768.0 * WAV_ATOL)


def test_export_with_vocos(acoustic, tmp_path):
    """``export_serving_artifacts`` with a narrow seeded Vocos: the
    artifact serves the live model's samples, and streams them."""
    from smart_nar_fast_tts_tpu_torch.serving import export_serving_artifacts
    from smart_nar_fast_tts_tpu_torch.text import text_to_sequence
    from smart_nar_fast_tts_tpu_torch.text.g2p import G2P
    from smart_nar_fast_tts_tpu_torch.vocoder import (VocosConfig,
                                                      VocosGenerator)
    _, _, model, cfg = acoustic
    _, params = _jax_tree("vocos", seed=66)
    config = VocosConfig(**vocoder_cli.TINY_GENERATORS["vocos"])
    vocos = VocosGenerator(config)
    vocos.load_state_dict(weights.jax_to_torch_vocos(
        flatten({"params": params}), config))
    out = str(tmp_path / "artifact")
    manifest = export_serving_artifacts(
        out, model, text_buckets=[32], mel_buckets=[64, 256],
        mel_caps=[128], generator=vocos, stream_chunk=16, device="cpu")
    assert manifest["streaming"]["halo_frames"] == 3 + 2 * 3 + 4 + 1
    assert manifest["params"]["vocoder_leaves"] == len(
        list(vocos.parameters())) + 2               # + the iDFT bases
    tts = ExportedTTS(out, device="cpu")
    ids = np.asarray(text_to_sequence(G2P("")(TEXT),
                                      list(cfg.preprocess.text_cleaners)))
    wav = tts.synthesize(ids)
    out_a = tts.acoustic(ids)
    t = int(out_a["mel_lens"][0])
    bucket = 64 if t <= 64 else 256
    mel = np.zeros((1, bucket, 8), np.float32)
    mel[0, :t] = out_a["postnet_mel"][0, :t]
    with torch.no_grad():
        live = vocos(torch.from_numpy(mel))[0, :t * 8].numpy()
        texts = torch.zeros((1, 32), dtype=torch.long)
        texts[0, :len(ids)] = torch.from_numpy(ids)
        live_a = model(texts, torch.tensor([len(ids)]), max_mel_len=128)
    np.testing.assert_array_equal(out_a["duration_rounded"],
                                  live_a.duration_rounded.numpy())
    np.testing.assert_allclose(out_a["postnet_mel"],
                               live_a.postnet_mel.numpy(), atol=1e-5)
    assert wav.shape == (t * 8,)
    np.testing.assert_allclose(wav, live, atol=WAV_ATOL)
    streamed = np.concatenate(list(tts.stream(ids)))
    np.testing.assert_allclose(streamed, wav, atol=WAV_ATOL)
