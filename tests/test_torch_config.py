"""The port's configuration against the JAX package's: its YAML reader
(``yaml_subset``, since the card's machine has no PyYAML) against
``yaml.safe_load`` on the committed configs and on what ``yaml.safe_dump``
writes, ``dataclasses.asdict`` of its ``Config`` against the JAX one's from
the same YAML triplet, the validation, and the ``stats.json`` lookup of the
CLI's ``load_config``.  Exact equality throughout."""

import argparse
import dataclasses
import json
import math
import os

import pytest
import yaml

from smart_nar_fast_tts_tpu import config as jax_config
from smart_nar_fast_tts_tpu.cli._args import load_config as jax_load_config
from smart_nar_fast_tts_tpu_torch import config as port_config
from smart_nar_fast_tts_tpu_torch import yaml_subset
from smart_nar_fast_tts_tpu_torch.cli._args import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALED = os.path.join(REPO, "configs", "scaled")
TRIPLET = [os.path.join(SCALED, f"{n}.yaml")
           for n in ("preprocess", "model", "train")]

# the kinds of YAML that tests/test_cli.py writes (yaml.safe_dump of nested
# dicts with lists, floats, booleans and paths), and more
DOCS = {
    "cli workspace": {
        "path": {"data_path": "/tmp/in", "lexicon_path": "/tmp/x.txt"},
        "preprocessing": {"val_size": 2, "text": {
            "text_cleaners": ["english_cleaners"], "language": "en"},
            "audio": {"sampling_rate": 22050, "max_wav_value": 32768.0},
            "mel": {"mel_fmin": 0, "mel_fmax": 8000}},
        "transformer": {"conv_kernel_size": [9, 1],
                        "encoder_dropout": 0.2},
        "optimizer": {"betas": [0.9, 0.98], "eps": 1e-9,
                      "anneal_steps": [], "anneal_rate": 1.0},
        "multi_speaker": False, "vocoder_ckpt": None},
    "scalars": {"a": "1e-9", "b": "yes", "c": "", "d": "a: b", "e": "#x",
                "f": -3, "g": float("inf"), "h": "it's", "i": "007",
                "j": "x\ty", "k": True, "l": "null", "m": 1.5e-300},
    "nesting": {"list of maps": [{"a": 1, "b": [1, 2]}, {"c": "d"}],
                "nested lists": [[1, 2], [], ["x"]], "empty map": {},
                "deep": {"x": {"y": {"z": [0.5]}}}},
}


@pytest.mark.parametrize("path", TRIPLET, ids=os.path.basename)
def test_yaml_subset_reads_the_committed_configs(path):
    with open(path) as f:
        assert yaml_subset.load(path) == yaml.safe_load(f)


@pytest.mark.parametrize("style", [False, None])
@pytest.mark.parametrize("name", sorted(DOCS))
def test_yaml_subset_reads_safe_dump(name, style):
    text = yaml.safe_dump(DOCS[name], default_flow_style=style)
    assert yaml_subset.loads(text) == yaml.safe_load(text)


def test_yaml_subset_hand_written():
    text = ("# a comment\nkey: 'quoted # not a comment'  # a comment\n"
            "flow: [1, 'two', \"three\", {a: 1}]\nbools: [True, off, No]\n"
            "seq:\n  - 1\n  -   - 2\n      - 3\n  - k: v\n    w: [x]\n"
            "nulls: [~, null]\nfloat: 0.000000001\nempty:\n")
    got = yaml_subset.loads(text)
    assert got == yaml.safe_load(text)
    assert math.isclose(got["float"], 1e-9)


@pytest.mark.parametrize("text", ["a: &x 1\n", "a: |\n  text\n",
                                  "a: [1,\n  2\n", "a:\n\t- 1\n",
                                  "a: 1\n---\nb: 2\n", "a: 1\na: 2\n"])
def test_yaml_subset_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError, match="YAML line"):
        yaml_subset.loads(text)


def _write_triplet(tmp_path, p, m, t):
    paths = []
    for name, d in (("preprocess", p), ("model", m), ("train", t)):
        path = tmp_path / f"{name}.yaml"
        path.write_text(yaml.safe_dump(d))
        paths.append(str(path))
    return paths


def test_config_of_the_scaled_triplet_matches_jax():
    ours = port_config.Config.from_yaml_triplet(*TRIPLET)
    theirs = jax_config.Config.from_yaml_triplet(*TRIPLET)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.model.n_speakers == 8 and ours.model.multi_speaker
    assert ours.train.text_buckets == (24,)
    assert dataclasses.asdict(port_config.Config()) == \
        dataclasses.asdict(jax_config.Config())


def test_config_of_written_yaml_and_stats_lookup(tmp_path):
    """A triplet as tests/test_cli.py writes it, with TPU-section keys and
    a ``stats.json`` in the preprocessed path: ``from_yaml_triplet`` and
    the CLI's ``load_config`` give the JAX package's config."""
    pre_dir = tmp_path / "pre"
    pre_dir.mkdir()
    (pre_dir / "stats.json").write_text(json.dumps(
        {"pitch": [-1.5, 7.0, 180.0, 40.0], "energy": [-2.0, 3.0, 50.0, 9.0]}))
    p = {"dataset": "Synthetic",
         "path": {"preprocessed_path": str(pre_dir), "lexicon_path": ""},
         "preprocessing": {"stft": {"filter_length": 1200,
                                    "hop_length": 300, "win_length": 1200},
                           "pitch": {"feature": "phoneme_level"}}}
    m = {"transformer": {"encoder_hidden": 384, "encoder_head": 2,
                         "conv_kernel_size": [9, 1]},
         "multi_speaker": True, "n_speakers": 4,
         "tpu": {"upsampling": "hard", "duration_extraction": "intended",
                 "duration_head_reduce": "first"}}
    t = {"path": {"ckpt_path": str(tmp_path / "ckpt")},
         "optimizer": {"betas": [0.9, 0.98], "anneal_steps": [100, 200]},
         "tpu": {"serving_mel_caps": [500, 1000], "text_buckets": [16, 32]}}
    paths = _write_triplet(tmp_path, p, m, t)
    ours = port_config.Config.from_yaml_triplet(*paths)
    theirs = jax_config.Config.from_yaml_triplet(*paths)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.preprocess.stats == port_config.FeatureStats(
        -1.5, 7.0, 180.0, 40.0, -2.0, 3.0, 50.0, 9.0)
    args = argparse.Namespace(preprocess_config=paths[0],
                              model_config=paths[1], train_config=paths[2])
    assert dataclasses.asdict(load_config(args)) == \
        dataclasses.asdict(jax_load_config(args))


def test_config_validation():
    """log quantization with normalized features is refused by both."""
    ve = {"variance_embedding": {"pitch_quantization": "log"}}
    for mod in (port_config, jax_config):
        with pytest.raises(ValueError, match="pitch_quantization='log'"):
            mod.Config.from_dicts({}, ve, {})
    with pytest.raises(ValueError, match="unknown upsampling"):
        port_config.ModelConfig(upsampling="nearest")
    with pytest.raises(ValueError, match="unknown feature level"):
        port_config.PreprocessConfig(pitch_feature="word_level")
