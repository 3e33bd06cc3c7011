"""The port's weight bridge: the committed leaf indexes, the name maps, and
reading the committed ``.npz`` files without JAX.

Regenerate the indexes after a change of the JAX trees with
``python -c "import sys; sys.path.insert(0, 'tests'); import torch_port_util
as u; u.write_leaf_indexes()"`` from the repository root.
"""

import json

import numpy as np
import pytest

from benchmarks.train_flagship import load_variables_npz
from smart_nar_fast_tts_tpu.models.convert import (
    variables_to_torch_state_dict)
from smart_nar_fast_tts_tpu.config import ModelConfig
from smart_nar_fast_tts_tpu.vocoder.convert import torch_to_flax
from smart_nar_fast_tts_tpu.vocoder import HiFiGANConfig as JaxHiFiGANConfig
from smart_nar_fast_tts_tpu_torch import config as tcfg
from smart_nar_fast_tts_tpu_torch.models import FastSpeech2Align
from smart_nar_fast_tts_tpu_torch.vocoder import (HiFiGANConfig,
                                                  HiFiGANGenerator)
from smart_nar_fast_tts_tpu_torch.weights import (
    FLAGSHIP_INDEX, HIFIGAN_INDEX, acoustic_rules, hifigan_rules,
    jax_params_to_torch, jax_to_torch_acoustic, jax_to_torch_hifigan,
    load_committed)
from torch_port_util import (FLAGSHIP_NPZ, VOCODER_NPZ, flatten,
                             init_acoustic, init_hifigan, jax_leaf_index,
                             random_variables, zeros)

KINDS = {"flagship": (FLAGSHIP_INDEX, FLAGSHIP_NPZ, init_acoustic),
         "hifigan": (HIFIGAN_INDEX, VOCODER_NPZ, init_hifigan)}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_leaf_index_matches_jax_flatten_order(kind):
    with open(KINDS[kind][0]) as f:
        committed = json.load(f)["leaves"]
    assert committed == jax_leaf_index(kind)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_every_port_key_has_exactly_one_leaf(kind):
    with open(KINDS[kind][0]) as f:
        paths = [p for p, _ in json.load(f)["leaves"]]
    if kind == "flagship":
        rules = acoustic_rules()
        module = FastSpeech2Align()
    else:
        rules = hifigan_rules()
        module = HiFiGANGenerator()
    assert set(rules) == set(module.state_dict())
    used = [path for path, _ in rules.values()]
    assert len(used) == len(set(used))
    assert set(used) == set(paths)          # the MelEncoder's leaves too


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_load_committed_matches_jax_loader(kind):
    index, npz, init = KINDS[kind]
    expect = flatten(load_variables_npz(npz, zeros(init()[1])))
    got = load_committed(npz, index)
    assert list(got) == list(expect)
    for path, a in expect.items():
        assert got[path].dtype == a.dtype, path
        np.testing.assert_array_equal(got[path], a, err_msg=path)


def test_acoustic_map_matches_reference_state_dict_export():
    # the JAX package's own export to the reference's torch key space
    cfg = ModelConfig()
    variables = random_variables(init_acoustic(cfg)[1], seed=41)
    expect = variables_to_torch_state_dict(variables, cfg)
    got = jax_to_torch_acoustic(flatten(variables))
    assert set(got) == set(expect)          # the MelEncoder's keys too
    for key, t in got.items():
        np.testing.assert_array_equal(t.numpy(), expect[key], err_msg=key)


def test_multi_speaker_embedding_is_mapped():
    cfg = ModelConfig(multi_speaker=True, n_speakers=3)
    flat = flatten(random_variables(init_acoustic(cfg)[1], seed=42))
    port_cfg = tcfg.ModelConfig(multi_speaker=True, n_speakers=3)
    state = jax_to_torch_acoustic(flat, port_cfg)
    np.testing.assert_array_equal(state["speaker_emb.weight"].numpy(),
                                  flat["params/speaker_emb/embedding"])
    FastSpeech2Align(port_cfg).load_state_dict(state)


def test_hifigan_map_inverts_the_torch_import():
    # vocoder/convert.py maps an upstream torch state dict to flax; the
    # port's map must be its inverse, transposed-conv flip included
    flat = flatten(random_variables(init_hifigan()[1], seed=43))
    state = jax_to_torch_hifigan(flat, HiFiGANConfig())
    back = flatten({"params": torch_to_flax(
        {k: v.numpy() for k, v in state.items()}, JaxHiFiGANConfig())})
    assert set(back) == set(flat)
    for path, a in flat.items():
        np.testing.assert_array_equal(back[path], a, err_msg=path)


def test_load_committed_rejects_a_wrong_index(tmp_path):
    with open(HIFIGAN_INDEX) as f:
        doc = json.load(f)
    doc["leaves"][0][1] = [2]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="leaf 0"):
        load_committed(VOCODER_NPZ, bad)
