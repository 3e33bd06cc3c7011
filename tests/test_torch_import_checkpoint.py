"""The port's reference-checkpoint import (``models/convert.py``,
``cli/import_checkpoint.py``) against the JAX package's, on the CPU.

A tiny seeded JAX model (1 + 1 layers, hidden 32) is written in the
reference's layout by JAX's ``variables_to_torch_state_dict``, with the
entries only a reference state dict holds (``convert.reference_buffers``:
the ``position_enc`` tables, the quantization bins, ``num_batches_tracked``).

- That state dict through ``reference_state_dict_to_port``: the port's
  inference within 1e-3 of JAX's ``model.apply`` in mel and postnet mel,
  the durations exact (the mel tolerance of the port's parity tests).
- ``port_state_dict_to_reference`` equals JAX's
  ``variables_to_torch_state_dict`` key for key, bit for bit; on a
  multi-speaker config it adds ``speaker_emb.weight``, which JAX's leaves
  out.
- The same ``12345.pth.tar`` through the JAX CLI (restored by orbax) and
  the port's CLI (``--device cpu``, restored by the port's manager): step
  12345 in both, the port's ``data.json``, mels within 1e-3.
- The port's CLI on ``--step``, a bare state dict, a removed key
  (``missing=``), an added key (``extra=``), a changed shape, and a
  multi-speaker model with and without its speaker table.
- Both new CLIs import where ``jax``, ``flax``, ``yaml`` and the JAX
  package cannot (the card's machine has none of them).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_nar_fast_tts_tpu.cli import import_checkpoint as jax_cli
from smart_nar_fast_tts_tpu.config import Config as JaxConfig
from smart_nar_fast_tts_tpu.models.convert import (
    variables_to_torch_state_dict)
from smart_nar_fast_tts_tpu.training.checkpoint import (
    CheckpointManager as JaxCheckpointManager)
from smart_nar_fast_tts_tpu.training.schedule import make_optimizer
from smart_nar_fast_tts_tpu.training.state import (
    create_train_state as jax_train_state)
from smart_nar_fast_tts_tpu_torch.cli import import_checkpoint as port_cli
from smart_nar_fast_tts_tpu_torch.config import Config
from smart_nar_fast_tts_tpu_torch.models import FastSpeech2Align
from smart_nar_fast_tts_tpu_torch.models.convert import (
    port_state_dict_to_reference, reference_buffers,
    reference_state_dict_to_port)
from smart_nar_fast_tts_tpu_torch.training import (CheckpointManager,
                                                   create_train_state)
from torch_port_util import (REPO, init_acoustic,  # noqa: F401
                             one_torch_thread, random_variables,
                             write_trainer_triplet)

MEL_ATOL = 1e-3
STEP = 12345
MAX_LEN = 64
MULTI = {"multi_speaker": True, "n_speakers": 3}


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """The triplets, the seeded JAX variables, JAX's jitted inference and
    its output, and the reference-layout state dict."""
    root = tmp_path_factory.mktemp("import")
    pre = root / "pre"
    pre.mkdir()
    (pre / "stats.json").write_text(json.dumps(
        {"pitch": [-2.0, 3.0, 200.0, 40.0], "energy": [-1.5, 4.0, 20.0,
                                                       10.0]}))
    jax_paths = write_trainer_triplet(root, "jax", str(pre))
    port_paths = write_trainer_triplet(root, "port", str(pre))
    jcfg = JaxConfig.from_yaml_triplet(*jax_paths)
    cfg = Config.from_yaml_triplet(*port_paths)
    model, shapes = init_acoustic(jcfg.model, jcfg.preprocess)
    variables = random_variables(shapes, seed=31)
    # ~3 frames a phoneme
    variables["params"]["variance_adaptor"]["duration_predictor"][
        "linear_layer"]["bias"] += np.float32(np.log(4.0))
    rng = np.random.RandomState(5)
    texts = rng.randint(2, 300, (2, 12)).astype(np.int32)
    src_lens = np.array([12, 8], np.int32)
    apply = jax.jit(lambda v: model.apply(
        v, jnp.asarray(texts), jnp.asarray(src_lens), max_mel_len=MAX_LEN,
        deterministic=True))
    ref_sd = {**variables_to_torch_state_dict(variables, jcfg.model),
              **reference_buffers(cfg.model, cfg.preprocess)}
    return dict(root=root, pre=str(pre), jax_paths=jax_paths,
                port_paths=port_paths, jcfg=jcfg, cfg=cfg,
                variables=variables, apply=apply, want=apply(variables),
                texts=texts, src_lens=src_lens, ref_sd=ref_sd)


def _port_forward(model, ws):
    with torch.no_grad():
        return model.eval()(torch.from_numpy(ws["texts"]),
                            torch.from_numpy(ws["src_lens"]),
                            max_mel_len=MAX_LEN)


def _check_output(got, want):
    np.testing.assert_array_equal(got.duration_rounded.numpy(),
                                  np.asarray(want.duration_rounded))
    assert int(got.mel_lens.min()) > 0
    for name in ("mel", "postnet_mel"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=MEL_ATOL, err_msg=name)


def _save(path, sd, wrap=True):
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    torch.save({"model": sd, "optimizer": {"state": {}, "param_groups": []}}
               if wrap else sd, str(path))
    return str(path)


def _argv(path, paths, *extra):
    return ["--torch_ckpt", path, "-p", paths[0], "-m", paths[1], "-t",
            paths[2], "--device", "cpu", *extra]


def _restore(paths, step=None):
    cfg = Config.from_yaml_triplet(*paths)
    state = create_train_state(FastSpeech2Align(cfg.model, cfg.preprocess),
                               cfg.train.optimizer, "cpu")
    return CheckpointManager(cfg.train.ckpt_path).restore(state, step)


def test_reference_state_dict_to_port_matches_jax(ws):
    cfg = ws["cfg"]
    sd = reference_state_dict_to_port(ws["ref_sd"], cfg.model)
    assert not set(sd) & set(reference_buffers(cfg.model, cfg.preprocess))
    model = FastSpeech2Align(cfg.model, cfg.preprocess)
    model.load_state_dict(sd)
    _check_output(_port_forward(model, ws), ws["want"])


@pytest.mark.parametrize("multi", [False, True])
def test_port_state_dict_to_reference_matches_jax(ws, tmp_path, multi):
    if multi:
        paths = write_trainer_triplet(tmp_path, "m", ws["pre"], model=MULTI)
        jcfg = JaxConfig.from_yaml_triplet(*paths)
        cfg = Config.from_yaml_triplet(*paths)
        _, shapes = init_acoustic(jcfg.model, jcfg.preprocess)
        variables = random_variables(shapes, seed=32)
    else:
        jcfg, cfg, variables = ws["jcfg"], ws["cfg"], ws["variables"]
    want = variables_to_torch_state_dict(variables, jcfg.model)
    model = FastSpeech2Align(cfg.model, cfg.preprocess)
    full = {**want}
    if multi:
        full["speaker_emb.weight"] = np.asarray(
            variables["params"]["speaker_emb"]["embedding"])
    model.load_state_dict(reference_state_dict_to_port(full, cfg.model))
    got = port_state_dict_to_reference(model.state_dict(), cfg.model)
    assert set(got) == set(want) | ({"speaker_emb.weight"} if multi
                                    else set())
    for k, v in full.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_cli_matches_jax_cli(ws):
    path = _save(ws["root"] / f"{STEP}.pth.tar", ws["ref_sd"])
    jcfg = ws["jcfg"]
    jax_cli.main(["--torch_ckpt", path, "-p", ws["jax_paths"][0], "-m",
                  ws["jax_paths"][1], "-t", ws["jax_paths"][2]])
    tx = make_optimizer(jcfg.train.optimizer,
                        jcfg.model.transformer.encoder_hidden)
    template = jax_train_state(jax.tree_util.tree_map(
        jnp.asarray, ws["variables"]), tx)
    mngr = JaxCheckpointManager(jcfg.train.ckpt_path)
    jstate, _ = mngr.restore(template)
    mngr.close()
    assert int(np.asarray(jstate.step)) == STEP
    want = ws["apply"]({"params": jstate.params,
                        "batch_stats": jstate.batch_stats})

    assert port_cli.main(_argv(path, ws["port_paths"])) == STEP
    state, data = _restore(ws["port_paths"])
    assert state.step == STEP
    assert data == {"epoch": 0, "in_epoch": 0, "imported": True}
    assert len(state.optimizer.state) == 0          # a fresh AdamW
    _check_output(_port_forward(state.model, ws), want)


def _mutate(ref_sd, case):
    sd = dict(ref_sd)
    if case == "removed":
        del sd["mel_linear.bias"]
    elif case == "added":
        sd["mel_linear.scale"] = np.ones(3, np.float32)
    elif case == "shape":
        sd["mel_linear.bias"] = np.zeros(81, np.float32)
    return sd


REFUSED = {"removed": "missing=['mel_linear.bias'] extra=[]",
           "added": "missing=[] extra=['mel_linear.scale']",
           "shape": "[('mel_linear.bias', (81,), (80,))]",
           "multi_no_table": "missing=['speaker_emb.weight'] extra=[]"}


@pytest.mark.parametrize("case", list(REFUSED))
def test_cli_refuses_a_mismatched_file(ws, tmp_path, case):
    paths = write_trainer_triplet(tmp_path, case, ws["pre"],
                                  model=MULTI if case.startswith("multi")
                                  else None)
    path = _save(tmp_path / "100.pth.tar", _mutate(ws["ref_sd"], case))
    with pytest.raises(SystemExit) as exc:
        port_cli.main(_argv(path, paths))
    # a string code: the process exits with status 1
    assert isinstance(exc.value.code, str) and REFUSED[case] in \
        exc.value.code
    assert not os.path.exists(Config.from_yaml_triplet(
        *paths).train.ckpt_path)


@pytest.mark.parametrize("case", ["step_flag", "bare", "multi"])
def test_cli_cases(ws, tmp_path, case):
    paths = write_trainer_triplet(tmp_path, case, ws["pre"],
                                  model=MULTI if case == "multi" else None)
    cfg = Config.from_yaml_triplet(*paths)
    if case == "multi":
        torch.manual_seed(3)
        source = FastSpeech2Align(cfg.model, cfg.preprocess).state_dict()
        sd = {**port_state_dict_to_reference(source, cfg.model),
              **reference_buffers(cfg.model, cfg.preprocess)}
    else:
        sd = ws["ref_sd"]
    path = _save(tmp_path / "ckpt_777.pth.tar", sd, wrap=case != "bare")
    extra = ["--step", "42"] if case == "step_flag" else []
    step = 42 if case == "step_flag" else 777
    assert port_cli.main(_argv(path, paths, *extra)) == step
    state, _ = _restore(paths, step)
    assert state.step == step
    if case == "multi":
        got = state.model.state_dict()
        assert got.keys() == source.keys()
        for k in source:
            assert torch.equal(got[k], source[k]), k
    else:
        _check_output(_port_forward(state.model, ws), ws["want"])


def test_clis_import_without_jax():
    blocked = ("jax", "flax", "yaml", "smart_nar_fast_tts_tpu")
    code = (f"import sys\nfor n in {blocked!r}:\n    sys.modules[n] = None\n"
            "import smart_nar_fast_tts_tpu_torch.cli.import_checkpoint\n"
            "import smart_nar_fast_tts_tpu_torch.cli.train_g2p\n"
            "import smart_nar_fast_tts_tpu_torch.models.convert\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
