"""The port's serving entry point on the CPU: the bucket pick, the device
rule, a tiny synthesis, and that neither the port (serving and training)
nor ``chip_smoke.py`` imports JAX, flax or the JAX package."""

import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
from smart_nar_fast_tts_tpu_torch import config as tcfg
from smart_nar_fast_tts_tpu_torch.models import FastSpeech2Align
from smart_nar_fast_tts_tpu_torch.serving import (MEL_BUCKETS, Synthesizer,
                                                  bucket)
from smart_nar_fast_tts_tpu_torch.vocoder import (HiFiGANConfig,
                                                  HiFiGANGenerator)
from torch_port_util import REPO

PORT = os.path.join(REPO, "smart_nar_fast_tts_tpu_torch")
CHIP_SMOKE = os.path.join(REPO, "chip_smoke.py")
PROFILES = [os.path.join(REPO, f"{name}.py")
            for name in ("profile_train_step", "profile_trainer",
                         "profile_spans")]
FORBIDDEN = ("jax", "jaxlib", "flax", "smart_nar_fast_tts_tpu")

TINY = """
import sys
import torch
from smart_nar_fast_tts_tpu_torch import config as c
from smart_nar_fast_tts_tpu_torch.models import FastSpeech2Align
from smart_nar_fast_tts_tpu_torch.serving import Synthesizer
from smart_nar_fast_tts_tpu_torch.vocoder import HiFiGANConfig, HiFiGANGenerator
torch.manual_seed(0)
t = c.TransformerConfig(encoder_layer=1, encoder_hidden=32, decoder_layer=1,
                        decoder_hidden=32, conv_filter_size=64)
model = FastSpeech2Align(c.ModelConfig(transformer=t))
voc = HiFiGANGenerator(HiFiGANConfig(upsample_initial_channel=16))
synth = Synthesizer(model, voc, device="cpu", t_cap=64)
wav, mel_lens = synth.synthesize(torch.randint(1, 100, (2, 8)), [8, 5])
assert wav.shape[0] == 2 and torch.isfinite(wav).all()
from smart_nar_fast_tts_tpu_torch.data import Batch
from smart_nar_fast_tts_tpu_torch.models import FastSpeech2Loss
from smart_nar_fast_tts_tpu_torch.training import (create_train_state,
                                                   make_eval_step,
                                                   make_train_step)
cfg = c.ModelConfig(transformer=t, duration_extraction="intended",
                    duration_head_reduce="first")
state = create_train_state(FastSpeech2Align(cfg), device="cpu")
batch = Batch(torch.randint(1, 100, (2, 8)), torch.tensor([8, 5]),
              torch.randn(2, 24, 80), torch.tensor([24, 17]),
              torch.randn(2, 24), torch.randn(2, 24))
losses = make_train_step(FastSpeech2Loss())(state, batch,
                                            torch.Generator().manual_seed(0))
assert torch.isfinite(losses.total)
assert torch.isfinite(make_eval_step(FastSpeech2Loss())(state, batch)[0].total)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                    "smart_nar_fast_tts_tpu"))
print("FORBIDDEN", bad)
"""


def _tiny_parts():
    torch.manual_seed(1)
    t = tcfg.TransformerConfig(encoder_layer=1, encoder_hidden=32,
                               decoder_layer=1, decoder_hidden=32,
                               conv_filter_size=64)
    model = FastSpeech2Align(tcfg.ModelConfig(transformer=t))
    with torch.no_grad():   # ~3 frames per phoneme
        model.variance_adaptor.duration_predictor.linear_layer.bias.fill_(
            float(np.log(4.0)))
    return model, HiFiGANGenerator(HiFiGANConfig(upsample_initial_channel=16))


@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, 640, 641, 999, 1000,
                               1001, 5000])
def test_bucket_matches_bench(n):
    assert bench.MEL_BUCKETS == MEL_BUCKETS
    assert bucket(n) == bench._bucket(n)


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Synthesizer.from_committed()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Synthesizer(*_tiny_parts(), device=None)


def test_synthesize_two_stages_on_cpu():
    synth = Synthesizer(*_tiny_parts(), device="cpu", t_cap=200)
    tokens = torch.randint(1, 100, (3, 10))
    lens = torch.tensor([10, 7, 4])
    wav, mel_lens = synth.synthesize(tokens, lens)
    out = synth.stage_a(tokens, lens)
    cap = bucket(int(out.mel_lens.max()))
    assert torch.equal(mel_lens, out.mel_lens)
    assert wav.shape == (3, cap * synth.hop_length)
    assert torch.isfinite(wav).all() and wav.abs().max() <= 1.0
    expect = synth.stage_b(out.postnet_mel[:, :cap])
    torch.testing.assert_close(wav, expect, atol=0, rtol=0)
    assert synth.audio_seconds(mel_lens) == pytest.approx(
        float(mel_lens.sum()) * 256 / 22050)


def test_port_runs_without_jax_in_a_fresh_process():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", TINY], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "FORBIDDEN []" in res.stdout, res.stdout


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_import_in_port_or_chip_smoke():
    files = [CHIP_SMOKE, *PROFILES] + [os.path.join(d, f)
                            for d, _, fs in os.walk(PORT) for f in fs
                            if f.endswith(".py")]
    assert len(files) > 10
    bad = [(f, m) for f in files for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad


def test_profile_trainer_fails_without_a_card():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, PROFILES[1]], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert res.returncode != 0 and "no CUDA card" in res.stderr
    assert not os.path.exists(os.path.join(REPO, "build", "trainer_profile"))


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    # in the checkout, and in a directory holding chip_smoke.py alone
    if alone:
        shutil.copy(CHIP_SMOKE, tmp_path)
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    else:
        script, cwd = CHIP_SMOKE, REPO
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, script], capture_output=True,
                         text=True, cwd=cwd, env=env, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
