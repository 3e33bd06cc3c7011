"""The port's spans (``smart_nar_fast_tts_tpu_torch/tracing.py``) on the
CPU: nothing is built without a profiler, the documented tree under one,
and the same outputs bit for bit with and without it."""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from smart_nar_fast_tts_tpu_torch import config as tcfg
from smart_nar_fast_tts_tpu_torch import tracing
from smart_nar_fast_tts_tpu_torch.audio import MelSpectrogramConfig
from smart_nar_fast_tts_tpu_torch.data import Batch
from smart_nar_fast_tts_tpu_torch.models import (FastSpeech2Align,
                                                 FastSpeech2Loss)
from smart_nar_fast_tts_tpu_torch.serving import Synthesizer
from smart_nar_fast_tts_tpu_torch.training import (VocoderOptimizer,
                                                   create_train_state,
                                                   create_vocoder_state,
                                                   make_train_step,
                                                   make_vocoder_train_step)
from smart_nar_fast_tts_tpu_torch.vocoder import (HiFiGANConfig,
                                                  HiFiGANGenerator)
from smart_nar_fast_tts_tpu_torch.vocoder.discriminators import \
    HiFiGANDiscriminator
from torch_port_util import REPO

ACOUSTIC = ("tts.acoustic.text_encoder", "tts.acoustic.variance",
            "tts.acoustic.decoder", "tts.acoustic.postnet")


def _transformer():
    return tcfg.TransformerConfig(encoder_layer=1, encoder_hidden=32,
                                  decoder_layer=1, decoder_hidden=32,
                                  conv_filter_size=64)


def _spans(prof) -> list[tuple[str, int, int]]:
    """The profiled ``tts.*`` ranges as (name, start, end) in start order."""
    return sorted(((e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(tracing.PREFIX)),
                  key=lambda s: (s[1], -s[2]))


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def _one(spans, name):
    got = [s for s in spans if s[0] == name]
    assert len(got) == 1, (name, [s[0] for s in spans])
    return got[0]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_off_builds_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function built with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    first = tracing.span("stage_a")
    second = tracing.span("step", tracing.call_args(1, 2, 8, 64))
    assert first is second
    with first:
        pass
    assert tracing.call_args(3, 2, 8, 64) == "call=3 B=2 L=8 T=64"


def test_on_records_the_prefixed_range():
    def run():
        with tracing.span("x", "call=1"):
            return torch.ones(3) + 1
    out, spans = _profiled(run)
    assert [s[0] for s in spans] == ["tts.x"]
    assert torch.equal(out, torch.full((3,), 2.0))


def _synth():
    torch.manual_seed(1)
    model = FastSpeech2Align(tcfg.ModelConfig(transformer=_transformer()))
    with torch.no_grad():   # ~3 frames per phoneme
        model.variance_adaptor.duration_predictor.linear_layer.bias.fill_(
            float(np.log(4.0)))
    return Synthesizer(model, HiFiGANGenerator(HiFiGANConfig(
        upsample_initial_channel=16)), device="cpu", t_cap=64)


def test_synthesize_tree_and_outputs():
    synth = _synth()
    ids, lens = torch.randint(1, 100, (2, 8)), [8, 5]
    plain = synth.synthesize(ids, lens)
    (wav, mel_lens), spans = _profiled(lambda: synth.synthesize(ids, lens))
    assert synth.calls == 2
    top = _one(spans, "tts.synthesize")
    stage_a = _one(spans, "tts.stage_a")
    bucket = _one(spans, "tts.bucket")
    stage_b = _one(spans, "tts.stage_b")
    assert all(_inside(s, top) for s in (stage_a, bucket, stage_b))
    assert stage_a[2] <= bucket[1] and bucket[2] <= stage_b[1]
    for name in ACOUSTIC:
        assert _inside(_one(spans, name), stage_a), name
    assert _inside(_one(spans, "tts.acoustic.upsample"),
                   _one(spans, "tts.acoustic.variance"))
    assert not any(s[0] == "tts.acoustic.mel_encoder" for s in spans)
    assert torch.equal(wav, plain[0]) and torch.equal(mel_lens, plain[1])


def _train_parts():
    torch.manual_seed(2)
    cfg = tcfg.ModelConfig(transformer=_transformer(),
                           duration_extraction="intended",
                           duration_head_reduce="first")
    state = create_train_state(FastSpeech2Align(cfg), device="cpu")
    g = torch.Generator().manual_seed(3)
    batch = Batch(torch.randint(1, 100, (2, 8), generator=g),
                  torch.tensor([8, 5]), torch.randn(2, 24, 80, generator=g),
                  torch.tensor([24, 17]), torch.randn(2, 24, generator=g),
                  torch.randn(2, 24, generator=g))
    return state, batch


def test_train_step_tree_and_outputs():
    state, batch = _train_parts()
    twin = copy.deepcopy(state)
    step = make_train_step(FastSpeech2Loss())
    plain = step(twin, batch, torch.Generator().manual_seed(0))
    losses, spans = _profiled(
        lambda: step(state, batch, torch.Generator().manual_seed(0)))
    top = _one(spans, "tts.step")
    phases = [_one(spans, "tts.step." + p)
              for p in ("forward", "backward", "reduce", "optimizer")]
    assert all(_inside(p, top) for p in phases)
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))
    for name in ACOUSTIC + ("tts.acoustic.mel_encoder",):
        assert _inside(_one(spans, name), phases[0]), name
    for a, b in zip(losses, plain):
        assert torch.equal(a, b)
    for p, q in zip(state.params, twin.params):
        assert torch.equal(p, q)


GEN_KW = dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
              upsample_initial_channel=16, resblock_kernel_sizes=(3,),
              resblock_dilation_sizes=((1, 2),), n_mels=8)
MEL_KW = dict(n_fft=32, hop_length=8, win_length=32, n_mels=8,
              mel_fmax=None)
DISC_KW = dict(periods=(2, 3), period_channels=(4, 8), n_scales=2,
               scale_layers=((8, 15, 1, 1), (16, 41, 4, 4), (16, 5, 1, 1)))


def test_gan_step_spans_and_outputs():
    torch.manual_seed(4)
    tx = VocoderOptimizer(2e-4)
    state = create_vocoder_state(HiFiGANGenerator(HiFiGANConfig(**GEN_KW)),
                                 HiFiGANDiscriminator(**DISC_KW), tx, tx,
                                 device="cpu")
    twin = copy.deepcopy(state)
    step = make_vocoder_train_step(MelSpectrogramConfig(**MEL_KW))
    wavs = 0.3 * torch.randn(2, 256, generator=torch.Generator()
                             .manual_seed(5))
    plain = step(twin, wavs)
    metrics, spans = _profiled(lambda: step(state, wavs))
    assert [s[0] for s in spans] == ["tts.gan.input_mel", "tts.gan.d_update",
                                     "tts.gan.g_update"]
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))
    for a, b in zip(metrics, plain):
        assert torch.equal(a, b)
    for m, n in ((state.generator, twin.generator),
                 (state.discriminator, twin.discriminator)):
        for p, q in zip(m.state_dict().values(), n.state_dict().values()):
            assert torch.equal(p, q)


@pytest.mark.parametrize("profiled", [False, True])
def test_export_holds_no_span(profiled):
    """An exported serving program has no profiler node: export runs with
    the spans off, and a span open around the export (its caller under a
    profiler) stays outside the traced graph as well."""
    synth = _synth()
    model = synth.model

    class Stage(torch.nn.Module):
        def forward(self, ids, lens):
            return model(ids, lens, max_mel_len=32).postnet_mel

    args = (torch.randint(1, 100, (1, 8)), torch.tensor([8]))
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]):
            ep = torch.export.export(Stage(), args, strict=False)
    else:
        ep = torch.export.export(Stage(), args, strict=False)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert targets and not any("profiler" in t for t in targets)


def test_profile_spans_fails_without_a_card():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, os.path.join(REPO,
                                                       "profile_spans.py"),
                          "--workload", "fs2_hifigan_v1.batch", "--seed",
                          "7"], capture_output=True, text=True, cwd=REPO,
                         env=env, timeout=300)
    assert res.returncode != 0 and "no CUDA card" in res.stderr
