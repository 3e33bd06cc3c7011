"""The plain reference against the port at small sizes on the CPU, where
the port runs its kernels' plain versions: inference of both
configurations (durations, mel, waveform) and three training steps with
dropout drawn from one seed."""

import numpy as np
import pytest
import torch

from portbench.tests import tiny
from portbench.harness import program, weights
from portbench.reference import fastspeech2, hifigan, train, vocos


@pytest.mark.parametrize("name,ref", [("fs2_hifigan_v1", hifigan),
                                      ("fastspeech_vocos", vocos)])
def test_inference(name, ref):
    cfg = tiny.config(name)
    a = cfg["acoustic"]
    shapes = fastspeech2.shapes(a)
    W = weights.make(shapes, 7, 1, "cpu")
    W["variance_adaptor.duration_predictor.linear_layer.bias"] += 1.4
    model = program.acoustic(cfg, W).eval()
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} \
        == shapes
    Wv = weights.make(ref.shapes(cfg["vocoder"]), 7, 2, "cpu",
                      layers=cfg["vocoder"].get("n_layers", 1))
    voc = program.vocoder(cfg, Wv).eval()
    g = torch.Generator().manual_seed(0)
    texts = torch.randint(1, 361, (3, 20), generator=g)
    lens = torch.tensor([20, 13, 7])
    texts = texts * (torch.arange(20)[None, :] < lens[:, None])
    with torch.no_grad():
        got = model(texts, lens, max_mel_len=100)
        want = fastspeech2.forward(W, a, texts, lens, t_cap=100)
        wav = voc(got.postnet_mel)
        ref_wav = ref.forward(Wv, cfg["vocoder"], got.postnet_mel)
    assert torch.equal(got.duration_rounded, want.duration)
    assert torch.equal(got.mel_lens, want.mel_lens)
    assert (got.postnet_mel - want.postnet_mel).abs().max() <= 1e-5
    assert wav.shape == ref_wav.shape
    assert (wav - ref_wav).abs().max() <= 1e-5 * ref_wav.abs().max()


def test_bf16_attention_rounds_where_configured():
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 2, 64, 16, generator=g) for _ in range(3))
    valid = torch.arange(64)[None, :] < torch.tensor([64, 40])[:, None]
    f32 = fastspeech2.self_attention(q, k, v, valid)
    b16 = fastspeech2.self_attention(q, k, v, valid, torch.bfloat16)
    gap = (f32 - b16).abs().max()
    assert 1e-4 < gap < 5e-2


def test_three_training_steps():
    from smart_nar_fast_tts_tpu_torch.config import OptimizerConfig
    from smart_nar_fast_tts_tpu_torch.data.batch import Batch
    from smart_nar_fast_tts_tpu_torch.models import FastSpeech2Loss
    from smart_nar_fast_tts_tpu_torch.training import (create_train_state,
                                                       make_train_step)
    cfg = tiny.config("fs2_hifigan_v1")
    a, o = cfg["acoustic"], cfg["optimizer"]
    shapes = fastspeech2.shapes(a)
    g = torch.Generator().manual_seed(3)
    batches = []
    for _ in range(3):
        lens, ml = torch.tensor([16, 11, 6]), torch.tensor([48, 40, 20])
        texts = torch.randint(1, 361, (3, 16), generator=g) * (
            torch.arange(16) < lens[:, None])
        batches.append(dict(
            texts=texts, src_lens=lens,
            mels=torch.randn(3, 48, 80, generator=g), mel_lens=ml,
            pitch=torch.randn(3, 48, generator=g),
            energy=torch.randn(3, 48, generator=g)))
    model = program.acoustic(cfg, weights.make(shapes, 11, 1, "cpu"))
    state = create_train_state(model, OptimizerConfig(
        betas=tuple(o["betas"]), eps=o["eps"],
        weight_decay=o["weight_decay"],
        grad_clip_thresh=o["grad_clip_thresh"],
        warm_up_step=o["warm_up_step"]), device="cpu")
    step = make_train_step(FastSpeech2Loss(program.preprocess_config(cfg)))
    gen = torch.Generator().manual_seed(99)
    losses = []
    for b in batches:
        losses.append([float(x) for x in step(state, Batch(
            b["texts"], b["src_lens"], b["mels"], b["mel_lens"], b["pitch"],
            b["energy"]), gen)])
    W0 = weights.make(shapes, 11, 1, "cpu")
    change = {n: float(torch.linalg.vector_norm(p.detach() - W0[n]))
              for n, p in model.named_parameters()}
    ref = train.run(W0, cfg, batches, 99, 3)
    assert np.abs(np.array(losses) - np.array(ref["losses"])).max() < 1e-5
    assert max(abs(change[n] - ref["change"][n]) for n in change) < 1e-5
