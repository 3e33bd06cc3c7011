"""The plain reference against the port at small sizes on the CPU, where
the port runs its kernels' plain versions: inference of both
configurations (durations, mel, waveform) and three training steps with
dropout drawn from one seed."""

import numpy as np
import pytest
import torch

from portbench.tests import tiny
from portbench.harness import families, weights
from portbench.reference import fastspeech2, hifigan, train, vocos

FS2 = families.load("fastspeech2")


@pytest.mark.parametrize("name,ref", [("fs2_hifigan_v1", hifigan),
                                      ("fastspeech_vocos", vocos)])
def test_inference(name, ref):
    cfg = tiny.config(name)
    a = cfg["acoustic"]
    shapes = fastspeech2.shapes(a)
    W = weights.make(shapes, 7, 1, "cpu")
    W["variance_adaptor.duration_predictor.linear_layer.bias"] += 1.4
    model = FS2.build(cfg, W).eval()
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} \
        == shapes
    Wv = weights.make(ref.shapes(cfg["vocoder"]), 7, 2, "cpu",
                      layers=cfg["vocoder"].get("n_layers", 1))
    voc = families.load(cfg["reference"]["vocoder"]).build(
        cfg["vocoder"], Wv).eval()
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


def _train_batches():
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
    return batches


def test_three_training_steps():
    cfg = tiny.config("fs2_hifigan_v1")
    a = cfg["acoustic"]
    shapes = fastspeech2.shapes(a)
    batches = _train_batches()
    model, state, step = FS2.train_program(
        cfg, weights.make(shapes, 11, 1, "cpu"), "cpu")
    gen = torch.Generator().manual_seed(99)
    losses = []
    for b in batches:
        losses.append([float(x) for x in step(state, FS2.feed(b), gen)])
    W0 = weights.make(shapes, 11, 1, "cpu")
    change = {n: float(torch.linalg.vector_norm(p.detach() - W0[n]))
              for n, p in model.named_parameters()}
    ref = train.run(W0, cfg, batches, 99, 3)
    assert np.abs(np.array(losses) - np.array(ref["losses"])).max() < 1e-5
    assert max(abs(change[n] - ref["change"][n]) for n in change) < 1e-5


def test_training_reference_follows_forced_targets():
    """Forced to its own duration targets the reference runs as it does
    alone; forced to others it trains on them and still reports its own."""
    cfg = tiny.config("fs2_hifigan_v1")
    W0 = weights.make(fastspeech2.shapes(cfg["acoustic"]), 11, 1, "cpu")
    batches = _train_batches()
    alone = train.run(W0, cfg, batches, 99, 3)
    same = train.run(W0, cfg, batches, 99, 3, alone["targets"])
    assert same["losses"] == alone["losses"]
    assert same["change"] == alone["change"]
    other = [t.clone() for t in alone["targets"]]
    for t in other:
        t[:, 0] += 1
    moved = train.run(W0, cfg, batches, 99, 3, other)
    assert torch.equal(moved["targets"][0], alone["targets"][0])
    assert moved["losses"][0][5] != alone["losses"][0][5]
