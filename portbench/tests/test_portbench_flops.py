"""The families' FLOP formulas against ``FlopCounterMode`` on their plain
references, at small unpadded sizes."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.tests import tiny
from portbench.harness import families, weights
from portbench.reference import fastspeech2, hifigan, vocos

FS2 = families.load("fastspeech2")


@pytest.mark.parametrize("name", ["fs2_hifigan_v1", "fastspeech_vocos"])
def test_acoustic_flops(name):
    cfg = tiny.config(name)
    a = cfg["acoustic"]
    W = weights.make(fastspeech2.shapes(a), 3, 1, "cpu")
    W["variance_adaptor.duration_predictor.linear_layer.bias"] += 1.5
    L = 9
    texts = torch.randint(1, 361, (1, L), generator=torch.Generator()
                          .manual_seed(0))
    lens = torch.tensor([L])
    with torch.no_grad():
        T = int(fastspeech2.forward(W, a, texts, lens, t_cap=400).mel_lens[0])
        with FlopCounterMode(display=False) as fc:
            out = fastspeech2.forward(W, a, texts, lens, t_cap=T)
    assert int(out.mel_lens[0]) == T
    assert fc.get_total_flops() == FS2.forward_flops(a, L, T)

    T = 30
    Wg = {k: v.clone().requires_grad_(not k.endswith(("running_mean",
                                                       "running_var")))
          for k, v in W.items()}
    g = torch.Generator().manual_seed(1)
    b = dict(mels=torch.randn(1, T, a["n_mel_channels"], generator=g),
             mel_lens=torch.tensor([T]), pitch=torch.randn(1, T, generator=g),
             energy=torch.randn(1, T, generator=g))
    with FlopCounterMode(display=False) as fc:
        out = fastspeech2.forward(Wg, a, texts, lens, train=True,
                                  gen=torch.Generator().manual_seed(0), **b)
        fastspeech2.loss(out, lens, b["mels"], b["pitch"],
                         b["energy"])[0].backward()
    assert fc.get_total_flops() == FS2.train_flops(a, L, T)


@pytest.mark.parametrize("name,ref", [("fs2_hifigan_v1", hifigan),
                                      ("fastspeech_vocos", vocos)])
def test_vocoder_flops(name, ref):
    cfg = tiny.config(name)
    v = cfg["vocoder"]
    W = weights.make(ref.shapes(v), 3, 2, "cpu")
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        ref.forward(W, v, torch.randn(1, 17, v["n_mels"]))
    family = families.load(cfg["reference"]["vocoder"])
    assert fc.get_total_flops() == family.forward_flops(v, 17)


def test_published_widths_count():
    """FLOPs a frame at the published widths: HiFi-GAN V1 about 613
    MFLOP a frame (the port's records), Vocos about 25."""
    v1 = tiny.cell.load_config("fs2_hifigan_v1")["vocoder"]
    vc = tiny.cell.load_config("fastspeech_vocos")["vocoder"]
    count = {name: families.load(name).forward_flops
             for name in ("hifigan", "vocos")}
    assert 550e6 < count["hifigan"](v1, 1000) / 1000 < 700e6
    assert 20e6 < count["vocos"](vc, 1000) / 1000 < 30e6
