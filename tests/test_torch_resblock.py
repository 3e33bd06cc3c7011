"""HiFi-GAN's resblock convolution wrapper (``kernels.hifigan_resblock_conv``)
on the CPU: its plain version against the module chain, its 3xTF32 twin
against float64, and the rule that picks the kernel.

On the CPU the wrapper runs its plain version, so a resblock made to take
the wrapper's path computes the module chain's f32 operations in the
module chain's order: the two agree bit for bit, every epilogue included
((a) a ResBlock1's first conv, (b) the residual, (c) the running
multi-receptive-field sum and its division).  The kernel itself runs only
on a card (``tests/test_torch_kernels_cuda.py``)."""

import types

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from smart_nar_fast_tts_tpu_torch import kernels
from smart_nar_fast_tts_tpu_torch.kernels import resblock
from smart_nar_fast_tts_tpu_torch.vocoder import (HiFiGANConfig,
                                                  HiFiGANGenerator, hifigan)
from smart_nar_fast_tts_tpu_torch.vocoder.sharding import _Gathered

# 3xTF32 against float64, over the largest |output|: the dropped lo·lo
# terms (2^-22 of a product) and f32 sums; single-pass TF32 misses it by
# ~100x
TF32X3_REL = 1e-6


def _seeded(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    return module


@pytest.mark.parametrize("epilogue", ["residual", "sum", "sum divided"])
@pytest.mark.parametrize("T", [2, 257])
@pytest.mark.parametrize("d", [1, 3, 5])
@pytest.mark.parametrize("k", [3, 7, 11])
@pytest.mark.parametrize("C", [32, 128, 256])
@pytest.mark.parametrize("kind", ["1", "2"])
def test_plain_version_is_the_module_chain(monkeypatch, kind, C, k, d, T,
                                           epilogue):
    block_cls = hifigan.ResBlock1 if kind == "1" else hifigan.ResBlock2
    block = _seeded(block_cls(C, k, (d, 1)), seed=C + k + d).eval()
    g = torch.Generator().manual_seed(T)
    x = torch.randn(2, C, T, generator=g)
    acc = None if epilogue == "residual" else torch.randn(2, C, T,
                                                          generator=g)
    div = 3 if epilogue == "sum divided" else 1
    with torch.no_grad():
        chain = block(x, acc, div)
        monkeypatch.setattr(hifigan, "_on_kernel", lambda x, convs: True)
        fused = block(x, acc, div)
    assert torch.equal(fused, chain)


@pytest.mark.parametrize("mode", ["first conv", "residual", "sum"])
def test_wrapper_epilogues(mode):
    """Epilogues (a), (b), (c) of the wrapper against their definition."""
    g = torch.Generator().manual_seed(5)
    x, r, a = (torch.randn(2, 32, 40, generator=g) for _ in range(3))
    w, b = torch.randn(32, 32, 7, generator=g), torch.randn(32, generator=g)
    conv = F.conv1d(F.leaky_relu(x, 0.1), w, b, dilation=3, padding=9)
    kw = {"first conv": {}, "residual": {"res": r},
          "sum": {"res": r, "acc": a, "div": 3.0}}[mode]
    expect = {"first conv": conv, "residual": r + conv,
              "sum": (a + (r + conv)) / 3.0}[mode]
    got = kernels.hifigan_resblock_conv(x, w, b, 3, 0.1, **kw)
    assert torch.equal(got, expect)


def test_wrapper_rejects_inconsistent_arguments():
    x, w = torch.randn(1, 8, 10), torch.randn(8, 8, 3)
    with pytest.raises(ValueError):
        kernels.hifigan_resblock_conv(x, w, None, 1, 0.1, acc=x)
    with pytest.raises(ValueError):
        kernels.hifigan_resblock_conv(x, w, None, 1, 0.1, res=x, div=3.0)
    with pytest.raises(ValueError):
        kernels.hifigan_resblock_conv(x, torch.randn(8, 4, 3), None, 1, 0.1)


@pytest.mark.parametrize("C, k, d", [(32, 3, 1), (32, 11, 5), (128, 7, 3),
                                     (256, 11, 5), (256, 3, 1)])
def test_tf32x3_twin_against_float64(C, k, d):
    g = torch.Generator().manual_seed(C * k + d)
    x = torch.randn(2, C, 300, generator=g) * 2
    w = torch.randn(C, C, k, generator=g) / (C * k) ** 0.5
    b = torch.randn(C, generator=g) * 0.1
    r = torch.randn(2, C, 300, generator=g)
    f64 = resblock.resblock_conv_reference(x.double(), w.double(), b.double(),
                                           d, 0.1, r.double())
    got = resblock.resblock_conv_tf32x3_reference(x, w, b, d, 0.1, r)
    scale = float(f64.abs().max())
    assert float((got.double() - f64).abs().max()) / scale <= TF32X3_REL
    # one TF32 pass (hi·hi) alone is far off: the bound tells them apart
    one = r + F.conv1d(resblock.tf32_round(F.leaky_relu(x, 0.1)),
                       resblock.tf32_round(w), b, dilation=d,
                       padding=(k - 1) * d // 2)
    assert float((one.double() - f64).abs().max()) / scale > 30 * TF32X3_REL


def _narrow(**kw):
    base = dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
                upsample_initial_channel=32, resblock_kernel_sizes=(3, 5, 7),
                resblock_dilation_sizes=((1, 3, 5), (1, 2), (2, 6)))
    return HiFiGANConfig(**{**base, **kw})


@pytest.mark.parametrize("kind", ["1", "2"])
def test_generator_sum_on_the_wrapper_path(monkeypatch, kind):
    """The generator's running sum folded into each resblock's last conv
    (and the division into the stage's last) equals today's sum."""
    gen = _seeded(HiFiGANGenerator(_narrow(resblock=kind)), seed=7).eval()
    mel = torch.randn(2, 9, 80, generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        chain = gen(mel)
        monkeypatch.setattr(hifigan, "_on_kernel", lambda x, convs: True)
        fused = gen(mel)
    assert torch.equal(fused, chain)


def _on_kernel(dtype=torch.float32, cuda=True, convs=None):
    x = types.SimpleNamespace(is_cuda=cuda, dtype=dtype)
    return hifigan._on_kernel(x, convs or [nn.Conv1d(4, 4, 3)])


@pytest.mark.parametrize("case", ["cuda f32", "cpu", "bf16", "grad",
                                  "sharded"])
def test_dispatch_rule(case):
    if case == "grad":
        with torch.enable_grad():
            assert not _on_kernel()
        return
    with torch.no_grad():
        if case == "cuda f32":
            assert _on_kernel()
        elif case == "cpu":
            assert not _on_kernel(cuda=False)
        elif case == "bf16":
            assert not _on_kernel(dtype=torch.bfloat16)
        else:
            sharded = _Gathered(nn.Conv1d(4, 4, 3), None, 1, 0)
            assert not _on_kernel(convs=[nn.Conv1d(4, 4, 3), sharded])


@pytest.mark.parametrize("case", ["no_grad", "inference", "grad", "bf16"])
def test_no_launch_on_the_cpu(case):
    cfg = _narrow(compute_dtype="bfloat16" if case == "bf16" else "float32")
    gen = HiFiGANGenerator(cfg).eval()
    mel = torch.randn(1, 5, 80)
    kernels.reset_launches()
    ctx = {"no_grad": torch.no_grad, "inference": torch.inference_mode,
           "grad": torch.enable_grad, "bf16": torch.no_grad}[case]
    with ctx():
        gen(mel)
    assert kernels.launches()["hifigan_resblock_conv"] == 0


def test_export_keeps_the_module_chain_on_the_cpu():
    """A CPU export traces the module chain: no resblock operator in it
    (a CUDA export keeps ``smart_tts::hifigan_resblock_conv``, held on the
    card)."""
    gen = HiFiGANGenerator(_narrow()).eval()
    with torch.no_grad():
        ep = torch.export.export(gen, (torch.randn(1, 6, 80),), strict=False)
    targets = {str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"}
    assert not any("hifigan_resblock_conv" in t for t in targets)
