"""Vocos (Siuzdak 2023, arXiv:2306.00814; charactr/vocos-mel-24khz): the
port's ``VocosGenerator`` against ``reference/vocos.py``, and its FLOPs."""

from __future__ import annotations

import torch

from portbench.harness import flops, weights
from portbench.reference import vocos as ref

reference = ref.forward


def draw(v: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The seed's weights of the ``vocoder`` part (ConvNeXt layer scales
    1/layers)."""
    return weights.make(ref.shapes(v), seed, weights.VOCODER, device,
                        layers=v["n_layers"])


def build(v: dict, W: dict) -> torch.nn.Module:
    """The port's ``VocosGenerator`` with ``W`` (on their device)."""
    from smart_nar_fast_tts_tpu_torch.vocoder.vocos import (VocosConfig,
                                                            VocosGenerator)
    c = {k: x for k, x in v.items() if k not in ("family", "hop_length")}
    return weights.module(lambda: VocosGenerator(VocosConfig(**c)), W)


def tiny(v: dict) -> None:
    v.update(dim=32, intermediate=48, n_layers=2)


def forward_flops(v: dict, T: int) -> int:
    """FLOPs of Vocos on T frames (the inverse STFT is an FFT: not
    counted)."""
    lin = flops.lin
    d, m = v["dim"], v["intermediate"]
    per = lin(T, v["dw_kernel"], d) + lin(T, d, m) + lin(T, m, d)
    return (lin(T, v["n_mels"] * 7, d) + v["n_layers"] * per
            + lin(T, d, 2 * (v["n_fft"] // 2 + 1)))
