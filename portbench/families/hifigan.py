"""HiFi-GAN's generator (jik876/hifi-gan): the port's ``HiFiGANGenerator``
against ``reference/hifigan.py``, its FLOPs, and the resblock convolutions
of one forward, which the resblock kernel's roofline
(``metrics/resblock_roofline.serve.py``) bounds."""

from __future__ import annotations

import torch

from portbench.harness import flops, weights
from portbench.reference import hifigan as ref

reference = ref.forward


def draw(v: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The seed's weights of the ``vocoder`` part."""
    return weights.make(ref.shapes(v), seed, weights.VOCODER, device)


def build(v: dict, W: dict) -> torch.nn.Module:
    """The port's ``HiFiGANGenerator`` with ``W`` (on their device)."""
    from smart_nar_fast_tts_tpu_torch.vocoder.hifigan import (
        HiFiGANConfig, HiFiGANGenerator)
    c = {k: x for k, x in v.items() if k not in ("family", "hop_length")}
    return weights.module(lambda: HiFiGANGenerator(HiFiGANConfig(**c)), W)


def tiny(v: dict) -> None:
    v["upsample_initial_channel"] = 32


def forward_flops(v: dict, T: int) -> int:
    """FLOPs of the generator on T frames."""
    lin = flops.lin
    ch = v["upsample_initial_channel"]
    out = lin(T, v["n_mels"] * 7, ch)
    n = T
    for u, k in zip(v["upsample_rates"], v["upsample_kernel_sizes"]):
        c = ch // 2
        out += lin(n, ch * k, c)               # transposed: input positions
        n *= u
        for rk, rd in zip(v["resblock_kernel_sizes"],
                          v["resblock_dilation_sizes"]):
            out += 2 * len(rd) * lin(n, c * rk, c)
        ch = c
    return out + lin(n, ch * 7, 1)


def resblock_convs(v: dict, T: int):
    """(n samples, C, k, reads) of each resblock conv of one generator
    forward over T mel frames, in the order the kernel runs them; reads is
    the count of (B, C, n) tensors the conv reads besides its input: 0 for
    a ResBlock1's first conv, 1 (the residual) for the others, 2 (the
    running sum too) for the last conv of every resblock after a stage's
    first."""
    n, ch, out = T, v["upsample_initial_channel"], []
    pair = str(v["resblock"]) == "1"
    for u in v["upsample_rates"]:
        n, ch = n * u, ch // 2
        for r, (k, ds) in enumerate(zip(v["resblock_kernel_sizes"],
                                        v["resblock_dilation_sizes"])):
            for i, _ in enumerate(ds):
                last = 2 if r > 0 and i == len(ds) - 1 else 1
                out += ([(n, ch, k, 0), (n, ch, k, last)] if pair
                        else [(n, ch, k, last)])
    return out
