"""A toy vocoder family: each frame's ``hop_length`` samples are tanh of
one linear map of its mel."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.harness import flops, weights


def _shapes(v):
    return {"weight": (v["hop_length"], v["n_mels"]),
            "bias": (v["hop_length"],)}


def draw(v, seed, device):
    return weights.make(_shapes(v), seed, weights.VOCODER, device)


class Vocoder(torch.nn.Linear):
    def forward(self, mel):
        return torch.tanh(super().forward(mel)).flatten(1)


def build(v, W):
    return weights.module(lambda: Vocoder(v["n_mels"], v["hop_length"]), W)


def reference(W, v, mel):
    return torch.tanh(F.linear(mel, W["weight"], W["bias"])).flatten(1)


def forward_flops(v, T):
    return flops.lin(T, v["n_mels"], v["hop_length"])


def tiny(v):
    pass
