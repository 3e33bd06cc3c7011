"""Seeded weights, made on the device in two draws.

The scales are PyTorch's initialisers': a dense or conv weight and its
bias uniform in ±1/√fan_in (fan_in = the weight's dim 1 times its kernel,
as ``torch.nn.init`` counts it, transposed convs included), embeddings
N(0, 1), norm scales 1 and shifts 0, BatchNorm statistics 0 and 1, a
ConvNeXt layer scale 1/layers.  One ``torch.rand`` and one ``torch.randn``
over all leaves at once, on ``device``, from a generator seeded by the run
seed; the leaves are slices of the two draws, scaled.
"""

from __future__ import annotations

import math

import torch

from .traffic import sub_seed

# the streams of the two models' draws (``traffic.sub_seed`` tags)
ACOUSTIC, VOCODER = 1, 2


def _kind(name: str, shape, shapes) -> str:
    if name.endswith("running_mean"):
        return "zeros"
    if name.endswith("running_var"):
        return "ones"
    if name.endswith(".gamma"):
        return "gamma"
    if name.endswith("emb.weight") or name.endswith("embedding.weight"):
        return "normal"
    stem, _, leaf = name.rpartition(".")
    weight = shapes.get(stem + ".weight")
    if weight is not None and len(weight) == 1:
        return "ones" if leaf == "weight" else "zeros"
    return "uniform"


def make(shapes: dict[str, tuple], seed: int, tag: int, device,
         layers: int = 1) -> dict[str, torch.Tensor]:
    """Tensors for every name of ``shapes``, float32 on ``device``."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, tag))
    kinds = {n: _kind(n, s, shapes) for n, s in shapes.items()}
    count = {k: sum(math.prod(s) for n, s in shapes.items()
                    if kinds[n] == k) for k in ("uniform", "normal")}
    draws = {"uniform": torch.rand(count["uniform"], generator=g,
                                   device=device).mul_(2.0).sub_(1.0),
             "normal": torch.randn(count["normal"], generator=g,
                                   device=device)}
    at = {"uniform": 0, "normal": 0}
    out = {}
    for name, shape in shapes.items():
        kind = kinds[name]
        if kind in draws:
            n = math.prod(shape)
            t = draws[kind][at[kind]:at[kind] + n].view(shape)
            at[kind] += n
            if kind == "uniform":
                stem = name.rpartition(".")[0]
                w = shapes.get(stem + ".weight", shape)
                fan_in = math.prod(w[1:]) if len(w) > 1 else w[0]
                t = t * (1.0 / math.sqrt(fan_in))
            out[name] = t.contiguous()
        elif kind == "gamma":
            out[name] = torch.full(shape, 1.0 / layers, device=device)
        else:
            out[name] = (torch.ones if kind == "ones" else torch.zeros)(
                shape, device=device)
    return out


def module(build, W: dict[str, torch.Tensor]) -> torch.nn.Module:
    """The module ``build()`` makes, made on the weights' device and
    loaded with ``W``."""
    dev = next(iter(W.values())).device
    with torch.device(dev):
        model = build()
    model.to(dev)
    model.load_state_dict(W, strict=True)
    return model
