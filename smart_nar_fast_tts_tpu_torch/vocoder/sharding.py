"""Tensor-parallel (channel-sharded) HiFi-GAN inference, as
``smart_nar_fast_tts_tpu/vocoder/sharding.py``.

Every conv and conv-transpose of the generator keeps on each rank of the
mesh's ``model`` axis only its slice of output channels (weight and bias);
``conv_post`` (one output channel) stays whole.  A sharded conv computes its
channels from the whole input and gathers the slices over ``model`` before
the next conv: the all-gather that JAX's SPMD partitioner inserts for the
same layout.  The mels are split over the ``data`` axis and the waveforms
gathered back, so every rank returns the whole batch.

f32 inference (V1 and V3): the bf16 compute path of ``hifigan.py`` calls
the convolutions' functions directly, past the gather.
"""

from __future__ import annotations

import copy
from typing import Callable

import torch
from torch import nn

from ..parallel.mesh import Mesh, all_gather_cat, batch_sharding
from .hifigan import HiFiGANGenerator

CONVS = (nn.Conv1d, nn.ConvTranspose1d)


def _out_dim(conv: nn.Module) -> int:
    """The output-channel axis of a conv's weight: (out, in, k) for a
    Conv1d, (in, out, k) for a ConvTranspose1d."""
    return 1 if isinstance(conv, nn.ConvTranspose1d) else 0


def hifigan_pspecs(generator: HiFiGANGenerator, axis: str = "model"
                   ) -> dict[str, tuple]:
    """Each parameter's sharding as a tuple of mesh axes per dimension
    (None: whole): every conv's weight and bias on their output-channel
    axis, ``conv_post`` whole."""
    specs = {}
    for name, module in generator.named_modules():
        if not isinstance(module, CONVS):
            continue
        post = name == "conv_post"
        spec = [None] * 3
        if not post:
            spec[_out_dim(module)] = axis
        specs[f"{name}.weight"] = tuple(spec)
        specs[f"{name}.bias"] = () if post else (axis,)
    return specs


class _Gathered(nn.Module):
    """A conv holding this rank's output channels; its output is every
    rank's channels, gathered."""

    def __init__(self, conv: nn.Module, group, n: int, r: int):
        super().__init__()
        dim = _out_dim(conv)
        c = conv.weight.shape[dim]
        if c % n:
            raise ValueError(f"{c} output channels do not shard over "
                             f"{n} ranks")
        local = copy.deepcopy(conv)
        with torch.no_grad():
            local.weight = nn.Parameter(
                conv.weight.narrow(dim, r * (c // n), c // n).clone())
            local.bias = nn.Parameter(
                conv.bias.narrow(0, r * (c // n), c // n).clone())
        local.out_channels //= n
        self.conv = local
        self.group = group

    @property
    def weight(self) -> torch.Tensor:
        return self.conv.weight

    @property
    def bias(self) -> torch.Tensor:
        return self.conv.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return all_gather_cat(self.conv(x), self.group, 1)


def shard_hifigan(generator: HiFiGANGenerator, mesh: Mesh,
                  data_axis: str = "data", model_axis: str = "model"
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``forward(mels (B, T, n_mels)) → wavs (B, T·hop)`` over ``mesh``:
    each rank keeps its output-channel slices of the generator's convs
    (``hifigan_pspecs``) and runs its rows of the batch along
    ``data_axis``; the waveforms of every row come back on every rank.
    ``forward.generator`` is the rank's generator of slices."""
    if generator.config.compute_dtype != "float32":
        raise ValueError("shard_hifigan runs f32 generators; got "
                         f"compute_dtype {generator.config.compute_dtype!r}")
    group = mesh.group(model_axis)
    n, r = mesh.shape[model_axis], mesh.coords[model_axis]
    specs = hifigan_pspecs(generator, model_axis)
    sharded = copy.deepcopy(generator).eval()
    for name, module in list(sharded.named_modules()):
        if specs.get(f"{name}.bias") == (model_axis,):
            parent, _, leaf = name.rpartition(".")
            owner = sharded.get_submodule(parent) if parent else sharded
            setattr(owner, leaf, _Gathered(module, group, n, r))
    data_group = mesh.group(data_axis)
    rows = (None if data_group is None
            else batch_sharding(mesh, data_axis))

    @torch.no_grad()
    def forward(mels: torch.Tensor) -> torch.Tensor:
        if rows is not None:
            mels = rows(mels)
        return all_gather_cat(sharded(mels), data_group, 0)

    forward.generator = sharded          # this rank's slices
    return forward
