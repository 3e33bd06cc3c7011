"""HiFi-GAN's generator (jik876/hifi-gan ``models.py``, weight norm folded)
in plain PyTorch: conv_pre (k 7) → per stage LeakyReLU 0.1, transposed
conv (stride u, kernel k, padding (k-u)/2), the mean of the multi-receptive
field ResBlocks → LeakyReLU 0.01 → conv_post (k 7) → tanh.  ResBlock1: per
dilation d, LReLU → conv(k, dilation d) → LReLU → conv(k) → + x.

``W`` maps the port's state-dict names to tensors, ``cfg`` is the
``vocoder`` part of the configuration file.  mel (B, T, n_mels) → (B, T·hop).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _conv(W, name, x, dilation=1):
    w = W[name + ".weight"]
    return F.conv1d(x, w, W[name + ".bias"], dilation=dilation,
                    padding=(w.shape[-1] - 1) * dilation // 2)


def forward(W, cfg, mel):
    kernels, dilations = cfg["resblock_kernel_sizes"], \
        cfg["resblock_dilation_sizes"]
    n = len(kernels)
    x = _conv(W, "conv_pre", mel.transpose(1, 2))
    for i, (u, k) in enumerate(zip(cfg["upsample_rates"],
                                   cfg["upsample_kernel_sizes"])):
        x = F.conv_transpose1d(F.leaky_relu(x, 0.1), W[f"ups.{i}.weight"],
                               W[f"ups.{i}.bias"], stride=u,
                               padding=(k - u) // 2)
        acc = None
        for j, dil in enumerate(dilations):
            name = f"resblocks.{i * n + j}"
            h = x
            for m, d in enumerate(dil):
                t = _conv(W, f"{name}.convs1.{m}", F.leaky_relu(h, 0.1), d)
                h = h + _conv(W, f"{name}.convs2.{m}", F.leaky_relu(t, 0.1))
            acc = h if acc is None else acc + h
        x = acc / n
    return torch.tanh(_conv(W, "conv_post", F.leaky_relu(x, 0.01)))[:, 0]


def shapes(cfg) -> dict[str, tuple[int, ...]]:
    """Every parameter by the port's state-dict name."""
    out: dict[str, tuple[int, ...]] = {}
    ch = cfg["upsample_initial_channel"]
    out["conv_pre.weight"], out["conv_pre.bias"] = (ch, cfg["n_mels"], 7), \
        (ch,)
    blocks = []
    for i, k in enumerate(cfg["upsample_kernel_sizes"]):
        c = cfg["upsample_initial_channel"] // 2 ** (i + 1)
        out[f"ups.{i}.weight"], out[f"ups.{i}.bias"] = (ch, c, k), (c,)
        blocks += [(c, rk, len(rd)) for rk, rd in zip(
            cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"])]
        ch = c
    for j, (c, k, n) in enumerate(blocks):
        for group in ("convs1", "convs2"):
            for m in range(n):
                p = f"resblocks.{j}.{group}.{m}"
                out[p + ".weight"], out[p + ".bias"] = (c, c, k), (c,)
    out["conv_post.weight"], out["conv_post.bias"] = (1, ch, 7), (1,)
    return out
