"""Vocos (Siuzdak 2023, arXiv:2306.00814) in plain PyTorch: embed (conv
k 7) → LayerNorm → ConvNeXt blocks (depthwise conv k 7 → LayerNorm → Linear
→ tanh-GELU → Linear → x + gamma·h) → LayerNorm → a Linear head to
log-magnitude and phase per frame → inverse STFT (``torch.fft.irfft`` of
each frame, periodic Hann synthesis window, overlap-add, divided by the
window's sum of squares, centre trimmed), in float64: cuFFT's float32
inverse over thousands of frames reads percents off its own float64
result on an H100.  The head's last frame is
repeated once, so T frames render T·hop samples.  LayerNorm epsilon 1e-6
and the tanh GELU, as the configuration states.

``W`` maps the port's state-dict names to tensors, ``cfg`` is the
``vocoder`` part of the configuration file.  mel (B, T, n_mels) → (B, T·hop).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-6
MAX_MAG = 1e2


def _ln(W, name, x):
    return F.layer_norm(x, x.shape[-1:], W[name + ".weight"],
                        W[name + ".bias"], LN_EPS)


def _window(n_fft, win_length):
    k = np.arange(win_length, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * k / win_length)
    out = np.zeros(n_fft)
    lpad = (n_fft - win_length) // 2
    out[lpad:lpad + win_length] = w
    return out


def istft(mag, phase, n_fft, hop, win_length):
    """(B, F, bins) magnitude and phase → (B, hop·(F−1)), computed in
    float64, returned in float32."""
    dtype = mag.dtype
    frames = torch.fft.irfft(torch.polar(mag.double(), phase.double()),
                             n=n_fft, dim=-1)
    win = _window(n_fft, win_length)
    frames = frames * torch.from_numpy(win).to(frames.device)
    b, f, _ = frames.shape
    n = n_fft + hop * (f - 1)
    sig = F.fold(frames.transpose(1, 2), output_size=(1, n),
                 kernel_size=(1, n_fft), stride=(1, hop)).reshape(b, n)
    wss = np.zeros(n)
    for i in range(f):
        wss[i * hop:i * hop + n_fft] += win ** 2
    wss = torch.from_numpy(wss).to(sig.device)
    sig = torch.where(wss > 1e-11, sig / torch.clamp(wss, min=1e-11), sig)
    return sig[:, n_fft // 2:n - n_fft // 2].to(dtype)


def forward(W, cfg, mel):
    x = F.conv1d(mel.transpose(1, 2), W["embed.weight"], W["embed.bias"],
                 padding=3).transpose(1, 2)
    x = _ln(W, "norm_in", x)
    k = cfg["dw_kernel"]
    for i in range(cfg["n_layers"]):
        p = f"blocks.{i}"
        h = F.conv1d(F.pad(x.transpose(1, 2), ((k - 1) // 2, k // 2)),
                     W[p + ".dwconv.weight"], W[p + ".dwconv.bias"],
                     groups=x.shape[-1]).transpose(1, 2)
        h = _ln(W, p + ".norm", h)
        h = F.gelu(F.linear(h, W[p + ".pw1.weight"], W[p + ".pw1.bias"]),
                   approximate="tanh")
        h = F.linear(h, W[p + ".pw2.weight"], W[p + ".pw2.bias"])
        x = x + W[p + ".gamma"] * h
    x = _ln(W, "norm_out", x)
    logm, phase = F.linear(x, W["head.weight"], W["head.bias"]).chunk(2, -1)
    mag = torch.exp(torch.clamp(logm, max=math.log(MAX_MAG)))
    mag = torch.cat([mag, mag[:, -1:]], dim=1)
    phase = torch.cat([phase, phase[:, -1:]], dim=1)
    return istft(mag, phase, cfg["n_fft"], cfg["hop"], cfg["win_length"])


def shapes(cfg) -> dict[str, tuple[int, ...]]:
    """Every parameter by the port's state-dict name."""
    d, m = cfg["dim"], cfg["intermediate"]
    out = {"embed.weight": (d, cfg["n_mels"], 7), "embed.bias": (d,),
           "norm_in.weight": (d,), "norm_in.bias": (d,)}
    for i in range(cfg["n_layers"]):
        p = f"blocks.{i}"
        out.update({p + ".gamma": (d,),
                    p + ".dwconv.weight": (d, 1, cfg["dw_kernel"]),
                    p + ".dwconv.bias": (d,), p + ".norm.weight": (d,),
                    p + ".norm.bias": (d,), p + ".pw1.weight": (m, d),
                    p + ".pw1.bias": (m,), p + ".pw2.weight": (d, m),
                    p + ".pw2.bias": (d,)})
    bins = cfg["n_fft"] // 2 + 1
    out.update({"norm_out.weight": (d,), "norm_out.bias": (d,),
                "head.weight": (2 * bins, d), "head.bias": (2 * bins,)})
    return out
