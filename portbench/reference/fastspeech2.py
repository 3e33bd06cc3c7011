"""FastSpeech2 with a learned alignment, in plain PyTorch: inference (text
→ durations → mel) and the training forward and loss.

The architecture is ming024/FastSpeech2's (post-LN FFT blocks of
multi-head self-attention and a conv FFN, sinusoidal positions, variance
predictors, quantized pitch and energy embeddings, a 5-conv PostNet), with
the extensions the port documents and the configuration names:

- Gaussian upsampling: frame t takes phoneme l with weight
  ``exp(-(t - c_l)²/σ²)``, normalised over the valid phonemes, c_l the
  centre of its span; frames past Σd are zero.
- The text and frame axes end at the batch's longest item: each conv
  wider than 1 sees zeros past it, and positions past an item's own length
  are zeroed after each block.
- Training aligns text and mel with cross-attention blocks over the
  prenet'd mel (first frame zeroed); head 0 of the last layer gives each
  frame's phoneme (its argmax, the first among equal maxima), so the
  durations; the guided-attention prior sums ``W·p`` of head 0 of every
  layer.
- Dropout draws ``torch.rand(shape, generator=...) >= rate`` for each
  dropout in the order the forward reaches them, so one generator seeded
  alike gives the program's masks.

``W`` maps the port's state-dict names to tensors; ``cfg`` is the
``acoustic`` part of the configuration file, ``bf16_past`` the frame count
past which self-attention rounds to bfloat16.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-5
NEG_INF = -1e30


# ---------------------------------------------------------------- pieces

def positions(n: int, d: int, device) -> torch.Tensor:
    """(n, d) sinusoid table, float64 angles, stored as float32."""
    pos = np.arange(n, dtype=np.float64)[:, None]
    i = np.arange(d, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, 2.0 * (i // 2) / d)
    table = np.where(np.arange(d)[None, :] % 2 == 0, np.sin(angle),
                     np.cos(angle))
    return torch.from_numpy(table.astype(np.float32)).to(device)


def dropout(x, rate, gen):
    if gen is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def rows(valid, x):
    """x with the rows where ``valid`` ((B, T) or (T,)) is False zeroed."""
    return torch.where(valid[..., None], x, 0.0)


def linear(W, name, x):
    return F.linear(x, W[name + ".weight"], W[name + ".bias"])


def conv(W, name, x):
    """'same' conv1d of feature-last x (B, T, C)."""
    w = W[name + ".weight"]
    y = F.conv1d(x.transpose(1, 2), w, W[name + ".bias"],
                 padding=(w.shape[-1] - 1) // 2)
    return y.transpose(1, 2)


def layer_norm(W, name, x, eps=LN_EPS):
    return F.layer_norm(x, x.shape[-1:], W[name + ".weight"],
                        W[name + ".bias"], eps)


def softmax_masked(scores, valid):
    """Softmax over the last axis with invalid keys excluded."""
    s = torch.where(valid, scores, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * valid
    return p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-37)


def self_attention(q, k, v, key_valid, low=None):
    """(B, H, T, D) attention over the valid keys.  ``low`` (a dtype):
    q·scale, k, v and the unnormalised probabilities rounded to it, sums
    and the softmax in float32 (bfloat16: the configuration's precision
    past its frame count)."""
    valid = key_valid[:, None, None, :]
    if low is None:
        return torch.einsum("bhqk,bhkd->bhqd", softmax_masked(
            torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1]),
            valid), v)
    scale = 1.0 / math.sqrt(q.shape[-1])
    b = low
    s = torch.einsum("bhqd,bhkd->bhqk", (q * scale).to(b).float(),
                     k.to(b).float())
    s = torch.where(valid, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * valid
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(b).float(), v.to(b).float())
    return out / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-37)


def guided_weight(T, L, src_lens, mel_lens, sigma):
    t = torch.arange(T, dtype=torch.float32, device=src_lens.device)
    n = torch.arange(L, dtype=torch.float32, device=src_lens.device)
    olen = mel_lens.float()[:, None, None]
    ilen = src_lens.float()[:, None, None]
    w = 1.0 - torch.exp(-((n[None, None, :] / ilen
                           - t[None, :, None] / olen) ** 2)
                        / (2.0 * sigma ** 2))
    return w, (t[None, :, None] < olen) & (n[None, None, :] < ilen)


def alignment(q, k, v, key_valid, src_lens, mel_lens, sigma):
    """Cross-attention that also returns head 0's per-frame argmax and
    its guided numerator Σ W·p over the valid (frame, phoneme) pairs."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    valid = key_valid[:, None, None, :]
    masked = torch.where(valid, scores, NEG_INF)
    p = softmax_masked(scores, valid)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v)
    w, pairs = guided_weight(q.shape[2], k.shape[2], src_lens, mel_lens,
                             sigma)
    gnum = torch.where(pairs, w * p[:, 0], 0.0).sum(dim=(1, 2))
    return out, first_argmax(masked[:, 0].detach()), gnum


def first_argmax(x):
    n = x.shape[-1]
    pos = torch.arange(n, device=x.device)
    hit = x == x.amax(dim=-1, keepdim=True)
    return torch.where(hit, pos, n).amin(dim=-1)


def fft_block(W, name, x, valid, cap, heads, rate, gen, bf16_past,
              kv=None, kv_valid=None, align=None, low=torch.bfloat16):
    """Post-LN attention + conv FFN.  Returns (out, alignment reductions or
    None)."""
    B, Lq, d = x.shape
    attn = "crs_attn" if kv is not None else "slf_attn"
    src = x if kv is None else kv
    Lk = src.shape[1]
    dk = d // heads

    def split(lin, inp, n):
        return linear(W, f"{name}.{attn}.{lin}", inp).view(
            B, n, heads, dk).transpose(1, 2)

    q, k, v = split("w_qs", x, Lq), split("w_ks", src, Lk), \
        split("w_vs", src, Lk)
    key_valid = valid if kv_valid is None else kv_valid
    red = None
    if align is not None:
        out, idx, gnum = alignment(q, k, v, key_valid, *align)
        red = (idx, gnum)
    else:
        out = self_attention(q, k, v, key_valid,
                             low if kv is None and max(Lq, Lk) > bf16_past
                             else None)
    out = out.transpose(1, 2).reshape(B, Lq, d)
    out = dropout(linear(W, f"{name}.{attn}.fc", out), rate, gen)
    out = rows(valid, layer_norm(W, f"{name}.{attn}.layer_norm", out + x))
    h = torch.relu(conv(W, f"{name}.pos_ffn.w_1", out))
    if cap is not None and W[f"{name}.pos_ffn.w_2.weight"].shape[-1] > 1:
        h = rows(cap, h)
    h = dropout(conv(W, f"{name}.pos_ffn.w_2", h), rate, gen)
    out = layer_norm(W, f"{name}.pos_ffn.layer_norm", h + out)
    return rows(valid, out), red


def stack(W, name, x, valid, cap, n_layers, heads, rate, gen, bf16_past,
          low=torch.bfloat16):
    x = x + positions(x.shape[1], x.shape[2], x.device)[None]
    for i in range(n_layers):
        x, _ = fft_block(W, f"{name}.layer_stack.{i}", x, valid, cap, heads,
                         rate, gen, bf16_past, low=low)
    return x


def predictor(W, name, x, valid, cap, rate, gen):
    h = layer_norm(W, f"{name}.conv_layer.layer_norm_1", torch.relu(
        conv(W, f"{name}.conv_layer.conv1d_1.conv", x)))
    h = dropout(h, rate, gen)
    if cap is not None:
        h = rows(cap, h)
    h = layer_norm(W, f"{name}.conv_layer.layer_norm_2", torch.relu(
        conv(W, f"{name}.conv_layer.conv1d_2.conv", h)))
    h = dropout(h, rate, gen)
    return torch.where(valid, linear(W, f"{name}.linear_layer", h)[..., 0],
                       0.0)


def bins(lo, hi, n_bins, device):
    return torch.from_numpy(np.linspace(lo, hi, n_bins - 1).astype(
        np.float32)).to(device)


def upsample(x, durations, max_len, phon_valid, sigma):
    """Gaussian length regulator: (out (B, T, D), mel_len (B,) int32)."""
    d = durations.float() * phon_valid
    e = torch.cumsum(d, dim=1)
    c = e - 0.5 * d
    t = torch.arange(max_len, dtype=torch.float32, device=x.device)
    w = torch.exp(-(sigma ** -2) * (t[None, None, :] - c[:, :, None]) ** 2)
    w = w * phon_valid[:, :, None]
    w = w / (w.sum(dim=1, keepdim=True) + 1e-20)
    total = e[:, -1]
    w = w * (t[None, :] < total[:, None])[:, None, :]
    out = torch.einsum("blt,bld->btd", w, x)
    return out, torch.clamp(total, max=max_len).to(torch.int32)


def postnet(W, x, cap, gen, train: bool):
    """Five conv(k 5) + BatchNorm layers, tanh on all but the last,
    dropout 0.5 after each; ``train`` takes the BatchNorm statistics of
    the batch over the frames below the batch capacity."""
    h = x.transpose(1, 2)
    for i in range(5):
        h = torch.where(cap[None, None, :], h, 0.0)
        w = W[f"postnet.convolutions.{i}.0.conv.weight"]
        h = F.conv1d(h, w, W[f"postnet.convolutions.{i}.0.conv.bias"],
                     padding=(w.shape[-1] - 1) // 2)
        bn = f"postnet.convolutions.{i}.1"
        if train:
            m = cap.to(h.dtype)[None, None, :]
            n = torch.clamp(m.sum() * h.shape[0], min=1.0)
            mean = (h * m).sum(dim=(0, 2)) / n
            var = ((h - mean[:, None]) ** 2 * m).sum(dim=(0, 2)) / n
        else:
            mean, var = W[bn + ".running_mean"], W[bn + ".running_var"]
        h = (h - mean[:, None]) * torch.rsqrt(var + 1e-5)[:, None]
        h = h * W[bn + ".weight"][:, None] + W[bn + ".bias"][:, None]
        if i != 4:
            h = torch.tanh(h)
        h = dropout(h, 0.5, gen)
    return h.transpose(1, 2)


# ---------------------------------------------------------------- model

class Output(NamedTuple):
    mel: torch.Tensor
    postnet_mel: torch.Tensor
    pitch: torch.Tensor
    energy: torch.Tensor
    log_duration: torch.Tensor
    duration: torch.Tensor
    mel_lens: torch.Tensor
    mel_valid: torch.Tensor
    src_valid: torch.Tensor
    duration_targets: Optional[torch.Tensor] = None
    guided: Optional[torch.Tensor] = None
    own_duration: Optional[torch.Tensor] = None   # before any forcing
    own_bins: Optional[torch.Tensor] = None       # (2, B, T) pitch, energy
    own_targets: Optional[torch.Tensor] = None    # training, before forcing


def forward(W, cfg, texts, src_lens, t_cap=None, bf16_past=2048,
            mels=None, mel_lens=None, pitch=None, energy=None, gen=None,
            train=False, low=torch.bfloat16, force_durations=None,
            force_bins=None, force_targets=None):
    """Inference at the frame capacity ``t_cap`` (predicted durations), or
    the training forward (``mels`` etc. given: aligned durations,
    ground-truth pitch and energy, BatchNorm on the batch).  ``low`` is
    the dtype of self-attention past ``bf16_past`` frames.

    ``force_durations`` (B, L) and ``force_bins`` (2, B, t_cap) force the
    discrete decisions of inference (each phoneme's frames, each frame's
    pitch and energy bin) to those of the side being judged; the output
    still gives the reference's own decisions (``own_duration``,
    ``own_bins``), taken from its own predictions at each step.  In
    training, ``force_targets`` (B, L) forces the aligned durations (each
    frame's phoneme, by the aligner's argmax) the same way, and
    ``own_targets`` gives the reference's own."""
    tr, vp = cfg["transformer"], cfg["variance_predictor"]
    stats, n_bins = cfg["stats"], cfg["variance_embedding"]["n_bins"]
    dev = texts.device
    B, L = texts.shape
    src_valid = torch.arange(L, device=dev)[None, :] < src_lens[:, None]
    src_cap = torch.arange(L, device=dev) < src_lens.max()
    x = W["txt_encoder.src_word_emb.weight"][texts]
    x = stack(W, "txt_encoder", x, src_valid, src_cap, tr["encoder_layer"],
              tr["encoder_head"], tr["encoder_dropout"], gen, bf16_past, low)

    d_targets = guided = own_targets = None
    if mels is not None:
        T = mels.shape[1]
        frames = torch.arange(T, device=dev)
        mel_valid = frames[None, :] < mel_lens[:, None]
        mel_cap = frames < mel_lens.max()
        go = torch.where((frames > 0)[None, :, None], mels, 0.0)
        h = torch.relu(linear(W, "mel_encoder.prenet.w_2", torch.relu(
            linear(W, "mel_encoder.prenet.w_1", go))))
        h = dropout(h, 0.2, gen)
        h = h + positions(T, h.shape[2], dev)[None]
        nums = []
        for i in range(tr["decoder_layer"]):
            h, (idx, gnum) = fft_block(
                W, f"mel_encoder.layer_stack.{i}", h, mel_valid, mel_cap,
                tr["decoder_head"], tr["decoder_dropout"], gen, bf16_past,
                kv=x, kv_valid=src_valid,
                align=(src_lens, mel_lens, cfg["guided_sigma"]))
            nums.append(gnum)
        guided = torch.stack(nums)
        onehot = idx[..., None] == torch.arange(L, device=dev)
        counts = (onehot & mel_valid[..., None]).sum(dim=1)
        own_targets = torch.where(src_valid, counts, 0).to(torch.int32)
        d_targets = own_targets if force_targets is None else \
            force_targets.to(own_targets)
        max_len = T
    else:
        max_len = t_cap

    log_d = predictor(W, "variance_adaptor.duration_predictor", x,
                      src_valid, src_cap, vp["dropout"], gen)
    own_duration = torch.clamp(torch.round(torch.exp(log_d) - 1.0),
                               min=0.0) * src_valid
    if d_targets is not None:
        duration = d_targets
    elif force_durations is not None:
        duration = force_durations.to(own_duration)
    else:
        duration = own_duration
    x, up_lens = upsample(x, duration, max_len, src_valid.float(),
                          cfg["gaussian_sigma"])
    frames = torch.arange(max_len, device=dev)
    if d_targets is None:
        mel_lens = up_lens
        mel_valid = frames[None, :] < mel_lens[:, None]
        mel_cap = frames < mel_lens.max()

    preds, own = {}, []
    for j, (feat, target) in enumerate((("pitch", pitch),
                                        ("energy", energy))):
        pred = predictor(W, f"variance_adaptor.{feat}_predictor", x,
                         mel_valid, mel_cap, vp["dropout"], gen)
        b = bins(stats[f"{feat}_min"], stats[f"{feat}_max"], n_bins, dev)
        ids = torch.bucketize(pred if target is None else target, b)
        own.append(ids)
        if force_bins is not None and target is None:
            ids = force_bins[j].to(ids)
        x = x + rows(mel_cap, W[f"variance_adaptor.{feat}_embedding.weight"]
                     [ids])
        preds[feat] = pred

    x = stack(W, "mel_decoder", x, mel_valid, mel_cap, tr["decoder_layer"],
              tr["decoder_head"], tr["decoder_dropout"], gen, bf16_past, low)
    mel = linear(W, "mel_linear", x)
    post = postnet(W, rows(mel_cap, mel), mel_cap, gen, train) + mel
    return Output(mel, post, preds["pitch"], preds["energy"], log_d,
                  duration, mel_lens, mel_valid, src_valid, d_targets,
                  guided, own_duration, torch.stack(own), own_targets)


def masked_mean(x, valid):
    valid = torch.broadcast_to(valid, x.shape)
    return torch.where(valid, x, 0.0).sum() / torch.clamp(valid.sum(),
                                                          min=1)


def loss(out: Output, src_lens, mels, pitch, energy, alpha=10.0):
    """The seven terms (total first): mel and PostNet mel L1, MSE of the
    log durations against log(d + 1) of the aligned ones, of pitch and
    energy (frame level), and the guided-attention prior, each a mean
    over the valid positions (pairs for the prior)."""
    mv, sv = out.mel_valid, out.src_valid
    log_t = torch.log(out.duration_targets.float() + 1.0)
    p = masked_mean((out.pitch - pitch) ** 2, mv)
    e = masked_mean((out.energy - energy) ** 2, mv)
    d = masked_mean((out.log_duration - log_t) ** 2, sv)
    m = masked_mean((out.mel - mels).abs(), mv[:, :, None])
    pm = masked_mean((out.postnet_mel - mels).abs(), mv[:, :, None])
    pairs = (src_lens.float() * out.mel_lens.float()).sum()
    a = alpha * out.guided.sum() / torch.clamp(pairs, min=1.0)
    return torch.stack([m + pm + d + p + e + a, m, pm, p, e, d, a])


def shapes(cfg) -> dict[str, tuple[int, ...]]:
    """Every parameter and BatchNorm statistic of the model, by the port's
    state-dict name (the order of its state dict)."""
    tr, vp = cfg["transformer"], cfg["variance_predictor"]
    n_bins, n_mels = cfg["variance_embedding"]["n_bins"], \
        cfg["n_mel_channels"]
    out: dict[str, tuple[int, ...]] = {}

    def lin(name, n_in, n_out):
        out[name + ".weight"], out[name + ".bias"] = (n_out, n_in), (n_out,)

    def conv_(name, n_in, n_out, k):
        out[name + ".weight"], out[name + ".bias"] = (n_out, n_in, k), \
            (n_out,)

    def norm(name, n):
        out[name + ".weight"], out[name + ".bias"] = (n,), (n,)

    def stack_(name, d, n_layers, cross):
        attn = "crs_attn" if cross else "slf_attn"
        k1, k2 = tr["conv_kernel_size"]
        f = tr["conv_filter_size"]
        for i in range(n_layers):
            p = f"{name}.layer_stack.{i}"
            for w in ("w_qs", "w_ks", "w_vs", "fc"):
                lin(f"{p}.{attn}.{w}", d, d)
            norm(f"{p}.{attn}.layer_norm", d)
            conv_(f"{p}.pos_ffn.w_1", d, f, k1)
            conv_(f"{p}.pos_ffn.w_2", f, d, k2)
            norm(f"{p}.pos_ffn.layer_norm", d)

    de, dd = tr["encoder_hidden"], tr["decoder_hidden"]
    stack_("txt_encoder", de, tr["encoder_layer"], False)
    out["txt_encoder.src_word_emb.weight"] = (cfg["vocab_size"], de)
    stack_("mel_encoder", dd, tr["decoder_layer"], True)
    lin("mel_encoder.prenet.w_1", n_mels, dd)
    lin("mel_encoder.prenet.w_2", dd, dd)
    for feat in ("duration", "pitch", "energy"):
        p = f"variance_adaptor.{feat}_predictor"
        fv, kv = vp["filter_size"], vp["kernel_size"]
        conv_(f"{p}.conv_layer.conv1d_1.conv", de, fv, kv)
        norm(f"{p}.conv_layer.layer_norm_1", fv)
        conv_(f"{p}.conv_layer.conv1d_2.conv", fv, fv, kv)
        norm(f"{p}.conv_layer.layer_norm_2", fv)
        lin(f"{p}.linear_layer", fv, 1)
    for feat in ("pitch", "energy"):
        out[f"variance_adaptor.{feat}_embedding.weight"] = (n_bins, de)
    stack_("mel_decoder", dd, tr["decoder_layer"], False)
    lin("mel_linear", dd, n_mels)
    dims = [n_mels] + [512] * 4 + [n_mels]
    for i in range(5):
        conv_(f"postnet.convolutions.{i}.0.conv", dims[i], dims[i + 1], 5)
        p = f"postnet.convolutions.{i}.1"
        norm(p, dims[i + 1])
        out[p + ".running_mean"] = out[p + ".running_var"] = (dims[i + 1],)
    return out


def log_durations(W, cfg, texts, src_lens):
    """The duration predictor's output (B, L) at inference, and the valid
    mask."""
    tr, vp = cfg["transformer"], cfg["variance_predictor"]
    L = texts.shape[1]
    dev = texts.device
    valid = torch.arange(L, device=dev)[None, :] < src_lens[:, None]
    cap = torch.arange(L, device=dev) < src_lens.max()
    x = stack(W, "txt_encoder", W["txt_encoder.src_word_emb.weight"][texts],
              valid, cap, tr["encoder_layer"], tr["encoder_head"], 0.0, None,
              2048)
    return predictor(W, "variance_adaptor.duration_predictor", x, valid, cap,
                     0.0, None), valid
