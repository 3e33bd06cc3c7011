"""Model FLOPs from the configuration alone, at each item's valid lengths.

Counted as ``torch.utils.flop_counter.FlopCounterMode`` counts the plain
reference: 2·m·n·k for each matrix product and 2·out·in·kernel for each
output position of a convolution (biases, norms, activations, the
softmax, gathers and FFTs are not counted).  A backward counts the product
again for each operand that needs a gradient.  Padding is never counted,
so an implementation that skips it reads as doing more of the model's work
per second.
"""

from __future__ import annotations


def _lin(n, i, o):
    return 2 * n * i * o


def _fft(n, nk, d, f, k1, k2):
    """One FFT block's forward: projections, attention products, FFN."""
    proj = _lin(n, d, d) * 2 + _lin(nk, d, d) * 2      # q, fc ; k, v
    attn = 2 * (2 * n * nk * d)                        # QKᵀ and PV
    ffn = _lin(n, d * k1, f) + _lin(n, f * k2, d)
    return proj + attn + ffn


def _predictor(n, d, fv, kv):
    return _lin(n, d * kv, fv) + _lin(n, fv * kv, fv) + _lin(n, fv, 1)


def _postnet(t, n_mels):
    dims = [n_mels] + [512] * 4 + [n_mels]
    return sum(_lin(t, dims[i] * 5, dims[i + 1]) for i in range(5))


def acoustic_forward(a: dict, L: int, T: int) -> int:
    """Inference FLOPs of one item of L phonemes and T frames."""
    tr, vp = a["transformer"], a["variance_predictor"]
    de, dd, f = tr["encoder_hidden"], tr["decoder_hidden"], \
        tr["conv_filter_size"]
    k1, k2 = tr["conv_kernel_size"]
    n_mels = a["n_mel_channels"]
    out = tr["encoder_layer"] * _fft(L, L, de, f, k1, k2)
    out += _predictor(L, de, vp["filter_size"], vp["kernel_size"])
    out += 2 * L * T * de                                      # upsampling
    out += 2 * _predictor(T, de, vp["filter_size"], vp["kernel_size"])
    out += tr["decoder_layer"] * _fft(T, T, dd, f, k1, k2)
    out += _lin(T, dd, n_mels) + _postnet(T, n_mels)
    return out


def acoustic_train(a: dict, L: int, T: int) -> int:
    """Forward and backward FLOPs of one training item: the inference
    path at T frames plus the aligner (prenet, cross-attention blocks).
    The aligner's last block reaches the loss only through head 0's
    scores, so its V, PV, fc and FFN take no backward."""
    tr = a["transformer"]
    de, dd, f = tr["encoder_hidden"], tr["decoder_hidden"], \
        tr["conv_filter_size"]
    k1, k2 = tr["conv_kernel_size"]
    n_mels = a["n_mel_channels"]
    fwd = acoustic_forward(a, L, T)
    n_al = tr["decoder_layer"]
    prenet = _lin(T, n_mels, dd) + _lin(T, dd, dd)
    aligner = n_al * _fft(T, L, dd, f, k1, k2)
    fwd += prenet + aligner
    # backward: 2x every product whose input needs a gradient; the
    # prenet's first layer (input: the target mels) and the upsampling
    # product (its weights come from the aligned durations) 1x
    bwd = 2 * (fwd - prenet - aligner - 2 * L * T * de)
    bwd += _lin(T, n_mels, dd) + 2 * _lin(T, dd, dd) + 2 * L * T * de
    full = _fft(T, L, dd, f, k1, k2)
    last = _lin(T, dd, dd) + _lin(L, dd, dd) + 2 * T * L * dd   # q, k, QKᵀ
    bwd += 2 * ((n_al - 1) * full + last)
    return fwd + bwd


def hifigan(v: dict, T: int) -> int:
    """FLOPs of HiFi-GAN on T frames."""
    ch = v["upsample_initial_channel"]
    out = _lin(T, v["n_mels"] * 7, ch)
    n = T
    for u, k in zip(v["upsample_rates"], v["upsample_kernel_sizes"]):
        c = ch // 2
        out += _lin(n, ch * k, c)              # transposed: input positions
        n *= u
        for rk, rd in zip(v["resblock_kernel_sizes"],
                          v["resblock_dilation_sizes"]):
            out += 2 * len(rd) * _lin(n, c * rk, c)
        ch = c
    return out + _lin(n, ch * 7, 1)


def vocos(v: dict, T: int) -> int:
    """FLOPs of Vocos on T frames (the inverse STFT is an FFT: not
    counted)."""
    d, m = v["dim"], v["intermediate"]
    per = _lin(T, v["dw_kernel"], d) + _lin(T, d, m) + _lin(T, m, d)
    return (_lin(T, v["n_mels"] * 7, d) + v["n_layers"] * per
            + _lin(T, d, 2 * (v["n_fft"] // 2 + 1)))


def vocoder(v: dict, T: int) -> int:
    return {"hifigan": hifigan, "vocos": vocos}[v["family"]](v, T)
