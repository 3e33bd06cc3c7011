"""The JAX package's parameters → state dicts of the port's modules.

Checkpoints are flat dicts from the flax path (``"params/txt_encoder/
layer_0/attn/w_q/kernel"``, ``"batch_stats/postnet/bn_0/mean"``) to a numpy
array.  The committed ``.npz`` files store the leaves positionally
(``l00000``, … in JAX flatten order); :func:`load_committed` names them from
a committed index (``assets/*_leaves.json``) with numpy alone.

Layout rules (the inverse of ``models/convert.py`` and
``vocoder/convert.py`` of the JAX package):

- Dense kernel (in, out) → Linear weight (out, in).
- Conv kernel (k, in, out) → Conv1d weight (out, in, k); a 2-D conv
  kernel (kh, kw, in, out) → Conv2d weight (out, in, kh, kw).
- ConvTranspose kernel (k, in, out), in the lhs-dilated form → torch
  (in, out, k), flipped along k.
- LayerNorm/BatchNorm scale → weight; BatchNorm batch_stats mean/var →
  running_mean/running_var; Embed embedding → Embedding weight.

The maps are linear, so :func:`jax_params_to_torch` carries any tree shaped
like ``params`` (a gradient, an optimizer update) into the port's key space
by the same rules.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from .config import ModelConfig
from .vocoder.discriminators import HiFiGANDiscriminator
from .vocoder.hifigan import HiFiGANConfig
from .vocoder.melgan import MelGANConfig
from .vocoder.vocos import VocosConfig

ASSETS = Path(__file__).resolve().parent / "assets"
FLAGSHIP_INDEX = ASSETS / "flagship_leaves.json"
HIFIGAN_INDEX = ASSETS / "hifigan_leaves.json"
VOCOS_INDEX = ASSETS / "vocos_leaves.json"
MELGAN_INDEX = ASSETS / "melgan_leaves.json"

Rule = tuple[str, Callable[[np.ndarray], np.ndarray]]


def _same(a):
    return a


def _dense_t(a):
    return a.T


def _conv_t(a):
    return a.transpose(2, 1, 0)


def _conv_transpose_t(a):
    return a[::-1].transpose(1, 2, 0)


def _dense(rules, tkey, fpath):
    rules[tkey + ".weight"] = (fpath + "/kernel", _dense_t)
    rules[tkey + ".bias"] = (fpath + "/bias", _same)


def _conv(rules, tkey, fpath):
    rules[tkey + ".weight"] = (fpath + "/kernel", _conv_t)
    rules[tkey + ".bias"] = (fpath + "/bias", _same)


def _norm(rules, tkey, fpath):
    rules[tkey + ".weight"] = (fpath + "/scale", _same)
    rules[tkey + ".bias"] = (fpath + "/bias", _same)


def acoustic_rules(cfg: ModelConfig = ModelConfig()) -> dict[str, Rule]:
    """{port state-dict key: (flax path, layout transform)} for
    :class:`~.models.FastSpeech2Align`."""
    r: dict[str, Rule] = {}
    t = cfg.transformer
    r["txt_encoder.src_word_emb.weight"] = (
        "params/txt_encoder/src_word_emb/embedding", _same)
    _dense(r, "mel_encoder.prenet.w_1", "params/mel_encoder/prenet/w_1")
    _dense(r, "mel_encoder.prenet.w_2", "params/mel_encoder/prenet/w_2")
    for stack, n_layers, attn in (
            ("txt_encoder", t.encoder_layer, "slf_attn"),
            ("mel_encoder", t.decoder_layer, "crs_attn"),
            ("mel_decoder", t.decoder_layer, "slf_attn")):
        for i in range(n_layers):
            tp, fp = f"{stack}.layer_stack.{i}", f"params/{stack}/layer_{i}"
            for tname, fname in (("w_qs", "w_q"), ("w_ks", "w_k"),
                                 ("w_vs", "w_v"), ("fc", "fc")):
                _dense(r, f"{tp}.{attn}.{tname}", f"{fp}/attn/{fname}")
            _norm(r, f"{tp}.{attn}.layer_norm", f"{fp}/attn/layer_norm")
            _conv(r, f"{tp}.pos_ffn.w_1", f"{fp}/pos_ffn/w_1")
            _conv(r, f"{tp}.pos_ffn.w_2", f"{fp}/pos_ffn/w_2")
            _norm(r, f"{tp}.pos_ffn.layer_norm", f"{fp}/pos_ffn/layer_norm")
    for name in ("duration_predictor", "pitch_predictor", "energy_predictor"):
        tp = f"variance_adaptor.{name}"
        fp = f"params/variance_adaptor/{name}"
        _conv(r, f"{tp}.conv_layer.conv1d_1.conv", f"{fp}/conv1d_1")
        _norm(r, f"{tp}.conv_layer.layer_norm_1", f"{fp}/layer_norm_1")
        _conv(r, f"{tp}.conv_layer.conv1d_2.conv", f"{fp}/conv1d_2")
        _norm(r, f"{tp}.conv_layer.layer_norm_2", f"{fp}/layer_norm_2")
        _dense(r, f"{tp}.linear_layer", f"{fp}/linear_layer")
    for name in ("pitch_embedding", "energy_embedding"):
        r[f"variance_adaptor.{name}.weight"] = (
            f"params/variance_adaptor/{name}/embedding", _same)
    _dense(r, "mel_linear", "params/mel_linear")
    for i in range(5):
        tp = f"postnet.convolutions.{i}"
        _conv(r, f"{tp}.0.conv", f"params/postnet/conv_{i}")
        _norm(r, f"{tp}.1", f"params/postnet/bn_{i}")
        r[f"{tp}.1.running_mean"] = (f"batch_stats/postnet/bn_{i}/mean", _same)
        r[f"{tp}.1.running_var"] = (f"batch_stats/postnet/bn_{i}/var", _same)
    if cfg.multi_speaker:
        r["speaker_emb.weight"] = ("params/speaker_emb/embedding", _same)
    return r


def hifigan_rules(config: HiFiGANConfig = HiFiGANConfig()
                  ) -> dict[str, Rule]:
    """{port state-dict key: (flax path, layout transform)} for
    :class:`~.vocoder.HiFiGANGenerator`."""
    r: dict[str, Rule] = {}
    _conv(r, "conv_pre", "params/conv_pre/conv")
    _conv(r, "conv_post", "params/conv_post/conv")
    n_kernels = len(config.resblock_kernel_sizes)
    for i in range(len(config.upsample_rates)):
        r[f"ups.{i}.weight"] = (f"params/ups_{i}/kernel", _conv_transpose_t)
        r[f"ups.{i}.bias"] = (f"params/ups_{i}/bias", _same)
        for j, dils in enumerate(config.resblock_dilation_sizes):
            tp = f"resblocks.{i * n_kernels + j}"
            fp = f"params/resblocks_{i}_{j}"
            for m in range(len(dils)):
                if str(config.resblock) == "1":
                    _conv(r, f"{tp}.convs1.{m}", f"{fp}/convs1_{m}/conv")
                    _conv(r, f"{tp}.convs2.{m}", f"{fp}/convs2_{m}/conv")
                else:
                    _conv(r, f"{tp}.convs.{m}", f"{fp}/convs_{m}/conv")
    return r


def vocos_rules(config: VocosConfig = VocosConfig()) -> dict[str, Rule]:
    """{port state-dict key: (flax path, layout transform)} for
    :class:`~.vocoder.VocosGenerator`.  The depthwise kernel (k, 1, dim)
    takes the Conv rule: (dim, 1, k)."""
    r: dict[str, Rule] = {}
    _conv(r, "embed", "params/embed")
    _norm(r, "norm_in", "params/norm_in")
    for i in range(config.n_layers):
        tp, fp = f"blocks.{i}", f"params/block_{i}"
        _conv(r, f"{tp}.dwconv", f"{fp}/dwconv")
        _norm(r, f"{tp}.norm", f"{fp}/norm")
        _dense(r, f"{tp}.pw1", f"{fp}/pw1")
        _dense(r, f"{tp}.pw2", f"{fp}/pw2")
        r[f"{tp}.gamma"] = (f"{fp}/gamma", _same)
    _norm(r, "norm_out", "params/norm_out")
    _dense(r, "head", "params/head")
    return r


def melgan_rules(config: MelGANConfig = MelGANConfig()) -> dict[str, Rule]:
    """{port state-dict key: (flax path, layout transform)} for
    :class:`~.vocoder.MelGANGenerator`, whose keys are descript's
    ``nn.Sequential`` indices: [pad, conv7, (lrelu, convT, resnet
    blocks)·ratios, lrelu, pad, conv7, tanh]."""
    r: dict[str, Rule] = {}
    _conv(r, "model.1", "params/conv_pre/conv")
    idx = 2
    for i in range(len(config.ratios)):
        idx += 1                                   # LeakyReLU
        r[f"model.{idx}.weight"] = (f"params/ups_{i}/kernel",
                                    _conv_transpose_t)
        r[f"model.{idx}.bias"] = (f"params/ups_{i}/bias", _same)
        idx += 1
        for j in range(config.n_residual_layers):
            tp, fp = f"model.{idx}", f"params/res_{i}_{j}"
            _conv(r, f"{tp}.block.2", f"{fp}/block_conv1/conv")
            _conv(r, f"{tp}.block.4", f"{fp}/block_conv2/conv")
            _conv(r, f"{tp}.shortcut", f"{fp}/shortcut/conv")
            idx += 1
    idx += 2                                       # LeakyReLU, pad
    _conv(r, f"model.{idx}", "params/conv_post/conv")
    return r


def _conv2d_t(a):
    return a.transpose(3, 2, 0, 1)


def discriminator_rules(periods: Sequence[int], n_period_convs: int,
                        n_scales: int, n_scale_convs: int
                        ) -> dict[str, Rule]:
    """{port state-dict key: (flax path, layout transform)} for
    :class:`~.vocoder.discriminators.HiFiGANDiscriminator` with
    ``n_period_convs`` strided convs per period and ``n_scale_convs`` convs
    before ``conv_post`` per scale.

    Weight norm: the raw kernel → ``weight``, the ``WeightNorm_i`` scale →
    ``scale``.  Spectral norm (scale 0): the raw kernel → ``weight``, and
    the ``batch_stats`` ``u`` and ``sigma`` → the buffers.  An MPD kernel
    (5, 1, in, out) → (out, in, 5, 1); an MSD kernel (k, in/g, out) →
    (out, in/g, k)."""
    r: dict[str, Rule] = {}
    for i, p in enumerate(periods):
        names = [f"conv_{j}" for j in range(n_period_convs)] + [
            "conv_4", "conv_post"]
        keys = [f"convs.{j}" for j in range(n_period_convs)] + [
            "conv_4", "conv_post"]
        for j, (name, key) in enumerate(zip(names, keys)):
            tp, fp = f"mpd.{i}.{key}", f"params/mpd_period_{p}"
            r[f"{tp}.weight"] = (f"{fp}/{name}/kernel", _conv2d_t)
            r[f"{tp}.bias"] = (f"{fp}/{name}/bias", _same)
            r[f"{tp}.scale"] = (f"{fp}/WeightNorm_{j}/{name}/kernel/scale",
                                _same)
    for s in range(n_scales):
        names = [f"conv_{j}" for j in range(n_scale_convs)] + ["conv_post"]
        keys = [f"convs.{j}" for j in range(n_scale_convs)] + ["conv_post"]
        for j, (name, key) in enumerate(zip(names, keys)):
            tp, fp = f"msd.scales.{s}.{key}", f"params/msd/scale_{s}"
            _conv(r, tp, f"{fp}/{name}")
            if s == 0:
                sp = f"batch_stats/msd/scale_0/SpectralNorm_{j}/{name}/kernel"
                r[f"{tp}.u"] = (f"{sp}/u", _same)
                r[f"{tp}.sigma"] = (f"{sp}/sigma", _same)
            else:
                r[f"{tp}.scale"] = (
                    f"{fp}/WeightNorm_{j}/{name}/kernel/scale", _same)
    return r


def _apply_rules(flat: Mapping[str, np.ndarray], rules: dict[str, Rule]
                 ) -> dict[str, torch.Tensor]:
    """Fill every key of ``rules`` from ``flat``; every leaf of ``flat``
    must be used exactly once."""
    used = [fpath for fpath, _ in rules.values()]
    used_set = set(used)
    if len(used_set) != len(used):
        raise ValueError("a checkpoint leaf is mapped twice")
    missing = [p for p in used if p not in flat]
    unused = [p for p in flat if p not in used_set]
    if missing or unused:
        raise KeyError(f"checkpoint does not match the module: missing "
                       f"{missing[:5]}, unused {unused[:5]}")
    return {tkey: torch.from_numpy(np.array(fn(flat[fpath]), np.float32))
            for tkey, (fpath, fn) in rules.items()}


def jax_to_torch_acoustic(flat: Mapping[str, np.ndarray],
                          cfg: ModelConfig = ModelConfig()
                          ) -> dict[str, torch.Tensor]:
    """Flat flax variables of ``FastSpeech2Align`` → the port's state dict."""
    return _apply_rules(flat, acoustic_rules(cfg))


def jax_params_to_torch(flat: Mapping[str, np.ndarray],
                        cfg: ModelConfig = ModelConfig()
                        ) -> dict[str, torch.Tensor]:
    """A flat tree shaped like ``FastSpeech2Align``'s ``params`` (keys
    ``"params/…"``: the parameters, a gradient or an update) → the port's
    parameter names, by the same linear maps."""
    rules = {k: r for k, r in acoustic_rules(cfg).items()
             if r[0].startswith("params/")}
    return _apply_rules(flat, rules)


def jax_to_torch_hifigan(flat: Mapping[str, np.ndarray],
                         config: HiFiGANConfig = HiFiGANConfig()
                         ) -> dict[str, torch.Tensor]:
    """Flat flax params of ``HiFiGANGenerator`` → the port's state dict."""
    return _apply_rules(flat, hifigan_rules(config))


def jax_to_torch_vocos(flat: Mapping[str, np.ndarray],
                       config: VocosConfig = VocosConfig()
                       ) -> dict[str, torch.Tensor]:
    """Flat flax params of ``VocosGenerator`` → the port's state dict."""
    return _apply_rules(flat, vocos_rules(config))


def jax_to_torch_melgan(flat: Mapping[str, np.ndarray],
                        config: MelGANConfig = MelGANConfig()
                        ) -> dict[str, torch.Tensor]:
    """Flat flax params of ``MelGANGenerator`` → the port's state dict."""
    return _apply_rules(flat, melgan_rules(config))


def jax_to_torch_discriminator(flat: Mapping[str, np.ndarray],
                               disc: HiFiGANDiscriminator
                               ) -> dict[str, torch.Tensor]:
    """Flat flax variables of ``HiFiGANDiscriminator`` (``params`` and the
    spectral-norm ``batch_stats``) → the state dict of ``disc``, a port
    discriminator of the same configuration."""
    return _apply_rules(flat, discriminator_rules(
        [d.period for d in disc.mpd], len(disc.mpd[0].convs),
        len(disc.msd.scales), len(disc.msd.scales[0].convs)))


def load_committed(npz_path: str | Path, index_path: str | Path
                   ) -> dict[str, np.ndarray]:
    """Read a positional-leaf ``.npz`` into {flax path: array}, naming the
    leaves from the committed index; float16 leaves are upcast to float32."""
    with open(index_path) as f:
        leaves = json.load(f)["leaves"]
    out = {}
    with np.load(npz_path) as npz:
        if len(npz.files) != len(leaves):
            raise ValueError(f"{npz_path}: {len(npz.files)} leaves, index "
                             f"{index_path} lists {len(leaves)}")
        for i, (path, shape) in enumerate(leaves):
            a = npz[f"l{i:05d}"]
            if a.shape != tuple(shape):
                raise ValueError(f"leaf {i} ({path}): stored {a.shape}, "
                                 f"index {tuple(shape)}")
            out[path] = a.astype(np.float32) if a.dtype == np.float16 else a
    return out
