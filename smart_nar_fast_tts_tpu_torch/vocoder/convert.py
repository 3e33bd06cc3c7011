"""HiFi-GAN checkpoint loading: upstream torch generator checkpoints → the
port's :class:`~.hifigan.HiFiGANGenerator`.

The loading contract of ``smart_nar_fast_tts_tpu/vocoder/convert.py``
(reference ``utils/model.py:53-65``): a torch file holding
``{"generator": state_dict}`` (upstream's ``generator_*.pth.tar``) or the
state dict itself, weight norm folded on the host, and a ``config.json``
beside the checkpoint overriding the V1 defaults (``"resblock": "2"``
for V3, whose ResBlock2s hold one ``convs`` list).  The port's generator
keeps upstream's module names with weight norm folded, so the folded state
dict loads as it is.  The JAX package's ``.msgpack`` flax files and its
Vocos and MelGAN families are not ported yet (ROADMAP §A.5, §A.7).
"""

from __future__ import annotations

import json
import os
from typing import Mapping

import numpy as np
import torch

from .hifigan import HiFiGANConfig, HiFiGANGenerator


def fold_weight_norm(sd: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Fold ``X.weight_g``/``X.weight_v`` pairs into plain ``X.weight``
    (torch weight_norm, dim=0: per-slice-0 gain times direction)."""
    out: dict[str, np.ndarray] = {}
    for key, val in sd.items():
        if key.endswith(".weight_g"):
            continue
        if key.endswith(".weight_v"):
            base = key[: -len(".weight_v")]
            g = np.asarray(sd[base + ".weight_g"], np.float64)
            v = np.asarray(val, np.float64)
            axes = tuple(range(1, v.ndim))
            norm = np.sqrt(np.sum(v * v, axis=axes, keepdims=True))
            out[base + ".weight"] = (g * v / norm).astype(np.float32)
        else:
            out[key] = np.asarray(val)
    return out


def _config_path(ckpt_path: str, config_path: str | None) -> str | None:
    if config_path is None:
        cand = os.path.join(os.path.dirname(ckpt_path), "config.json")
        config_path = cand if os.path.isfile(cand) else None
    return config_path


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP §A.5: the Vocos and MelGAN "
        "generators; §A.7: importing the JAX package's checkpoints); pass an "
        "upstream HiFi-GAN torch checkpoint")


def load_hifigan(ckpt_path: str, config_path: str | None = None
                 ) -> HiFiGANGenerator:
    """The HiFi-GAN generator of a torch checkpoint (``{"generator":
    state_dict}`` or the state dict, weight-normed or folded), on the CPU in
    eval mode.  A ``config.json`` beside the checkpoint overrides the V1
    defaults."""
    if ckpt_path.endswith(".msgpack"):
        raise _not_ported("a .msgpack (flax) vocoder checkpoint")
    config_path = _config_path(ckpt_path, config_path)
    config = HiFiGANConfig()
    if config_path:
        with open(config_path) as f:
            config = HiFiGANConfig.from_dict(json.load(f))
    raw = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    sd = raw.get("generator", raw) if isinstance(raw, dict) else raw
    sd = fold_weight_norm({k: v.numpy() if hasattr(v, "numpy")
                           else np.asarray(v) for k, v in sd.items()})
    gen = HiFiGANGenerator(config)
    gen.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(
        v, np.float32)) for k, v in sd.items()})
    return gen.eval()


def load_vocoder(ckpt_path: str, config_path: str | None = None
                 ) -> HiFiGANGenerator:
    """Family-aware loader: the ``family`` key of the sibling
    ``config.json`` ("hifigan" | "vocos" | "melgan"; absent → HiFi-GAN, the
    reference's layout).  Only HiFi-GAN is ported."""
    config_path = _config_path(ckpt_path, config_path)
    family = "hifigan"
    if config_path:
        with open(config_path) as f:
            family = json.load(f).get("family", "hifigan")
    if family == "hifigan":
        return load_hifigan(ckpt_path, config_path)
    if family in ("vocos", "melgan"):
        raise _not_ported(f"the {family} vocoder family")
    raise ValueError(f"unknown vocoder family {family!r}")
