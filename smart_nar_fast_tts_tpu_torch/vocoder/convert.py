"""Vocoder checkpoint loading: the HiFi-GAN, Vocos and MelGAN generators of
torch files and of the JAX package's flax ``.msgpack`` files.

The loading contract of ``smart_nar_fast_tts_tpu/vocoder/convert.py``
(reference ``utils/model.py:53-65``), by the ``family`` of the
``config.json`` beside the checkpoint (``"hifigan"`` when absent, the
reference's layout; ``"vocos"``; ``"melgan"``), whose other keys override
the family's default config.  Two formats per family, told apart by the
file's name:

- ``*.msgpack``: ``flax.serialization.to_bytes`` of the generator's params,
  as the JAX CLI writes them, read with numpy (``vocoder/msgpack.py``) and
  mapped by ``weights.<family>_rules``;
- any other file: a torch file holding ``{"generator": state_dict}``
  (upstream's ``generator_*.pth.tar``, which the port's
  ``cli.train_vocoder`` writes for every family) or the state dict itself
  (descript's torch.hub MelGAN weights), weight norm folded on the host.
  The port's generators keep upstream's module names, so the folded state
  dict loads as it is.
"""

from __future__ import annotations

import json
import os
from typing import Mapping

import numpy as np
import torch

from .hifigan import HiFiGANConfig, HiFiGANGenerator
from .melgan import MelGANConfig, MelGANGenerator
from .vocos import VocosConfig, VocosGenerator

FAMILIES = {"hifigan": (HiFiGANConfig, HiFiGANGenerator),
            "vocos": (VocosConfig, VocosGenerator),
            "melgan": (MelGANConfig, MelGANGenerator)}


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


def _read_config(config_path: str | None) -> tuple[str, dict | None]:
    """(family, the config's other keys or None) of a ``config.json``."""
    if not config_path:
        return "hifigan", None
    with open(config_path) as f:
        d = json.load(f)
    return d.pop("family", "hifigan"), d


def generator_state(family: str, ckpt_path: str, config
                    ) -> dict[str, torch.Tensor]:
    """The state dict of a ``family`` generator of ``config`` from a
    checkpoint: a flax ``.msgpack`` through the family's rules, else a
    torch file with weight norm folded."""
    if ckpt_path.endswith(".msgpack"):
        from .. import weights
        from .msgpack import read_flax_msgpack
        with open(ckpt_path, "rb") as f:
            flat = read_flax_msgpack(f.read())
        return getattr(weights, f"jax_to_torch_{family}")(flat, config)
    raw = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    sd = raw.get("generator", raw) if isinstance(raw, dict) else raw
    sd = fold_weight_norm({k: v.numpy() if hasattr(v, "numpy")
                           else np.asarray(v) for k, v in sd.items()})
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for k, v in sd.items()}


def _load(family: str, ckpt_path: str, cfg_dict: dict | None
          ) -> torch.nn.Module:
    if family not in FAMILIES:
        raise ValueError(f"unknown vocoder family {family!r}")
    cfg_cls, gen_cls = FAMILIES[family]
    config = cfg_cls.from_dict(cfg_dict) if cfg_dict else cfg_cls()
    gen = gen_cls(config)
    gen.load_state_dict(generator_state(family, ckpt_path, config))
    return gen.eval()


def load_hifigan(ckpt_path: str, config_path: str | None = None
                 ) -> HiFiGANGenerator:
    """The HiFi-GAN generator of a torch checkpoint (``{"generator":
    state_dict}`` or the state dict, weight-normed or folded) or of a flax
    ``.msgpack``, on the CPU in eval mode.  A ``config.json`` beside the
    checkpoint overrides the V1 defaults."""
    config_path = _config_path(ckpt_path, config_path)
    return _load("hifigan", ckpt_path, _read_config(config_path)[1])


def load_melgan(ckpt_path: str, config_path: str | None = None
                ) -> MelGANGenerator:
    """The MelGAN generator of descript's torch.hub weights (the state dict
    itself, weight-normed), of a ``{"generator": state_dict}`` file or of a
    flax ``.msgpack``, on the CPU in eval mode.  A ``config.json`` beside
    the checkpoint overrides the defaults (descript's ngf 32, ratios 8, 8,
    2, 2)."""
    config_path = _config_path(ckpt_path, config_path)
    return _load("melgan", ckpt_path, _read_config(config_path)[1])


def load_vocoder(ckpt_path: str, config_path: str | None = None
                 ) -> torch.nn.Module:
    """The generator of any family, by the ``family`` key of the sibling
    ``config.json`` ("hifigan" | "vocos" | "melgan"; absent → HiFi-GAN, the
    reference's layout), on the CPU in eval mode.  An unknown family
    raises."""
    family, cfg_dict = _read_config(_config_path(ckpt_path, config_path))
    return _load(family, ckpt_path, cfg_dict)
