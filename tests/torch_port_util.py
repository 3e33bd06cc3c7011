"""Helpers shared by the ``test_torch_*.py`` parity tests: building the JAX
reference trees and passing them to the PyTorch port as numpy arrays."""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(REPO, "benchmarks", "results")
FLAGSHIP_NPZ = os.path.join(RESULTS, "flagship_params.npz")
VOCODER_NPZ = os.path.join(RESULTS, "vocoder_params.npz")


def path_str(path) -> str:
    return "/".join(str(k.key) for k in path)


def flatten(variables) -> dict[str, np.ndarray]:
    """Flax variables → {"params/a/b/kernel": numpy array}."""
    leaves = jax.tree_util.tree_flatten_with_path(variables)[0]
    return {path_str(p): np.asarray(x) for p, x in leaves}


def init_acoustic(cfg=None, pre=None):
    """The JAX ``FastSpeech2Align`` and the shapes of its variables on the
    training path, MelEncoder included, as ``bench.py`` builds the committed
    tree (traced, not run: nothing is compiled).  A speaker id is passed, so
    a multi-speaker config gets its speaker embedding."""
    from smart_nar_fast_tts_tpu.config import ModelConfig, PreprocessConfig
    from smart_nar_fast_tts_tpu.models import FastSpeech2Align
    model = FastSpeech2Align(cfg or ModelConfig(), pre or PreprocessConfig())
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32),
        jnp.asarray([8], jnp.int32), mels=jnp.zeros((1, 8, 80)),
        mel_lens=jnp.asarray([8], jnp.int32),
        p_targets=jnp.zeros((1, 8)), e_targets=jnp.zeros((1, 8)),
        speakers=jnp.zeros((1,), jnp.int32)))
    return model, shapes


def init_hifigan(config=None):
    """The JAX ``HiFiGANGenerator`` and the shapes of its variables."""
    from smart_nar_fast_tts_tpu.vocoder import HiFiGANConfig, HiFiGANGenerator
    gen = HiFiGANGenerator(config or HiFiGANConfig())
    shapes = jax.eval_shape(lambda: gen.init(jax.random.PRNGKey(1),
                                             jnp.zeros((1, 16, 80))))
    return gen, shapes


def random_variables(shapes, seed: int):
    """Seeded numpy values for a tree of shapes: kernels scaled by
    1/sqrt(fan-in) as an init would, embeddings unit normal, biases and
    running means small, norm scales and running variances around 1."""
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = path_str(path).rsplit("/", 1)[-1]
        a = np.asarray(rng.randn(*s.shape))
        if name == "kernel":
            a = a / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ("scale", "var"):
            a = np.abs(1.0 + 0.2 * a)
        elif name != "embedding":
            a = 0.2 * a
        return a.astype(s.dtype)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def zeros(shapes):
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)


def scaled_model_config():
    """The JAX ``ModelConfig`` of the committed 8-speaker flagship
    (``configs/scaled/model.yaml``)."""
    from smart_nar_fast_tts_tpu.config import Config
    scaled = os.path.join(REPO, "configs", "scaled")
    return Config.from_yaml_triplet(
        *(os.path.join(scaled, f"{n}.yaml")
          for n in ("preprocess", "model", "train"))).model


def jax_leaf_index(kind: str) -> list[list]:
    """[[flax path, shape], ...] in JAX flatten order for the committed
    flagship (``"flagship"``), 8-speaker flagship (``"scaled_flagship"``)
    or HiFi-GAN (``"hifigan"``) tree."""
    if kind == "hifigan":
        _, shapes = init_hifigan()
    else:
        _, shapes = init_acoustic(
            scaled_model_config() if kind == "scaled_flagship" else None)
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    return [[path_str(p), list(s.shape)] for p, s in leaves]


def write_leaf_indexes() -> None:
    """Regenerate ``smart_nar_fast_tts_tpu_torch/assets/*_leaves.json``."""
    assets = os.path.join(REPO, "smart_nar_fast_tts_tpu_torch", "assets")
    for kind, source in (("flagship", "benchmarks/results/flagship_params"
                          ".npz"),
                         ("scaled_flagship", "benchmarks/results/"
                          "scaled_flagship_params.npz"),
                         ("hifigan", "benchmarks/results/vocoder_params.npz")):
        doc = {"source": source,
               "order": "jax.tree_util.tree_flatten_with_path of the "
                        "variables, leaf i stored as l{i:05d}",
               "leaves": jax_leaf_index(kind)}
        with open(os.path.join(assets, f"{kind}_leaves.json"), "w") as f:
            json.dump(doc, f, separators=(",", ":"))
            f.write("\n")



TINY_HIFIGAN = {"resblock": "1", "upsample_rates": [8, 8, 2, 2],
                "upsample_kernel_sizes": [16, 16, 4, 4],
                "upsample_initial_channel": 32,
                "resblock_kernel_sizes": [3, 7, 11],
                "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
                "num_mels": 80, "sampling_rate": 22050}


def write_upstream_hifigan(directory, config: dict = TINY_HIFIGAN,
                           seed: int = 0) -> str:
    """A HiFi-GAN generator checkpoint in the upstream torch layout:
    ``{"generator": state_dict}`` with every conv weight-normed
    (``weight_g``, ``weight_v``), seeded, and its ``config.json`` beside
    it.  Returns the checkpoint's path."""
    import torch
    from smart_nar_fast_tts_tpu_torch.vocoder import (HiFiGANConfig,
                                                      HiFiGANGenerator)
    rng = np.random.RandomState(seed)
    gen = HiFiGANGenerator(HiFiGANConfig.from_dict(config))
    sd = {}
    for key, value in gen.state_dict().items():
        shape = tuple(value.shape)
        if key.endswith(".weight"):
            # each output slice's norm g in [0.5, ~2): weights of about
            # 1/sqrt(fan-in), as an init would give
            base = key[:-len(".weight")]
            sd[base + ".weight_v"] = torch.from_numpy(
                rng.randn(*shape).astype(np.float32))
            sd[base + ".weight_g"] = torch.from_numpy(
                (0.5 + 0.5 * np.abs(rng.randn(shape[0], 1, 1))).astype(
                    np.float32))
        else:
            sd[key] = torch.from_numpy(
                0.05 * rng.randn(*shape).astype(np.float32))
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(str(directory), "generator.pth.tar")
    torch.save({"generator": sd}, path)
    with open(os.path.join(str(directory), "config.json"), "w") as f:
        json.dump(config, f)
    return path
