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


def jax_leaf_index(kind: str) -> list[list]:
    """[[flax path, shape], ...] in JAX flatten order for the committed
    flagship (``"flagship"``) or HiFi-GAN (``"hifigan"``) tree."""
    _, shapes = init_acoustic() if kind == "flagship" else init_hifigan()
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    return [[path_str(p), list(s.shape)] for p, s in leaves]


def write_leaf_indexes() -> None:
    """Regenerate ``smart_nar_fast_tts_tpu_torch/assets/*_leaves.json``."""
    assets = os.path.join(REPO, "smart_nar_fast_tts_tpu_torch", "assets")
    for kind, source in (("flagship", "benchmarks/results/flagship_params"
                          ".npz"),
                         ("hifigan", "benchmarks/results/vocoder_params.npz")):
        doc = {"source": source,
               "order": "jax.tree_util.tree_flatten_with_path of the "
                        "variables, leaf i stored as l{i:05d}",
               "leaves": jax_leaf_index(kind)}
        with open(os.path.join(assets, f"{kind}_leaves.json"), "w") as f:
            json.dump(doc, f, separators=(",", ":"))
            f.write("\n")

