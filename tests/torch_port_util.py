"""Helpers shared by the ``test_torch_*.py`` parity tests: building the JAX
reference trees and passing them to the PyTorch port as numpy arrays."""

from __future__ import annotations

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

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


def committed_config(family: str):
    """The JAX config of a committed vocoder (``"vocos"`` or ``"melgan"``)
    from its ``<family>_meta.json``."""
    from smart_nar_fast_tts_tpu.vocoder import MelGANConfig, VocosConfig
    with open(os.path.join(RESULTS, f"{family}_meta.json")) as f:
        config = json.load(f)["config"]
    return {"vocos": VocosConfig, "melgan": MelGANConfig}[family].from_dict(
        config)


def init_vocoder(family: str, config=None):
    """The JAX HiFi-GAN, Vocos or MelGAN generator (for the last two the
    committed config by default) and the shapes of its variables, for the
    config's ``n_mels``."""
    from smart_nar_fast_tts_tpu.vocoder import (HiFiGANGenerator,
                                                MelGANGenerator,
                                                VocosGenerator)
    config = config or committed_config(family)
    gen = {"hifigan": HiFiGANGenerator, "vocos": VocosGenerator,
           "melgan": MelGANGenerator}[family](config)
    shapes = jax.eval_shape(lambda: gen.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 16, config.n_mels))))
    return gen, shapes


def jax_leaf_index(kind: str) -> list[list]:
    """[[flax path, shape], ...] in JAX flatten order for the committed
    flagship (``"flagship"``), 8-speaker flagship (``"scaled_flagship"``),
    HiFi-GAN (``"hifigan"``), Vocos (``"vocos"``) or MelGAN (``"melgan"``)
    tree."""
    if kind == "hifigan":
        _, shapes = init_hifigan()
    elif kind in ("vocos", "melgan"):
        _, shapes = init_vocoder(kind)
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
                         ("hifigan", "benchmarks/results/vocoder_params.npz"),
                         ("vocos", "benchmarks/results/vocos_params.npz"),
                         ("melgan", "benchmarks/results/melgan_params.npz")):
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


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's torch work (a test module
    imports this fixture to use it): a tiny model's ops are too small to
    share, and with a test worker on every core extra threads only
    contend."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TINY_TRANSFORMER = {"encoder_layer": 1, "encoder_head": 2,
                    "encoder_hidden": 32, "decoder_layer": 1,
                    "decoder_head": 2, "decoder_hidden": 32,
                    "conv_filter_size": 64}


def make_trainer_corpus(root, n_utts: int = 6, val_size: int = 2) -> str:
    """``tests/test_data._make_corpus``'s synthetic speaker run through the
    JAX ``Preprocessor`` (as ``tests/test_trainer.py`` builds its corpus):
    ``n_utts - val_size`` train and ``val_size`` val utterances.  Returns
    the preprocessed directory (``train.txt``, ``val.txt``, features,
    ``speakers.json``, ``stats.json``)."""
    from smart_nar_fast_tts_tpu.config import AudioConfig, PreprocessConfig
    from smart_nar_fast_tts_tpu.data.preprocessor import Preprocessor
    from test_data import _make_corpus
    in_dir, out_dir = _make_corpus(root, n_utts=n_utts)
    Preprocessor(PreprocessConfig(
        data_path=str(in_dir), preprocessed_path=str(out_dir),
        val_size=val_size, audio=AudioConfig())).build_from_path(seed=7)
    return str(out_dir)


def write_trainer_triplet(root, name: str, preprocessed: str,
                          step: dict | None = None,
                          tpu: dict | None = None,
                          model: dict | None = None) -> list[str]:
    """The YAML triplet of a tiny trainer run on ``preprocessed``, its
    checkpoint, log and result paths under ``root/name``: batch 2, text
    bucket 16, mel bucket 256, the TINY_TRANSFORMER widths.  Both
    packages' ``Config.from_yaml_triplet`` read it (with
    ``<preprocessed>/stats.json``)."""
    import yaml
    out = os.path.join(str(root), name)
    pre = {"dataset": "Synthetic",
           "path": {"data_path": "", "lexicon_path": "",
                    "preprocessed_path": preprocessed},
           "preprocessing": {"val_size": 2}}
    mdl = {"transformer": dict(TINY_TRANSFORMER),
           "variance_predictor": {"filter_size": 32},
           "max_seq_len": 256, **(model or {})}
    train = {"path": {"ckpt_path": os.path.join(out, "ckpt"),
                      "log_path": os.path.join(out, "log"),
                      "result_path": os.path.join(out, "result")},
             "optimizer": {"batch_size": 2},
             "step": {"total_step": 3, "log_step": 1, "synth_step": 2,
                      "val_step": 2, "save_step": 2, **(step or {})},
             "tpu": {"text_buckets": [16], "mel_buckets": [256],
                     **(tpu or {})}}
    os.makedirs(out, exist_ok=True)
    paths = []
    for kind, d in (("preprocess", pre), ("model", mdl), ("train", train)):
        paths.append(os.path.join(out, f"{kind}.yaml"))
        with open(paths[-1], "w") as f:
            yaml.safe_dump(d, f)
    return paths


# one GAN step of a narrow generator, discriminator and mel configuration
# (the train_vocoder CLI's --debug_tiny ones) in both packages
GAN_MEL = dict(n_fft=32, hop_length=8, win_length=32, n_mels=8,
               mel_fmax=None)
GAN_DISC = dict(periods=(2, 3), period_channels=(4, 8), n_scales=2,
                scale_layers=((8, 15, 1, 1), (16, 41, 4, 4), (16, 5, 1, 1)))
GAN_B, GAN_SEG = 2, 256


def gan_segments(n_steps: int, seed: int = 40) -> list[np.ndarray]:
    """Seeded segments, one batch per step: a decaying tone plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(GAN_SEG) / 22050.0
    tone = np.sin(2 * np.pi * 440.0 * t) * np.exp(-4.0 * t / t[-1])
    return [(0.3 * tone + 0.05 * rng.standard_normal((GAN_B, GAN_SEG))
             ).astype(np.float32) for _ in range(n_steps)]


def jax_gan_run(jax_gen, n_steps: int = 1):
    """JAX's ``make_vocoder_train_step`` on ``jax_gen`` from its seed-0
    init: the (generator params, discriminator params, spectral-norm
    stats) before the first step, after each step, and each step's
    metrics, as numpy.  Its log-mel Pallas kernel runs in interpret
    mode."""
    from smart_nar_fast_tts_tpu.audio.stft import (
        MelSpectrogramConfig as JaxMelConfig)
    from smart_nar_fast_tts_tpu.training import vocoder as jax_training
    from smart_nar_fast_tts_tpu.vocoder.discriminators import (
        HiFiGANDiscriminator as JaxDiscriminator)
    disc = JaxDiscriminator(**GAN_DISC)
    tx = jax_training.make_vocoder_optimizer(2e-4)
    # jitted: an eager init compiles each of its many small ops
    state = jax.jit(functools.partial(
        jax_training.create_vocoder_state, jax_gen, disc, tx, tx,
        segment_size=GAN_SEG, seed=0))()
    snap = lambda s: jax.tree_util.tree_map(  # noqa: E731
        np.asarray, (s.gen_params, s.disc_params, s.disc_stats))
    initial, after, metrics = snap(state), [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SMART_TTS_PALLAS", "interpret")
        step = jax_training.make_vocoder_train_step(
            jax_gen, disc, JaxMelConfig(**GAN_MEL), tx, tx)
        for wavs in gan_segments(n_steps):
            state, m = step(state, jnp.asarray(wavs))
            after.append(snap(state))
            metrics.append({k: float(getattr(m, k)) for k in (
                "disc", "gen_adv", "feature", "mel", "gen_total")})
    return initial, after, metrics


def check_gan_steps(jax_run, make_generator, gen_to_torch, n_steps: int = 1,
                    metric_rtol: float = 1e-4, param_atol: float = 1e-5):
    """The port's GAN step from JAX's initial trees, against JAX's metrics
    and updated trees.  ``make_generator()`` builds the port's generator;
    ``gen_to_torch(flat)`` maps JAX generator params to its state dict."""
    import torch
    from smart_nar_fast_tts_tpu_torch import kernels
    from smart_nar_fast_tts_tpu_torch.audio import MelSpectrogramConfig
    from smart_nar_fast_tts_tpu_torch.training import (
        VocoderOptimizer, create_vocoder_state, make_vocoder_train_step)
    from smart_nar_fast_tts_tpu_torch.vocoder import HiFiGANDiscriminator
    from smart_nar_fast_tts_tpu_torch.weights import (
        jax_to_torch_discriminator)
    initial, after, metrics = jax_run

    def trees(gen_params, disc_params, disc_stats, disc):
        return (gen_to_torch(flatten({"params": gen_params})),
                jax_to_torch_discriminator(flatten(
                    {"params": disc_params, "batch_stats": disc_stats}),
                    disc))

    gen, disc = make_generator(), HiFiGANDiscriminator(**GAN_DISC)
    g, d = trees(*initial, disc)
    gen.load_state_dict(g)
    disc.load_state_dict(d)
    tx = VocoderOptimizer(2e-4)
    state = create_vocoder_state(gen, disc, tx, tx, device="cpu")
    step = make_vocoder_train_step(MelSpectrogramConfig(**GAN_MEL))
    kernels.reset_launches()
    for i, wavs in enumerate(gan_segments(n_steps)):
        got = step(state, torch.from_numpy(wavs))
        for k, want in metrics[i].items():
            np.testing.assert_allclose(float(getattr(got, k)), want,
                                       rtol=metric_rtol,
                                       err_msg=f"step {i + 1} {k}")
    assert state.step == n_steps
    assert kernels.launches()["fused_log_mel"] == 0      # CPU: plain version
    want_g, want_d = trees(*after[n_steps - 1], disc)
    for module, want in ((state.generator, want_g),
                         (state.discriminator, want_d)):
        got = module.state_dict()
        assert got.keys() == want.keys()
        for name in want:
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                       atol=param_atol, err_msg=name)
