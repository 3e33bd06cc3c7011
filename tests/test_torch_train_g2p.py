"""The port's G2P trainer (``cli/train_g2p.py``) against the JAX package's,
on the CPU.

- The data helpers (``load_pairs``, ``split_heldout``, ``augment``,
  ``encode_batch``) equal JAX's on the committed seed lexicon.
- One batch from the same ``init_params``: the loss and every gradient
  within rtol 1e-5 of ``jax.value_and_grad(make_loss_fn())`` (each array
  with an absolute floor of 1e-5 of its largest magnitude, for the entries
  near 0).
- ``train()`` on a 150-word slice of the lexicon, 2 epochs, batch 16, with
  and without augmentation: the saved arrays within 1e-5 of JAX's
  (measured: at most 6.7e-6, Adam's first normalised steps carrying
  the products' rounding into every weight) and the same report.
- ``phoneme_error_rate`` of the port's ``G2PModel`` on the committed
  weights equals JAX's on the held-out split.
- The CLI without ``--out`` writes the port's own default file and leaves
  the JAX package's committed weights byte-identical; ``load_default()``
  then reads the new file.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_nar_fast_tts_tpu.cli import train_g2p as jax_cli
from smart_nar_fast_tts_tpu.text import g2p_model as jax_g2p_model
from smart_nar_fast_tts_tpu_torch.cli import train_g2p as port_cli
from smart_nar_fast_tts_tpu_torch.text import g2p_model as port_g2p_model
from torch_port_util import one_torch_thread  # noqa: F401

LEXICON = port_g2p_model.DEFAULT_SEED_LEXICON
GRAD_RTOL = 1e-5
TRAIN_ATOL = 1e-5


@pytest.fixture(scope="module")
def pairs():
    return port_cli.load_pairs(LEXICON)


@pytest.fixture(scope="module")
def slice_lexicon(tmp_path_factory, pairs):
    """Every 13th entry of the seed lexicon (150 words) as a lexicon file."""
    words = sorted(pairs)[::13]
    path = tmp_path_factory.mktemp("g2p") / "slice.txt"
    path.write_text("".join(f"{w.upper()}  {' '.join(pairs[w])}\n"
                            for w in words))
    return str(path), len(words)


def test_data_helpers_match_jax(pairs):
    assert pairs == jax_cli.load_pairs(LEXICON)
    train, held = port_cli.split_heldout(pairs)
    assert (train, held) == jax_cli.split_heldout(pairs)
    assert len(held) >= 100
    assert port_cli.augment(train) == jax_cli.augment(train)
    words = sorted(train)[:24]
    args = (words, [train[w] for w in words], 12, 10)  # some cut at the cap
    for got, want in zip(port_cli.encode_batch(*args),
                         jax_cli.encode_batch(*args)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_loss_and_gradients_match_jax(pairs):
    rng = np.random.default_rng(0)
    params = port_cli.init_params(rng, len(port_g2p_model.G2IDX),
                                  len(port_g2p_model.PHONEMES))
    jax_params = jax_cli.init_params(np.random.default_rng(0),
                                     len(jax_g2p_model.G2IDX),
                                     len(jax_g2p_model.PHONEMES))
    for k in jax_params:
        np.testing.assert_array_equal(params[k], jax_params[k])
    words = sorted(pairs)[100:116]
    max_w = max(len(w) for w in words) + 4          # padded steps included
    max_p = max(len(pairs[w]) for w in words) + 4
    batch = port_cli.encode_batch(words, [pairs[w] for w in words], max_w,
                                  max_p)
    loss, grads = jax.jit(jax.value_and_grad(jax_cli.make_loss_fn()))(
        jax_params, *(jnp.asarray(a) for a in batch))

    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    got = port_cli.make_loss_fn()(tp, *(torch.from_numpy(a) for a in batch))
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=GRAD_RTOL)
    assert set(grads) == set(tp)
    for k, g in grads.items():
        g = np.asarray(g)
        np.testing.assert_allclose(tp[k].grad.numpy(), g, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(g).max(),
                                   err_msg=k)


@pytest.mark.parametrize("do_augment", [True, False])
def test_train_matches_jax(tmp_path, slice_lexicon, do_augment, capsys):
    lexicon, n_words = slice_lexicon
    assert n_words == 150
    kw = dict(epochs=2, batch_size=16, do_augment=do_augment)
    want = jax_cli.train(lexicon, str(tmp_path / "jax.npz"), **kw)
    jax_out = capsys.readouterr().out.splitlines()
    got = port_cli.train(lexicon, str(tmp_path / "port.npz"), device="cpu",
                         **kw)
    port_out = capsys.readouterr().out.splitlines()
    assert got == want
    # the same lines: the augmentation count, epochs 0 and 1, the report
    assert len(port_out) == len(jax_out) == 3 + do_augment
    assert port_out[:do_augment] == jax_out[:do_augment]
    assert port_out[-1] == jax_out[-1]
    for a, b in zip(port_out[do_augment:-1], jax_out[do_augment:-1]):
        assert a.split()[:3] == b.split()[:3]
        assert abs(float(a.split()[-1]) - float(b.split()[-1])) <= 1e-4
    with np.load(tmp_path / "port.npz") as p, \
            np.load(tmp_path / "jax.npz") as j:
        assert sorted(p.files) == sorted(j.files)
        for k in j.files:
            np.testing.assert_allclose(p[k], j[k], rtol=0, atol=TRAIN_ATOL,
                                       err_msg=k)


def test_heldout_per_matches_jax(pairs):
    _, held = port_cli.split_heldout(pairs)
    got = port_cli.phoneme_error_rate(port_g2p_model.G2PModel(), held)
    want = jax_cli.phoneme_error_rate(jax_g2p_model.G2PModel(), held)
    assert got == want
    assert got < 0.25


def test_cli_default_out_leaves_the_jax_package(tmp_path, monkeypatch,
                                                slice_lexicon):
    def sha(path):
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    committed = jax_g2p_model.DEFAULT_WEIGHTS
    assert port_g2p_model.DEFAULT_WEIGHTS == committed
    before = sha(committed)
    out = tmp_path / "port_pkg" / "data" / "g2p_weights.npz"
    monkeypatch.setattr(port_g2p_model, "TRAINED_WEIGHTS", str(out))
    monkeypatch.setattr(port_g2p_model, "_default_model", None)
    report = port_cli.main(["--lexicon", slice_lexicon[0], "--epochs", "1",
                            "--batch_size", "32", "--device", "cpu"])
    assert report["train_words"] > 0
    assert sha(committed) == before
    assert out.is_file()
    model = port_g2p_model.load_default()
    with np.load(out) as z:
        np.testing.assert_array_equal(model.p["Wo"], z["Wo"])
