"""Learned grapheme→phoneme model: numpy inference.

Replaces the reference's ``g2p_en`` neural OOV fallback
(``synthesize.py:36,43`` — a trained seq2seq run per out-of-lexicon word)
with an in-repo equivalent (VERDICT.md Missing #2): a character-level
encoder/decoder GRU with Luong attention, trained by
``cli/train_g2p.py`` (the JAX package's, or the port's on the card) on any
CMUdict-style lexicon and executed here in pure numpy — host-side text
frontend work, never on the device path, and free of any framework
dependency at synthesis time.

A default model trained on the committed seed lexicon
(``text/data/seed_lexicon.txt``) ships with the JAX package as
``text/data/g2p_weights.npz``.  The port's ``cli.train_g2p`` writes its
model into the port's own package (:data:`TRAINED_WEIGHTS`), never into the
JAX package; :func:`load_default` reads that file when it exists and the
JAX package's otherwise.  ``G2P`` (``text/g2p.py``) uses the default model
automatically for OOV words, lexicon lookups first, exactly like the
reference.

Cell math (shared contract with the JAX trainer — both implement these
formulas directly so the exported weights mean the same thing):

    r  = σ(x·Wxr + h·Whr + br)          z = σ(x·Wxz + h·Whz + bz)
    n  = tanh(x·Wxn + r ⊙ (h·Whn) + bn)
    h' = (1 − z) ⊙ n + z ⊙ h

Attention (Luong general): score_t = h_dec · Wa · H_encᵀ, context =
softmax(score)·H_enc; logits = [h_dec ; context]·Wo + bo.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

# -- vocabularies ------------------------------------------------------------

PAD, BOS, EOS = "<pad>", "<s>", "</s>"
GRAPHEMES = [PAD, BOS, EOS] + list("abcdefghijklmnopqrstuvwxyz'-.")

_PHONE_BASES = [
    "AA", "AE", "AH", "AO", "AW", "AY", "B", "CH", "D", "DH", "EH", "ER",
    "EY", "F", "G", "HH", "IH", "IY", "JH", "K", "L", "M", "N", "NG", "OW",
    "OY", "P", "R", "S", "SH", "T", "TH", "UH", "UW", "V", "W", "Y", "Z",
    "ZH",
]
_VOWELS = {"AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY", "IH",
           "IY", "OW", "OY", "UH", "UW"}
PHONEMES = [PAD, BOS, EOS] + sorted(
    p + s for p in _PHONE_BASES
    for s in (("0", "1", "2") if p in _VOWELS else ("",)))

G2IDX = {c: i for i, c in enumerate(GRAPHEMES)}
P2IDX = {p: i for i, p in enumerate(PHONEMES)}

# the committed weights and seed lexicon of the JAX package's text frontend,
# read as files (nothing of that package is imported)
_DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "smart_nar_fast_tts_tpu", "text", "data")
DEFAULT_WEIGHTS = os.path.join(_DATA_DIR, "g2p_weights.npz")
DEFAULT_SEED_LEXICON = os.path.join(_DATA_DIR, "seed_lexicon.txt")
# what the port's cli.train_g2p writes by default (not committed)
TRAINED_WEIGHTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "data", "g2p_weights.npz")


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def _gru_step(p: dict, prefix: str, x: np.ndarray, h: np.ndarray
              ) -> np.ndarray:
    r = _sigmoid(x @ p[prefix + "Wxr"] + h @ p[prefix + "Whr"]
                 + p[prefix + "br"])
    z = _sigmoid(x @ p[prefix + "Wxz"] + h @ p[prefix + "Whz"]
                 + p[prefix + "bz"])
    n = np.tanh(x @ p[prefix + "Wxn"] + r * (h @ p[prefix + "Whn"])
                + p[prefix + "bn"])
    return (1.0 - z) * n + z * h


class G2PModel:
    """Greedy-decoding numpy inference over exported ``.npz`` weights."""

    def __init__(self, weights_path: str = DEFAULT_WEIGHTS):
        with np.load(weights_path) as z:
            self.p = {k: np.asarray(z[k], np.float32) for k in z.files}
        self.hidden = self.p["enc_fwd_Whr"].shape[0]

    # -- encoder: bidirectional GRU over characters ------------------------
    def _encode(self, word: str) -> np.ndarray:
        ids = [G2IDX[BOS]] + [G2IDX[c] for c in word if c in G2IDX] \
            + [G2IDX[EOS]]
        emb = self.p["char_emb"][ids]                     # (L, E)
        H = self.hidden
        fwd = np.zeros((len(ids), H), np.float32)
        h = np.zeros(H, np.float32)
        for t in range(len(ids)):
            h = _gru_step(self.p, "enc_fwd_", emb[t], h)
            fwd[t] = h
        bwd = np.zeros((len(ids), H), np.float32)
        h = np.zeros(H, np.float32)
        for t in reversed(range(len(ids))):
            h = _gru_step(self.p, "enc_bwd_", emb[t], h)
            bwd[t] = h
        return np.concatenate([fwd, bwd], axis=-1)        # (L, 2H)

    # -- decoder: GRU + Luong attention, greedy ----------------------------
    def predict(self, word: str, max_len: int = 32) -> list[str]:
        """Lower-case word → ARPAbet phone list (with stress digits)."""
        word = word.lower()
        if not any(c in G2IDX for c in word):
            return []
        enc = self._encode(word)                          # (L, 2H)
        keys = enc @ self.p["Wa"]                         # (L, H)
        h = np.tanh(enc[-1] @ self.p["Winit"] + self.p["binit"])
        prev = P2IDX[BOS]
        phones: list[str] = []
        for _ in range(max_len):
            x = self.p["phone_emb"][prev]
            h = _gru_step(self.p, "dec_", x, h)
            score = keys @ h                              # (L,)
            score = score - score.max()
            attn = np.exp(score)
            attn /= attn.sum()
            context = attn @ enc                          # (2H,)
            logits = np.concatenate([h, context]) @ self.p["Wo"] \
                + self.p["bo"]
            prev = int(np.argmax(logits))
            if prev == P2IDX[EOS] or prev == P2IDX[PAD]:
                break
            phones.append(PHONEMES[prev])
        return phones


_default_model: Optional[G2PModel] = None
_default_missing = False


def load_default() -> Optional[G2PModel]:
    """The model of :data:`TRAINED_WEIGHTS` when the port's trainer wrote
    one, else the JAX package's committed model; None when neither file is
    present."""
    global _default_model, _default_missing
    if _default_model is None and not _default_missing:
        for path in (TRAINED_WEIGHTS, DEFAULT_WEIGHTS):
            if os.path.exists(path):
                _default_model = G2PModel(path)
                break
        else:
            _default_missing = True
    return _default_model
