"""English grapheme-to-phoneme for synthesis.

Replicates the reference's synthesis-time frontend
(``synthesize.py:20-56``): clean the text, split into words, look each word
up in a pronunciation lexicon (``lexicon/librispeech-lexicon.txt``), and
fall back to G2P for OOV words; non-word punctuation becomes an ``sp``
silence token.  The reference uses the ``g2p_en`` neural package for the
OOV fallback (``synthesize.py:36,43``); here the equivalent is the in-repo
learned seq2seq (``text/g2p_model.py``, trained by ``cli/train_g2p.py``,
numpy inference) whenever its weights are present, with a rule-based
letter-to-sound pass (``_rule_g2p``) as the last-resort fallback.  Any
callable can be substituted via ``G2P(fallback=...)``.
"""

from __future__ import annotations

import os
import re
from typing import Callable

from .cleaners import english_cleaners

_word_re = re.compile(r"([,;.\-\?\!\s+])")


def read_lexicon(path: str) -> dict[str, list[str]]:
    """Parse a pronunciation lexicon: ``WORD  PH1 PH2 ...`` per line.
    First pronunciation wins (reference ``synthesize.py:20-29``).

    cmudict-format files (``.dict`` extension or a ``;;;`` comment header)
    are auto-detected and routed through :class:`..cmudict.CMUDict`, which
    strips ``WORD(1)`` alternate keys, comment lines, and entries with
    out-of-inventory phones — so a raw cmudict-0.7b works anywhere a
    librispeech-style lexicon does."""
    if _is_cmudict_format(path):
        from .cmudict import CMUDict
        return CMUDict(path).as_lexicon()
    lexicon: dict[str, list[str]] = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) < 2:
                continue
            word, phones = parts[0].lower(), parts[1:]
            lexicon.setdefault(word, phones)
    return lexicon


def _is_cmudict_format(path: str) -> bool:
    if path.endswith(".dict"):
        return True
    try:
        with open(path, encoding="latin-1") as f:
            for line in f:
                if line.strip():
                    return line.startswith(";;;")
    except OSError:
        pass
    return False


# ---------------------------------------------------------------------------
# Rule-based fallback G2P (orthography → ARPAbet, heuristic)
# ---------------------------------------------------------------------------
# Multi-letter graphemes first (longest match), then single letters.
_DIGRAPHS = [
    ("tion", ["SH", "AH0", "N"]), ("ough", ["AO1"]), ("augh", ["AE1", "F"]),
    ("sch", ["S", "K"]), ("tch", ["CH"]), ("dge", ["JH"]),
    ("igh", ["AY1"]), ("eigh", ["EY1"]),
    ("ch", ["CH"]), ("sh", ["SH"]), ("th", ["TH"]), ("ph", ["F"]),
    ("wh", ["W"]), ("ck", ["K"]), ("ng", ["NG"]), ("qu", ["K", "W"]),
    ("oo", ["UW1"]), ("ee", ["IY1"]), ("ea", ["IY1"]), ("ai", ["EY1"]),
    ("ay", ["EY1"]), ("oa", ["OW1"]), ("ou", ["AW1"]), ("ow", ["AW1"]),
    ("oi", ["OY1"]), ("oy", ["OY1"]), ("au", ["AO1"]), ("aw", ["AO1"]),
    ("ar", ["AA1", "R"]), ("er", ["ER0"]), ("ir", ["ER1"]),
    ("or", ["AO1", "R"]), ("ur", ["ER1"]),
]
_SINGLE = {
    "a": ["AE1"], "b": ["B"], "c": ["K"], "d": ["D"], "e": ["EH1"],
    "f": ["F"], "g": ["G"], "h": ["HH"], "i": ["IH1"], "j": ["JH"],
    "k": ["K"], "l": ["L"], "m": ["M"], "n": ["N"], "o": ["AA1"],
    "p": ["P"], "q": ["K"], "r": ["R"], "s": ["S"], "t": ["T"],
    "u": ["AH1"], "v": ["V"], "w": ["W"], "x": ["K", "S"], "y": ["Y"],
    "z": ["Z"],
}
_VOWEL_LETTERS = set("aeiou")


def _rule_g2p(word: str) -> list[str]:
    """Heuristic letter-to-sound conversion for OOV words."""
    word = word.lower()
    # Silent final e: "make" → m-a-k
    if len(word) > 3 and word.endswith("e") and word[-2] not in _VOWEL_LETTERS:
        word = word[:-1]
    phones: list[str] = []
    i = 0
    while i < len(word):
        for graph, ph in _DIGRAPHS:
            if word.startswith(graph, i):
                phones.extend(ph)
                i += len(graph)
                break
        else:
            ph = _SINGLE.get(word[i])
            if ph:
                # soft c/g before front vowels
                if word[i] == "c" and i + 1 < len(word) and word[i + 1] in "eiy":
                    phones.append("S")
                elif word[i] == "g" and i + 1 < len(word) and word[i + 1] in "eiy":
                    phones.append("JH")
                else:
                    phones.extend(ph)
            i += 1
    return phones or ["AH0"]


def _learned_fallback() -> Callable[[str], list[str]] | None:
    """The committed learned model's ``predict``, or None when absent."""
    from .g2p_model import load_default
    model = load_default()
    if model is None:
        return None

    def predict(word: str) -> list[str]:
        phones = model.predict(word)
        return phones if phones else _rule_g2p(word)
    return predict


class G2P:
    """Lexicon-first grapheme→phoneme converter with pluggable fallback.

    OOV fallback priority: explicit ``fallback`` argument > the committed
    learned seq2seq (``text/data/g2p_weights.npz``, the reference's g2p_en
    role) > the rule-based letter-to-sound pass.
    """

    def __init__(self, lexicon_path: str | None = None,
                 fallback: Callable[[str], list[str]] | None = None):
        self.lexicon: dict[str, list[str]] = {}
        if lexicon_path and os.path.exists(lexicon_path):
            self.lexicon = read_lexicon(lexicon_path)
        self.fallback = fallback or _learned_fallback() or _rule_g2p

    def __call__(self, text: str) -> str:
        """English text → ``{PH PH sp ...}`` phoneme string, the same shape
        the reference feeds to ``text_to_sequence`` (synthesize.py:44-51)."""
        text = english_cleaners(text)
        phones: list[str] = []
        for token in _word_re.split(text):
            token = token.strip()
            if not token:
                continue
            w = token.lower()
            if w in self.lexicon:
                phones.extend(self.lexicon[w])
            elif w.isalpha():
                phones.extend(self.fallback(w))
            else:
                phones.append("sp")
        return "{" + " ".join(phones) + "}"
