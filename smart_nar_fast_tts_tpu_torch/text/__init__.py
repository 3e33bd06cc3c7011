"""Text frontend: grapheme/phoneme strings → symbol-ID sequences.

The port's own copy of ``smart_nar_fast_tts_tpu/text/`` (symbols, cleaners,
numbers, cmudict, g2p and the numpy G2P model): the same code, so the same
ids, with no import of the JAX package; the G2P model reads that package's
committed ``text/data/`` files.

Same contract as the reference frontend (``text/__init__.py:15-79``):
curly-brace spans are ARPAbet phoneme sequences (``"{HH AW1} there"``),
everything else is run through the configured cleaner pipeline and mapped
symbol-by-symbol; pad ``_`` and ``~`` are dropped.  A ``korean_cleaners``
entry bypasses brace parsing (reference ``text/__init__.py:33-36``) — the
reference's Korean cleaner itself was never published, so the cleaner must be
registered by the user before use.
"""

from __future__ import annotations

import re

from .cleaners import CLEANERS
from .symbols import SYMBOLS, SYMBOL_TO_ID, ID_TO_SYMBOL, PAD_ID, VOCAB_SIZE

__all__ = [
    "SYMBOLS", "SYMBOL_TO_ID", "ID_TO_SYMBOL", "PAD_ID", "VOCAB_SIZE",
    "text_to_sequence", "sequence_to_text", "phonemes_to_sequence",
    "clean_text",
]

_curly_re = re.compile(r"(.*?)\{(.+?)\}(.*)")


def _clean(text: str, cleaner_names) -> str:
    for name in cleaner_names:
        try:
            cleaner = CLEANERS[name]
        except KeyError:
            raise ValueError(f"Unknown cleaner: {name}") from None
        text = cleaner(text)
    return text


def _keep(symbol: str) -> bool:
    return symbol in SYMBOL_TO_ID and symbol not in ("_", "~")


def _chars_to_ids(text: str) -> list[int]:
    return [SYMBOL_TO_ID[ch] for ch in text if _keep(ch)]


def phonemes_to_sequence(phonemes: str) -> list[int]:
    """Space-separated ARPAbet/silence tokens → IDs (``@``-prefixed table)."""
    return [SYMBOL_TO_ID["@" + p] for p in phonemes.split()
            if _keep("@" + p)]


def text_to_sequence(text: str, cleaner_names) -> list[int]:
    """Text (optionally with {ARPAbet} spans) → list of symbol IDs."""
    sequence: list[int] = []
    while text:
        if "korean_cleaners" in cleaner_names:
            sequence += _chars_to_ids(_clean(text, cleaner_names))
            break
        m = _curly_re.match(text)
        if not m:
            sequence += _chars_to_ids(_clean(text, cleaner_names))
            break
        sequence += _chars_to_ids(_clean(m.group(1), cleaner_names))
        sequence += phonemes_to_sequence(m.group(2))
        text = m.group(3)
    return sequence


def clean_text(text: str, cleaner_names) -> str:
    """Run the cleaner pipeline only (reference ``text/__init__.py:61-68``
    ``_clean_text``, used by corpus prep)."""
    return _clean(text, cleaner_names)


def sequence_to_text(sequence) -> str:
    """Inverse mapping for debugging; phonemes re-wrapped in braces."""
    out = []
    for sid in sequence:
        s = ID_TO_SYMBOL.get(int(sid))
        if s is None:
            continue
        if len(s) > 1 and s.startswith("@"):
            s = "{%s}" % s[1:]
        out.append(s)
    return "".join(out).replace("}{", " ")
