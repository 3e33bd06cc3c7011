"""Text cleaner pipelines.

Same cleaner surface as the reference (``text/cleaners.py:67-89``):
``basic_cleaners``, ``transliteration_cleaners``, ``english_cleaners``
(ascii transliteration → lowercase → number expansion → abbreviation
expansion → whitespace collapse).  ASCII transliteration is implemented with
unicode NFKD decomposition plus a small latin supplement map (the
``unidecode`` package is not available in this environment).
"""

from __future__ import annotations

import re
import unicodedata

from .numbers import normalize_numbers

_whitespace_re = re.compile(r"\s+")

_ABBREVIATIONS = {
    "mrs": "misess", "mr": "mister", "dr": "doctor", "st": "saint",
    "co": "company", "jr": "junior", "maj": "major", "gen": "general",
    "drs": "doctors", "rev": "reverend", "lt": "lieutenant",
    "hon": "honorable", "sgt": "sergeant", "capt": "captain",
    "esq": "esquire", "ltd": "limited", "col": "colonel", "ft": "fort",
}
_abbrev_res = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), full)
    for abbr, full in _ABBREVIATIONS.items()
]

# Latin characters NFKD cannot decompose to ASCII.
_LATIN_MAP = {
    "æ": "ae", "Æ": "AE", "œ": "oe", "Œ": "OE", "ß": "ss",
    "ø": "o", "Ø": "O", "đ": "d", "Đ": "D", "ħ": "h", "Ħ": "H",
    "ł": "l", "Ł": "L", "þ": "th", "Þ": "Th", "ð": "d", "Ð": "D",
    "ŋ": "ng", "Ŋ": "NG", "ı": "i", "ĸ": "k",
    "“": '"', "”": '"', "‘": "'", "’": "'", "—": "-", "–": "-",
    "…": "...", "«": '"', "»": '"', " ": " ",
}


def to_ascii(text: str) -> str:
    """Best-effort ASCII transliteration (unidecode-lite)."""
    text = "".join(_LATIN_MAP.get(ch, ch) for ch in text)
    decomposed = unicodedata.normalize("NFKD", text)
    return decomposed.encode("ascii", "ignore").decode("ascii")


def lowercase(text: str) -> str:
    return text.lower()


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _abbrev_res:
        text = regex.sub(replacement, text)
    return text


def collapse_whitespace(text: str) -> str:
    return _whitespace_re.sub(" ", text)


def basic_cleaners(text: str) -> str:
    """Lowercase + collapse whitespace (no transliteration)."""
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text: str) -> str:
    """ASCII transliteration + lowercase + collapse whitespace."""
    return collapse_whitespace(lowercase(to_ascii(text)))


def english_cleaners(text: str) -> str:
    """Full English pipeline incl. number and abbreviation expansion."""
    text = to_ascii(text)
    text = lowercase(text)
    text = normalize_numbers(text)
    text = expand_abbreviations(text)
    text = collapse_whitespace(text)
    return text


CLEANERS = {
    "basic_cleaners": basic_cleaners,
    "transliteration_cleaners": transliteration_cleaners,
    "english_cleaners": english_cleaners,
}
