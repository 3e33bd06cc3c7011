"""CMU pronouncing dictionary support.

Parity with reference ``text/cmudict.py``: the 84-symbol ARPAbet inventory
(``text/cmudict.py:6-12`` — 39 base phones with stress variants on vowels)
plus a dictionary-file parser.  The reference's parser was unused at runtime
(SURVEY.md §2.3); here it is a first-class lexicon source: ``text.g2p``'s
``read_lexicon`` auto-detects cmudict-format files (``.dict`` extension or
``;;;`` header) and routes them through ``CMUDict.as_lexicon()``, so a raw
cmudict-0.7b works anywhere a librispeech-style lexicon does — including
``cfg.preprocess.lexicon_path`` consumed by the synthesize CLI.
"""

from __future__ import annotations

import re

from .symbols import _arpabet_symbols

# The 84 valid ARPAbet symbols (15 vowels × {base,0,1,2} + 24 consonants),
# identical inventory to reference text/cmudict.py:6-12.
VALID_SYMBOLS: list[str] = _arpabet_symbols()
_VALID = frozenset(VALID_SYMBOLS)

# cmudict-0.7b style alternate-pronunciation marker: WORD(1), WORD(2), ...
_ALT_RE = re.compile(r"\([0-9]+\)$")


class CMUDict:
    """Parser for cmudict-format pronunciation dictionaries.

    Format: ``;;;`` comment lines; entries ``WORD  PH1 PH2 ...``; alternate
    pronunciations as ``WORD(1)``.  Entries containing symbols outside the
    ARPAbet inventory are dropped (reference behavior: only valid-symbol
    pronunciations are kept).
    """

    def __init__(self, path_or_lines, keep_ambiguous: bool = True):
        if isinstance(path_or_lines, str):
            with open(path_or_lines, encoding="latin-1") as f:
                entries = _parse_cmudict(f)
        else:
            entries = _parse_cmudict(path_or_lines)
        if not keep_ambiguous:
            entries = {w: p for w, p in entries.items() if len(p) == 1}
        self._entries = entries

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, word: str) -> list[str] | None:
        """All pronunciations of ``word`` (each a space-joined ARPAbet
        string), or None if absent."""
        return self._entries.get(word.upper())

    def as_lexicon(self) -> dict[str, list[str]]:
        """First-pronunciation-wins mapping in ``text.g2p.G2P`` lexicon form
        (lowercase word → phone list)."""
        return {w.lower(): p[0].split() for w, p in self._entries.items()}


def _parse_cmudict(lines) -> dict[str, list[str]]:
    entries: dict[str, list[str]] = {}
    for line in lines:
        if not line or line.startswith(";;;"):
            continue
        parts = line.split("  ")
        if len(parts) != 2:
            continue
        word = _ALT_RE.sub("", parts[0])
        pron = _validate_pronunciation(parts[1])
        if pron is not None:
            entries.setdefault(word, []).append(pron)
    return entries


def _validate_pronunciation(s: str) -> str | None:
    phones = s.strip().split()
    if all(p in _VALID for p in phones) and phones:
        return " ".join(phones)
    return None
