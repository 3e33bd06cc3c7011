"""Model symbol inventory.

Reproduces the reference's 360-symbol table and ID ordering exactly
(reference ``text/symbols.py:10-29``): pad ``_`` + ``-`` + 10 punctuation +
52 letters + 84 ``@ARPAbet`` + 209 ``@pinyin`` + 3 silences.  The model
vocabulary is ``len(symbols) + 1 = 361`` (reference ``transformer/Models.py:40``).

Instead of hard-coding the phoneme lists, they are generated from base
inventories: ARPAbet = 39 phonemes sorted alphabetically with the 15 vowels
expanded to {base, 0, 1, 2} stress variants (84 total); pinyin = 23 initials +
37 finals x tones 1-5 + erhua 'rr' (209 total).  The generated ordering is
verified against the reference table in tests.
"""

from __future__ import annotations

# ARPAbet base inventory (CMU dictionary phone set).
ARPABET_VOWELS = (
    "AA AE AH AO AW AY EH ER EY IH IY OW OY UH UW".split()
)
ARPABET_CONSONANTS = (
    "B CH D DH F G HH JH K L M N NG P R S SH T TH V W Y Z ZH".split()
)


def _arpabet_symbols() -> list[str]:
    """All ARPAbet symbols, alphabetical, vowels with stress variants."""
    out = []
    for p in sorted(ARPABET_VOWELS + ARPABET_CONSONANTS):
        if p in ARPABET_VOWELS:
            out.extend([p, p + "0", p + "1", p + "2"])
        else:
            out.append(p)
    return out


# Mandarin pinyin inventory (GB-style with v for ü, iii/ii apical vowels).
PINYIN_INITIALS = (
    "b c ch d f g h j k l m n p q r s sh t w x y z zh".split()
)
PINYIN_FINALS = (
    "a ai an ang ao e ei en eng er i ia ian iang iao ie ii iii in ing iong "
    "iou o ong ou u ua uai uan uang uei uen uo v van ve vn".split()
)


def _pinyin_symbols() -> list[str]:
    out = list(PINYIN_INITIALS)
    for f in PINYIN_FINALS:
        out.extend(f + str(tone) for tone in range(1, 6))
    out.append("rr")
    return out


PAD = "_"
SPECIAL = "-"
PUNCTUATION = list("!'(),.:;? ")
LETTERS = [chr(c) for c in range(ord("A"), ord("Z") + 1)] + \
          [chr(c) for c in range(ord("a"), ord("z") + 1)]
SILENCES = ["@sp", "@spn", "@sil"]

ARPABET = ["@" + s for s in _arpabet_symbols()]
PINYIN = ["@" + s for s in _pinyin_symbols()]

# Final inventory — ordering is checkpoint-visible (embedding row index).
SYMBOLS: list[str] = (
    [PAD] + [SPECIAL] + PUNCTUATION + LETTERS + ARPABET + PINYIN + SILENCES
)

SYMBOL_TO_ID: dict[str, int] = {s: i for i, s in enumerate(SYMBOLS)}
ID_TO_SYMBOL: dict[int, str] = {i: s for i, s in enumerate(SYMBOLS)}

PAD_ID = 0
# Model vocabulary size (reference transformer/Models.py:40 uses len+1).
VOCAB_SIZE = len(SYMBOLS) + 1
