"""Number → words normalization for English text.

Behavioral equivalent of the reference's inflect-based expansion
(reference ``text/numbers.py:66-73``): commas removed, pounds/dollars,
decimals, ordinals, cardinals — implemented here without the ``inflect``
dependency (not available in this environment) via a self-contained
number-to-words engine.
"""

from __future__ import annotations

import re

_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven",
         "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
         "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALES = [(10 ** 12, "trillion"), (10 ** 9, "billion"), (10 ** 6, "million"),
           (10 ** 3, "thousand"), (100, "hundred")]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _below_hundred(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    return _TENS[tens] + ("-" + _ONES[ones] if ones else "")


def number_to_words(n: int, zero: str = "zero") -> str:
    """Cardinal words for a non-negative integer."""
    if n == 0:
        return zero
    parts: list[str] = []
    for scale, name in _SCALES:
        if n >= scale:
            q, n = divmod(n, scale)
            parts.append(number_to_words(q) + " " + name)
    if n > 0:
        parts.append(_below_hundred(n))
    return " ".join(parts)


def number_to_ordinal_words(n: int) -> str:
    words = number_to_words(n)
    head, _, last = words.rpartition(" ")
    if "-" in last:
        tpart, _, opart = last.rpartition("-")
        last_ord = tpart + "-" + _ordinalize_word(opart)
    else:
        last_ord = _ordinalize_word(last)
    return (head + " " + last_ord).strip()


def _ordinalize_word(w: str) -> str:
    if w in _ORDINAL_IRREGULAR:
        return _ORDINAL_IRREGULAR[w]
    if w.endswith("y"):
        return w[:-1] + "ieth"
    return w + "th"


def _two_digit_pair(n: int) -> str:
    """Year-style reading used for 1001..2999 (e.g. 1984 → nineteen
    eighty-four), matching the reference's inflect ``group=2, zero='oh'``
    call (reference ``text/numbers.py:56-59``)."""
    hi, lo = divmod(n, 100)
    if lo == 0:
        return number_to_words(hi) + " hundred"
    lo_words = _below_hundred(lo) if lo >= 10 else "oh " + _ONES[lo]
    return _below_hundred(hi) + " " + lo_words


_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")


def _expand_dollars_match(m: re.Match) -> str:
    text = m.group(1)
    parts = text.split(".")
    if len(parts) > 2:
        return text + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    d_unit = "dollar" if dollars == 1 else "dollars"
    c_unit = "cent" if cents == 1 else "cents"
    if dollars and cents:
        return f"{dollars} {d_unit}, {cents} {c_unit}"
    if dollars:
        return f"{dollars} {d_unit}"
    if cents:
        return f"{cents} {c_unit}"
    return "zero dollars"


def _expand_number_match(m: re.Match) -> str:
    num = int(m.group(0))
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100)
        return _two_digit_pair(num)
    return number_to_words(num)


def normalize_numbers(text: str) -> str:
    text = _comma_number_re.sub(lambda m: m.group(1).replace(",", ""), text)
    text = _pounds_re.sub(r"\1 pounds", text)
    text = _dollars_re.sub(_expand_dollars_match, text)
    text = _decimal_re.sub(
        lambda m: m.group(1).replace(".", " point "), text)
    text = _ordinal_re.sub(
        lambda m: number_to_ordinal_words(int(m.group(0)[:-2])), text)
    text = _number_re.sub(_expand_number_match, text)
    return text
