"""Minimal Praat TextGrid reader (replaces the ``tgt`` dependency,
reference ``preprocessor/preprocessor.py:162``): the port's copy of
``smart_nar_fast_tts_tpu/data/textgrid.py``.

Supports the long ("ooTextFile") and short formats that Montreal Forced
Aligner emits; only IntervalTiers are parsed since that is all the
preprocessing consumes (the ``phones`` tier).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Interval:
    start_time: float
    end_time: float
    text: str


@dataclass
class Tier:
    name: str
    intervals: list[Interval] = field(default_factory=list)

    # tgt compatibility: reference iterates tier._objects
    @property
    def _objects(self) -> list[Interval]:
        return self.intervals


@dataclass
class TextGrid:
    tiers: list[Tier] = field(default_factory=list)

    def get_tier_by_name(self, name: str) -> Tier:
        for t in self.tiers:
            if t.name == name:
                return t
        raise KeyError(f"no tier named {name!r}; have "
                       f"{[t.name for t in self.tiers]}")


_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?")
_QUOTED = re.compile(r'"((?:[^"]|"")*)"')


def _parse_long(text: str) -> TextGrid:
    tg = TextGrid()
    tier = None
    pending: dict[str, float | str] = {}
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("class"):
            m = _QUOTED.search(line)
            is_interval = bool(m) and m.group(1) == "IntervalTier"
            tier = Tier(name="") if is_interval else None
            continue
        if tier is None:
            continue
        if line.startswith("name"):
            m = _QUOTED.search(line)
            tier.name = m.group(1) if m else ""
            tg.tiers.append(tier)
        elif line.startswith("xmin") and "intervals" not in pending:
            pass  # tier-level bounds, unused
        elif line.startswith("intervals ["):
            pending = {}
        elif line.startswith("xmin") or (line.startswith("xmax")):
            pass
        if line.startswith("intervals:"):
            continue
        m = re.match(r"xmin\s*=\s*(" + _NUM.pattern + ")", line)
        if m and tier is not None and pending is not None:
            pending["xmin"] = float(m.group(1))
            continue
        m = re.match(r"xmax\s*=\s*(" + _NUM.pattern + ")", line)
        if m and tier is not None and pending is not None:
            pending["xmax"] = float(m.group(1))
            continue
        m = re.match(r'text\s*=\s*"((?:[^"]|"")*)"', line)
        if m and tier is not None and "xmin" in pending and "xmax" in pending:
            tier.intervals.append(Interval(
                float(pending["xmin"]), float(pending["xmax"]),
                m.group(1).replace('""', '"')))
            pending = {}
    return tg


def _parse_short(text: str) -> TextGrid:
    # token stream: numbers and quoted strings in declaration order
    tokens = re.findall(r'"(?:[^"]|"")*"|' + _NUM.pattern, text)
    # header: "ooTextFile" "TextGrid" xmin xmax <exists> n_tiers
    i = 0
    strings_seen = 0
    while i < len(tokens) and strings_seen < 2:
        if tokens[i].startswith('"'):
            strings_seen += 1
        i += 1
    i += 2                                    # global xmin xmax
    n_tiers = int(float(tokens[i])); i += 1
    tg = TextGrid()
    for _ in range(n_tiers):
        klass = tokens[i].strip('"'); i += 1
        name = tokens[i].strip('"'); i += 1
        i += 2                                # tier xmin xmax
        n_items = int(float(tokens[i])); i += 1
        tier = Tier(name=name)
        for _ in range(n_items):
            if klass == "IntervalTier":
                xmin = float(tokens[i]); xmax = float(tokens[i + 1])
                txt = tokens[i + 2].strip('"').replace('""', '"')
                i += 3
                tier.intervals.append(Interval(xmin, xmax, txt))
            else:                             # TextTier points: time, mark
                i += 2
        if klass == "IntervalTier":
            tg.tiers.append(tier)
    return tg


def read_textgrid(path: str) -> TextGrid:
    with open(path, encoding="utf-8") as f:
        text = f.read()
    if "item []" in text or "item[]" in text or "item [" in text:
        return _parse_long(text)
    return _parse_short(text)
