"""What decides ``correct``: the program's outputs against the plain
reference, number by number, each against the limit the cell's limits file
states (``portbench/limits/<cell>.json``).

Serving: the mel over its valid frames and the waveform over its valid
samples of each compared item (``mel_gap``, ``wav_gap``: the largest
absolute difference over the largest absolute reference value of the
item), the reference taking the judged side's discrete decisions where the
acoustic family has any; the family's ``Decisions`` counts those apart,
each against the decision the reference takes from its own prediction.
Training: the loss of each of the first steps (``loss_gap``), each leaf's
first gradient as Adam got it (``grad_gap``) and each leaf's change over
the steps (``change_gap``), as gaps of norms by the worst leaf over the
larger of the reference's norm of that leaf and the median leaf's; leaves
whose reference gradient is under a thousandth of the median leaf's move
by round-off under Adam and are left out of the change; and the numbers
the acoustic family's ``Training.numbers`` adds.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

# a number that could not be judged (no item to compare, a short output)
UNJUDGED = 1e30
LIMITS_DIR = Path(__file__).resolve().parent.parent / "limits"


def limits(cell: str) -> dict[str, float]:
    return json.loads((LIMITS_DIR / f"{cell}.json").read_text())["limits"]


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    scale = float(np.abs(b).max()) if b.size else 0.0
    gap = float(np.abs(a - b).max()) if b.size else 0.0
    return gap / scale if scale > 0 else (0.0 if gap == 0 else UNJUDGED)


class ServingTally:
    """Gaps of the program's items against the reference's, batch by
    batch, and the acoustic family's tally of its decisions (``None``: it
    takes none)."""

    def __init__(self, decisions=None):
        self.decisions = decisions
        self.compared = 0
        self.mel_gap = self.wav_gap = 0.0

    def add(self, got: dict, ref: dict) -> None:
        """``got`` and ``ref``: per batch, ``mel_lens`` (B,), ``cut``
        (frames the vocoder ran on), ``hop``, ``lens`` (B,) of the text,
        ``own`` (the side's own decisions, as its family gives them), and
        per compared item i ``items[i] = {"mel": (T_i, n_mels), "wav":
        (T_i·hop,)}``, each cut to its side's valid lengths; ``ref``
        computed with ``got``'s decisions."""
        if self.decisions is not None:
            self.decisions.add(got, ref)
        shaped = (np.array_equal(got["mel_lens"], ref["mel_lens"])
                  and got["cut"] == ref["cut"])
        for i, g in got["items"].items():
            r = ref["items"][i]
            if not shaped or g["mel"].shape != r["mel"].shape \
                    or g["wav"].shape != r["wav"].shape:
                self.mel_gap = self.wav_gap = UNJUDGED
                continue
            self.compared += 1
            self.mel_gap = max(self.mel_gap, _rel(g["mel"], r["mel"]))
            self.wav_gap = max(self.wav_gap, _rel(g["wav"], r["wav"]))

    def numbers(self) -> dict[str, float]:
        out = {} if self.decisions is None else self.decisions.numbers()
        out.update(mel_gap=self.mel_gap, wav_gap=self.wav_gap)
        if not self.compared:
            out.update(mel_gap=UNJUDGED, wav_gap=UNJUDGED)
        return out


def leaf_gap(got: dict[str, float], ref: dict[str, float],
             names=None) -> float:
    names = list(ref) if names is None else names
    med = float(np.median([ref[n] for n in names]))
    return max(abs(got[n] - ref[n]) / max(ref[n], med, 1e-30)
               for n in names)


def training_numbers(got: dict, ref: dict, family=None) -> dict[str, float]:
    """``got``/``ref``: ``losses`` (steps × terms, total first), ``grad``
    and ``change`` (leaf name → norm); ``family``: the acoustic family's
    ``Training``, whose ``numbers`` adds its own."""
    gl, rl = np.asarray(got["losses"]), np.asarray(ref["losses"])
    med = float(np.median(list(ref["grad"].values())))
    moving = [n for n, g in ref["grad"].items() if g >= 1e-3 * med]
    out = {"loss_gap": float(np.max(np.abs(gl[:, 0] - rl[:, 0])
                                    / np.abs(rl[:, 0]))),
           "grad_gap": leaf_gap(got["grad"], ref["grad"]),
           "change_gap": leaf_gap(got["change"], ref["change"], moving)}
    if family is not None:
        out.update(family.numbers(got, ref))
    return out


def verdict(numbers: dict[str, float], lim: dict[str, float]) -> bool:
    """Every number the limits file names within its limit (a limit whose
    number is missing fails)."""
    return all(k in numbers and numbers[k] <= v for k, v in lim.items())


def report(numbers: dict[str, float], lim: dict[str, float]) -> dict:
    return {k: {"value": numbers[k], "limit": lim.get(k)} for k in numbers}


def to_host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()
