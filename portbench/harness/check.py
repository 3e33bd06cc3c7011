"""What decides ``correct``: the program's outputs against the plain
reference, number by number, each against the limit the cell's limits file
states (``portbench/limits/<cell>.json``).

Serving: two kinds of discrete decision: the durations of every item of
each compared batch (``dur_mismatch``: the share of their phonemes whose
duration differs) and, for each compared item, the pitch and energy bins
of its valid frames
(``bin_mismatch``: the share of the compared frame bins that differ),
each against the decision the reference takes from its own prediction;
and the PostNet mel over its valid frames and the waveform over its valid
samples (``mel_gap``, ``wav_gap``: the largest absolute difference over
the largest absolute reference value of the item), the reference taking
the judged side's decisions.  A decision taken at a rounding boundary
flips with the last bit of its input and moves what follows by whole
units; so the reference follows the judged side's decisions, and the
decisions are counted apart.  Training: the loss of each of the
first steps (``loss_gap``), each leaf's first gradient as Adam got it
(``grad_gap``) and each leaf's change over the steps (``change_gap``),
as gaps of norms by the worst leaf over the larger of the reference's norm
of that leaf and the median leaf's; leaves whose reference gradient is
under a thousandth of the median leaf's move by round-off under Adam and
are left out of the change.
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
    batch."""

    def __init__(self):
        self.phonemes = self.mismatched = self.compared = 0
        self.frames = self.bins_off = 0
        self.mel_gap = self.wav_gap = 0.0

    def add(self, got: dict, ref: dict) -> None:
        """``got`` and ``ref``: per batch, ``mel_lens`` (B,), ``cut``
        (frames the vocoder ran on), ``hop``, and per compared item i
        ``items[i] = (durations (L_i,), bins (2, T_i), mel (T_i, n_mels),
        wav)``, each cut to its side's valid lengths; ``ref`` computed with
        ``got``'s decisions, its items' decisions its own."""
        shaped = (np.array_equal(got["mel_lens"], ref["mel_lens"])
                  and got["cut"] == ref["cut"])
        valid = np.arange(ref["own_durations"].shape[1])[None, :] \
            < ref["lens"][:, None]
        self.phonemes += int(valid.sum())
        self.mismatched += int(((got["force"][0] != ref["own_durations"])
                                & valid).sum())
        for i, (d, bins, mel, wav) in got["items"].items():
            rd, rbins, rmel, rwav = ref["items"][i]
            n = min(bins.shape[1], rbins.shape[1])
            self.frames += rbins.size
            self.bins_off += int((bins[:, :n] != rbins[:, :n]).sum()) + \
                rbins.size - 2 * n
            if not shaped or mel.shape != rmel.shape \
                    or wav.shape != rwav.shape:
                self.mel_gap = self.wav_gap = UNJUDGED
                continue
            self.compared += 1
            self.mel_gap = max(self.mel_gap, _rel(mel, rmel))
            self.wav_gap = max(self.wav_gap, _rel(wav, rwav))

    def numbers(self) -> dict[str, float]:
        out = {"dur_mismatch": self.mismatched / max(self.phonemes, 1),
               "bin_mismatch": self.bins_off / max(self.frames, 1),
               "mel_gap": self.mel_gap, "wav_gap": self.wav_gap}
        if not self.compared:
            out.update(mel_gap=UNJUDGED, wav_gap=UNJUDGED)
        return out


def leaf_gap(got: dict[str, float], ref: dict[str, float],
             names=None) -> float:
    names = list(ref) if names is None else names
    med = float(np.median([ref[n] for n in names]))
    return max(abs(got[n] - ref[n]) / max(ref[n], med, 1e-30)
               for n in names)


# the loss terms' order (LossBreakdown's): total first, the guided prior last
GUIDED = 6
ALIGNER = "mel_encoder."


def training_numbers(got: dict, ref: dict) -> dict[str, float]:
    """``got``/``ref``: ``losses`` (steps × terms, total first), ``grad``
    and ``change`` (leaf name → norm).

    Two of the numbers leave out what the aligner's argmax decides: the
    guided prior (``guided_gap``, each step's, relative) and the first
    gradient of the aligner's own leaves (``aligner_grad_gap``), which
    reach the loss only through that prior.  An argmax at a near-tie takes
    another phoneme with the last bit of its scores, and moves a duration
    target by a frame and the other numbers with it."""
    gl, rl = np.asarray(got["losses"]), np.asarray(ref["losses"])
    med = float(np.median(list(ref["grad"].values())))
    moving = [n for n, g in ref["grad"].items() if g >= 1e-3 * med]
    aligner = [n for n in ref["grad"] if n.startswith(ALIGNER)]
    rel = np.abs(gl - rl) / np.abs(rl)
    return {"loss_gap": float(np.max(rel[:, 0])),
            "guided_gap": float(np.max(rel[:, GUIDED])),
            "grad_gap": leaf_gap(got["grad"], ref["grad"]),
            "aligner_grad_gap": leaf_gap(got["grad"], ref["grad"], aligner),
            "change_gap": leaf_gap(got["change"], ref["change"], moving)}


def verdict(numbers: dict[str, float], lim: dict[str, float]) -> bool:
    """Every number the limits file names within its limit (a limit whose
    number is missing fails)."""
    return all(k in numbers and numbers[k] <= v for k, v in lim.items())


def report(numbers: dict[str, float], lim: dict[str, float]) -> dict:
    return {k: {"value": numbers[k], "limit": lim.get(k)} for k in numbers}


def to_host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()
