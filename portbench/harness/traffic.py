"""The one traffic generator: a mix's data file in, requests and batches out.

Every seed gets the same set of sizes, in another order, so that the seed
changes which phonemes and which order, never how much work a run offers:
sizes are the quantiles of the mix's length distribution (a Beta shape on
[min, max] with the stated mean).  Batches are balanced: with P batches,
the sizes fall into strata of P neighbours and each batch takes one of
every stratum, in the seed's order, so every batch carries about the same
audio and a window that ends inside a cycle of the batches measures the
same work.  An open mix offers the same load to every seed: its arrival
gaps are the quantiles of the exponential distribution at the stated
rate and its sentence sizes the quantiles above, each in one fixed
order (a tail over a few hundred requests moves by tens of percent with
the order of bursts and long sentences); the seed draws the phonemes.

A mix file holds ``mode`` (``closed``: batches dispatched back to back;
``open``: Poisson arrivals batched first come first served; ``train``:
training batches) and the parameters that mode reads.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent.parent / "traffic"


def load(name: str) -> dict:
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


def sub_seed(seed: int, tag: int) -> int:
    """A 63-bit seed for stream ``tag`` of run seed ``seed``.  The harness
    takes 0 (the mix), 1 and 2 (the weights, ``weights.ACOUSTIC`` and
    ``VOCODER``), 3 (the open mix's compared requests) and 7 (the train
    step's generator); a family draws inputs of its own from other tags,
    which its file names."""
    return (int(seed) * 6364136223846793005 + 1442695040888963407 * (tag + 1)
            ) % (1 << 63)


def beta_quantiles(n: int, lo: float, hi: float, mean: float,
                   concentration: float) -> np.ndarray:
    """The n mid-quantiles (i + ½)/n of a Beta(a, b) on [lo, hi] with the
    given mean and a + b = ``concentration``, rounded to whole phonemes."""
    m = (mean - lo) / (hi - lo)
    a, b = m * concentration, (1.0 - m) * concentration
    x = np.linspace(0.0, 1.0, 20001)
    pdf = np.power(np.clip(x, 1e-12, 1.0), a - 1) * np.power(
        np.clip(1.0 - x, 1e-12, 1.0), b - 1)
    cdf = np.concatenate([[0.0], np.cumsum((pdf[1:] + pdf[:-1]) / 2.0)])
    cdf /= cdf[-1]
    q = np.interp((np.arange(n) + 0.5) / n, cdf, x)
    return np.clip(np.rint(lo + q * (hi - lo)), lo, hi).astype(np.int64)


def exponential_gaps(n: int, rate: float) -> np.ndarray:
    """The n mid-quantiles of the exponential distribution of mean
    1/rate."""
    return -np.log1p(-(np.arange(n) + 0.5) / n) / rate


@dataclass
class Mix:
    """What one run offers: ``sentences`` (token-id arrays), for ``closed``
    and ``train`` the ``batches`` (lists of sentence indices), for ``open``
    the ``arrivals`` (seconds after the window opens, one per request, and
    the sentence each request carries)."""

    spec: dict
    sentences: list[np.ndarray]
    batches: list[list[int]] = field(default_factory=list)
    arrivals: Optional[np.ndarray] = None
    request_sentence: Optional[np.ndarray] = None


def generate(spec: dict, seed: int, vocab: int, seconds: float = 0.0,
             rate: Optional[float] = None) -> Mix:
    """The mix of ``spec`` for run seed ``seed``: token ids uniform over
    1..vocab-1.  ``open`` mixes schedule ``rate`` (default the file's)
    requests a second over ``seconds``."""
    rng = np.random.default_rng(sub_seed(seed, 0))
    ln = spec["lengths"]
    sizes = beta_quantiles(spec["sentences"], ln["min"], ln["max"],
                           ln["mean"], ln["concentration"])
    if spec["mode"] in ("closed", "train"):
        b = spec["batch"]
        if len(sizes) % b:
            raise ValueError("sentences must fill whole batches")
        strata = sizes.reshape(b, len(sizes) // b)
        strata = np.stack([row[rng.permutation(len(row))] for row in strata])
        sizes = strata.T.reshape(-1)                  # batch-major
    else:
        sizes = sizes[np.random.default_rng(1).permutation(len(sizes))]
    sentences = [rng.integers(1, vocab, size=int(n)) for n in sizes]
    mix = Mix(spec=spec, sentences=sentences)
    if spec["mode"] in ("closed", "train"):
        mix.batches = [list(range(i, i + b))
                       for i in range(0, len(sentences), b)]
    elif spec["mode"] == "open":
        rate = float(spec["rate"] if rate is None else rate)
        n = int(np.ceil(rate * seconds)) + 1
        gaps = exponential_gaps(spec["gaps"], rate)
        gaps = gaps[np.random.default_rng(0).permutation(len(gaps))]
        t = np.cumsum(np.resize(gaps, n)) - gaps[0]
        mix.arrivals = t[t < seconds]
        mix.request_sentence = np.arange(len(mix.arrivals)) % len(sentences)
    else:
        raise ValueError(f"unknown traffic mode {spec['mode']!r}")
    return mix


def pad(sentences: list[np.ndarray], buckets: list[int]
        ) -> tuple[np.ndarray, np.ndarray]:
    """(ids (B, L) zero-padded to the smallest bucket that holds the
    longest, lengths (B,))."""
    lens = np.array([len(s) for s in sentences], dtype=np.int64)
    L = next((b for b in buckets if b >= lens.max()), None)
    if L is None:
        raise ValueError(f"a sentence of {lens.max()} phonemes exceeds the "
                         f"text buckets {buckets}")
    ids = np.zeros((len(sentences), L), dtype=np.int64)
    for i, s in enumerate(sentences):
        ids[i, :len(s)] = s
    return ids, lens
