"""The traffic generator: reproducible by seed, the same sizes and gaps for
every seed, lengths within the mix's range."""

import numpy as np
import pytest

from portbench.tests import tiny  # noqa: F401
from portbench.harness import traffic

SEEDS = (0, 7, 2**31 + 5, 3 * 2**31 + 1)


@pytest.mark.parametrize("name", ["batch", "longform", "online", "train"])
def test_same_seed_same_mix(name):
    spec = traffic.load(name)
    a = traffic.generate(spec, 2**31 + 3, 361, seconds=5.0)
    b = traffic.generate(spec, 2**31 + 3, 361, seconds=5.0)
    assert all(np.array_equal(x, y) for x, y in zip(a.sentences, b.sentences))
    assert a.batches == b.batches
    if spec["mode"] == "open":
        assert np.array_equal(a.arrivals, b.arrivals)


@pytest.mark.parametrize("name", ["batch", "longform", "online", "train"])
def test_every_seed_same_sizes(name):
    spec = traffic.load(name)
    sizes = [sorted(len(s) for s in traffic.generate(spec, seed, 361,
                                                     seconds=5.0).sentences)
             for seed in SEEDS]
    assert all(s == sizes[0] for s in sizes)
    ln = spec["lengths"]
    assert ln["min"] <= min(sizes[0]) and max(sizes[0]) <= ln["max"]
    assert abs(np.mean(sizes[0]) - ln["mean"]) < 0.05 * ln["mean"]
    mixes = [traffic.generate(spec, seed, 361, seconds=5.0) for seed in SEEDS]
    assert not np.array_equal(mixes[0].sentences[0], mixes[1].sentences[0])
    for m in mixes:
        assert all(1 <= s.min() and s.max() < 361 for s in m.sentences)


def test_open_mix_rate():
    spec = traffic.load("online")
    gaps = traffic.exponential_gaps(spec["gaps"], 40.0)
    assert abs(gaps.mean() - 1 / 40.0) < 2e-3 / 40.0
    counts = [len(traffic.generate(spec, s, 361, seconds=20.0,
                                   rate=40.0).arrivals) for s in SEEDS]
    assert all(abs(c - 800) <= 40 for c in counts)


def test_pad_to_bucket():
    ids, lens = traffic.pad([np.arange(1, 4), np.arange(1, 9)], [4, 8, 16])
    assert ids.shape == (2, 8) and list(lens) == [3, 8]
    assert ids[0, 3:].sum() == 0
    with pytest.raises(ValueError):
        traffic.pad([np.arange(1, 20)], [4, 8, 16])
