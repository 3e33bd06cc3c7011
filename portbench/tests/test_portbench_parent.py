"""Nothing measured moved when the model families left the harness: the
seeded weights (each leaf's sha256, the calibrated duration bias), the
mixes, the FLOP counts and the per-layer readings that hang on them are
those of the tree before the move (commit cd6411e), recorded on the CPU
at the configurations' published widths (``parent_digests.json``) and on
hand-built records below."""

import hashlib
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from portbench.tests import tiny  # noqa: F401
from portbench.harness import cell, drivers, families, traffic
from portbench.harness.trace import Trace

PARENT = json.loads((Path(__file__).parent / "parent_digests.json")
                    .read_text())
SEED = PARENT["seed"]
HEAD = "variance_adaptor.duration_predictor.linear_layer"


def _leaf(t) -> str:
    a = t.detach().cpu().contiguous().numpy()
    h = hashlib.sha256(str((a.dtype.str, a.shape)).encode())
    h.update(a.tobytes())
    return h.hexdigest()[:16]


def _mix(m) -> str:
    h = hashlib.sha256()
    for s in m.sentences:
        h.update(np.asarray(s, dtype=np.int64).tobytes())
        h.update(b"|")
    h.update(json.dumps(m.batches).encode())
    if m.arrivals is not None:
        h.update(np.asarray(m.arrivals, dtype=np.float64).tobytes())
        h.update(np.asarray(m.request_sentence, dtype=np.int64).tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("cfg_name,mix_name", [
    ("fs2_hifigan_v1", "batch"), ("fs2_hifigan_v1", "online"),
    ("fastspeech_vocos", "longform")])
def test_serving_weights(cfg_name, mix_name):
    cfg, spec = cell.load_config(cfg_name), traffic.load(mix_name)
    mix = traffic.generate(spec, SEED, cfg["acoustic"]["vocab_size"],
                           seconds=20.0)
    acoustic, vocoder = families.of(cfg)
    srv = drivers.Serving(SimpleNamespace(
        cfg=cfg, spec=spec, seed=SEED, device="cpu", acoustic=acoustic,
        vocoder=vocoder), mix)
    want = PARENT["configs"][cfg_name]
    treated = want["treated"][mix_name]
    assert float(srv.acoustic.bias).hex() == treated["bias"]
    Wa, Wv = srv.weights()
    got = {n: _leaf(t) for n, t in Wa.items()}
    assert {n: h for n, h in got.items() if n.startswith(HEAD)} == {
        n: h for n, h in treated.items() if n != "bias"}
    drawn = {n: h for n, h in want["acoustic"].items()
             if not n.startswith(HEAD)}
    assert {n: h for n, h in got.items() if not n.startswith(HEAD)} == drawn
    assert {n: _leaf(t) for n, t in Wv.items()} == want["vocoder"]


def test_train_weights():
    cfg, spec = cell.load_config("fs2_hifigan_v1"), traffic.load("train")
    mix = traffic.generate(spec, SEED, cfg["acoustic"]["vocab_size"])
    acoustic, _ = families.of(cfg)
    W0 = acoustic.Training(cfg, spec, SEED, "cpu", mix).initial()
    assert {n: _leaf(t) for n, t in W0.items()} == \
        PARENT["configs"]["fs2_hifigan_v1"]["acoustic"]


@pytest.mark.parametrize("name", ["batch", "longform", "online", "train"])
def test_mixes(name):
    mix = traffic.generate(traffic.load(name), SEED, 361, seconds=20.0)
    assert _mix(mix) == PARENT["mixes"][name]


# FLOPs of the parent's harness/flops.py: forward (L 70, T 560), training
# (the same), vocoder (T 1000)
FLOPS = {"fs2_hifigan_v1": (21680081920, 96904586240, 614105088000),
         "fastspeech_vocos": (40369781760, 192419189760, 26990592000)}
# the parent's readers on the records below: mfu.serve, mfu.train
MFU = {"fs2_hifigan_v1": (0.3638399501860202, 0.10712074918529293),
       "fastspeech_vocos": (0.06262455715943434, 0.215813697536)}
LAUNCHES = [
    {"src_lens": np.array([60, 120, 33]), "mel_lens": np.array([480, 1000,
                                                                250])},
    {"src_lens": np.array([360, 200]), "mel_lens": np.array([3000, 2100])}]


@pytest.mark.parametrize("name", sorted(FLOPS))
def test_flops_and_mfu(name):
    cfg = cell.load_config(name)
    acoustic, vocoder = families.of(cfg)
    a, v = cfg["acoustic"], cfg["vocoder"]
    assert (acoustic.forward_flops(a, 70, 560), acoustic.train_flops(
        a, 70, 560), vocoder.forward_flops(v, 1000)) == FLOPS[name]
    inp = cell.MetricInput(cell={}, cfg=cfg, spec={}, trace=Trace(
        window_s=2.5, kernels=[("k", 0.0, 1.0)]), record={
        "launches": LAUNCHES}, acoustic=acoustic, vocoder=vocoder)
    assert (cell.metric_reader("mfu.serve")(inp),
            cell.metric_reader("mfu.train")(inp)) == MFU[name]


def test_resblock_roofline_reads_the_recorded_frames():
    """The parent read 24.906189073159904 % here, through the cut of
    ``drivers.Serving`` of each batch's mel_lens on the batch mix: 1000,
    768 and 128 frames, which ``drivers.py`` now records as
    ``vocoder_frames``."""
    cfg = cell.load_config("fs2_hifigan_v1")
    acoustic, vocoder = families.of(cfg)
    launches = [
        {"B": 16, "mel_lens": np.array([900, 1000, 350] + [500] * 13),
         "vocoder_frames": 1000},
        {"B": 16, "mel_lens": np.array([600, 700] + [300] * 14),
         "vocoder_frames": 768},
        {"B": 3, "mel_lens": np.array([100, 120, 90]),
         "vocoder_frames": 128}]
    kernels, t = [], 0.0
    for i in range(72 * len(launches)):
        kernels.append(("void resblock_conv_kernel<128,3,1>", t, t + 0.002))
        t += 0.0025
        if i % 24 == 0:
            kernels.append(("resblock_weight_split_kernel", t, t + 0.0001))
            t += 0.0002
    inp = cell.MetricInput(
        cell={}, cfg=cfg, spec=traffic.load("batch"),
        trace=Trace(window_s=t + 1, kernels=kernels),
        record={"launches": launches}, acoustic=acoustic, vocoder=vocoder)
    read = cell.metric_reader("resblock_roofline.serve")
    assert read(inp) == 24.906189073159904
    assert read(cell.MetricInput(
        cell={}, cfg=cell.load_config("fastspeech_vocos"), spec={},
        trace=inp.trace, record=inp.record,
        vocoder=families.load("vocos"))) is None
