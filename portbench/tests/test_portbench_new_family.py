"""A new architecture is new files only: a copy of the benchmark with a toy
acoustic family that takes no durations and a toy vocoder family
(``tests/toy/``: family files, a configuration, traffic files carrying a
key the generator does not know, limits files naming only ``mel_gap`` and
``wav_gap``) and their entries in BENCHMARK.json runs closed and open on
the CPU, judged on those two numbers, with no file of the benchmark
edited; a fault planted in the toy program reads ``correct`` false."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench.tests import tiny

TOY = tiny.ROOT / "tests" / "toy"
CELLS = ("toy.batch", "toy.online")

RUN = '''
import json, sys, time
import torch
from portbench.harness import cell


def wave(synth):
    stage_b = synth.stage_b
    synth.stage_b = lambda mel: stage_b(mel) * 1.001
    return synth


def model(synth):
    with torch.no_grad():
        synth.model.out.bias.add_(1e-3)
    return synth


out = {}
for w in sys.argv[1:]:
    for name, fault in (("sound", None), ("wave", wave), ("model", model)):
        hooks = {} if fault is None else {"wrap_synth": fault}
        r = cell.run(w, 2**31 + 21, 0.6, False, time.perf_counter(),
                     device="cpu", **hooks)
        out[f"{w}.{name}"] = {"correct": r["correct"],
                              "checks": list(r["checks"]),
                              "compared": r["record"]["compared_items"],
                              "attempted": r["attempted"]}
print(json.dumps(out))
'''


def _copy_with_toy(tmp_path):
    root = tmp_path / "portbench"
    shutil.copytree(tiny.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for path in TOY.rglob("*"):
        if path.is_file():
            dest = root / path.relative_to(TOY)
            assert not dest.exists(), dest
            shutil.copy(path, dest)
    bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "toy", "source": "a test's own configuration",
        "file": "portbench/configs/toy.json", "reduced": [],
        "why": "an acoustic family with no durations"})
    for cell, traffic in zip(CELLS, ("toy_batch", "toy_online")):
        bench["workloads"].append({
            "name": cell, "config": "toy", "traffic": traffic, "chips": 1,
            "why": "a family added with new files only"})
    for m in bench["end_to_end"]:
        if m["name"] == "serve_audio_s_per_s":
            m["workloads"].append("toy.batch")
        if m["name"] == "serve_p95_ms":
            m["workloads"].append("toy.online")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def toy_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("toy")
    _copy_with_toy(tmp)
    env = dict(os.environ, PYTHONPATH=f"{tmp}{os.pathsep}{tiny.REPO}")
    p = subprocess.run([sys.executable, "-c", RUN, *CELLS], cwd=tmp,
                       env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", CELLS)
def test_toy_family_runs_correct(toy_runs, workload):
    r = toy_runs[f"{workload}.sound"]
    assert r["correct"] is True
    assert r["checks"] == ["mel_gap", "wav_gap"]
    assert r["compared"] > 0 and r["attempted"] > 0


@pytest.mark.parametrize("fault", ["wave", "model"])
@pytest.mark.parametrize("workload", CELLS)
def test_toy_family_fault_incorrect(toy_runs, workload, fault):
    r = toy_runs[f"{workload}.{fault}"]
    assert r["correct"] is False
    assert r["checks"] == ["mel_gap", "wav_gap"]
