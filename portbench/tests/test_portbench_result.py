"""The result line: its keys and shapes for every cell, traced and not, on
the CPU at small sizes; ``run.py`` refuses to run without the card and in
a directory that holds only the benchmark."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench.tests import tiny

E2E = {"fs2_hifigan_v1.batch": "serve_audio_s_per_s",
       "fastspeech_vocos.longform": "serve_audio_s_per_s",
       "fs2_hifigan_v1.online": "serve_p95_ms",
       "fs2_hifigan_v1.train": "train_audio_s_per_s"}


@pytest.mark.parametrize("workload", sorted(tiny.CELLS))
def test_result_line(workload):
    r = tiny.run(workload)
    assert list(r)[:3] == ["correct", "attempted", "failed"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"setup_s", E2E[workload]}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    for key in ("platform", "kind", "count", "memory_peak_bytes"):
        assert key in r["device"]
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    json.loads(json.dumps(r))


def test_traced_result_line():
    r = tiny.run("fs2_hifigan_v1.batch", trace=True)
    assert "setup_s" not in r["metrics"]
    assert {"stage_a_ms.serve", "stage_b_ms.serve"} <= set(r["metrics"])
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["device"]["window_s"] > 0


def _run_py(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "fs2_hifigan_v1.batch", "--seed", str(2**31 + 9), "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_no_card_no_result():
    p = _run_py(tiny.REPO)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(tiny.ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_py(tmp_path, {"PYTHONPATH": ""})
    assert p.returncode != 0
    assert p.stdout.strip() == ""
