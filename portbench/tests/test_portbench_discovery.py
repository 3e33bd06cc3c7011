"""A per-layer metric is a file of its own: a copy of the benchmark with
one more metric file and its entry in BENCHMARK.json reports it, with no
other edit."""

import json
import os
import shutil
import subprocess
import sys

from portbench.tests import tiny

READER = '''"""A test metric: traced batches."""


def read(run):
    return float(run.record["batches"])
'''


def test_new_metric_file_is_read(tmp_path):
    shutil.copytree(tiny.ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "dummy_batches.serve", "unit": "batches", "better": "higher",
        "source": "program_counter", "layer": "request queue",
        "moves": "serve_audio_s_per_s", "workloads": ["fs2_hifigan_v1.batch"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "portbench" / "metrics" / "dummy_batches.serve.py"
     ).write_text(READER)
    code = ("from portbench.tests import tiny\n"
            "r = tiny.run('fs2_hifigan_v1.batch', trace=True, seconds=0.4)\n"
            "import json; print(json.dumps(r['metrics']))")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{tiny.REPO}")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr
    metrics = json.loads(p.stdout.strip().splitlines()[-1])
    assert metrics["dummy_batches.serve"]["value"] >= 1
    assert metrics["dummy_batches.serve"]["unit"] == "batches"
