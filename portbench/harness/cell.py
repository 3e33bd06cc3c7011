"""One run of one cell: everything ``run.py`` does after its checks of the
machine, so that tests can drive it on the CPU at a small size."""

from __future__ import annotations

import json
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Callable, Optional

import torch

from . import check, drivers, families, traffic
from .trace import Tracer

ROOT = Path(__file__).resolve().parent.parent
CONFIG_DIR = ROOT / "configs"
METRIC_DIR = ROOT / "metrics"


def benchmark() -> dict:
    return json.loads((ROOT.parent / "BENCHMARK.json").read_text())


def find(items: list[dict], name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise SystemExit(f"portbench: no {what} named {name!r} in BENCHMARK.json")


def load_config(name: str) -> dict:
    return json.loads((CONFIG_DIR / f"{name}.json").read_text())


def metric_reader(name: str) -> Callable:
    """``metrics/<name>.py``'s ``read``."""
    return families.load_file(
        METRIC_DIR / f"{name}.py",
        "portbench_metric_" + name.replace(".", "_").replace("-", "_")).read


@dataclass
class Context:
    """What a driver needs, and the hooks through which tests break the
    program underneath."""

    cell: dict
    cfg: dict
    spec: dict
    seed: int
    seconds: float
    tracer: Tracer
    device: str
    t_start: float
    acoustic: ModuleType
    vocoder: ModuleType
    control: bool = False
    rate: Optional[float] = None
    setup_s: Optional[float] = None
    wrap_synth: Callable = staticmethod(lambda synth: synth)
    wrap_step: Callable = staticmethod(lambda step: step)

    def build(self, srv):
        return self.wrap_synth(srv.build())

    def make_step(self, step):
        return self.wrap_step(step)

    def setup_done(self):
        self.setup_s = time.perf_counter() - self.t_start

    @property
    def cuda(self) -> bool:
        return torch.device(self.device).type == "cuda"

    def peak_bytes(self) -> int:
        if self.cuda:
            torch.cuda.synchronize()
            return int(torch.cuda.max_memory_allocated())
        return 0

    def free(self):
        import gc
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()


@dataclass
class MetricInput:
    """What a per-layer reader reads: the cell, its configuration and
    traffic, the reduced trace, the record of ``drivers.py`` (counters, CUDA
    event totals, the shapes of each traced batch or step), and the
    configuration's families (their FLOPs and shapes)."""

    cell: dict
    cfg: dict
    spec: dict
    trace: object
    record: dict = field(default_factory=dict)
    acoustic: Optional[ModuleType] = None
    vocoder: Optional[ModuleType] = None


def nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", control: bool = False,
        rate: Optional[float] = None, bench: Optional[dict] = None,
        cfg: Optional[dict] = None, spec: Optional[dict] = None,
        limits: Optional[dict] = None, **hooks) -> dict:
    """The result line's object (``checks`` last)."""
    bench = bench or benchmark()
    cell = find(bench["workloads"], workload, "workload")
    cfg = cfg or load_config(cell["config"])
    spec = spec or traffic.load(cell["traffic"])
    tracer = Tracer(trace)
    acoustic, vocoder = families.of(cfg)
    ctx = Context(cell=cell, cfg=cfg, spec=spec, seed=int(seed),
                  seconds=float(seconds), tracer=tracer, device=device,
                  t_start=t_start, acoustic=acoustic, vocoder=vocoder,
                  control=control, rate=rate, **hooks)
    outcome = drivers.MODES[spec["mode"]](ctx)
    lim = limits if limits is not None else check.limits(workload)
    correct = check.verdict(outcome.numbers, lim)

    result: dict = {"correct": correct, "attempted": outcome.attempted,
                    "failed": outcome.failed}
    device_info = {"platform": "gpu" if ctx.cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if ctx.cuda
                   else "cpu", "count": 1,
                   "memory_peak_bytes": outcome.peak_bytes,
                   "nvidia_smi": nvidia_smi() if ctx.cuda else "none"}
    if not trace:
        metrics = {"setup_s": {"value": ctx.setup_s, "unit": "s"}}
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        for name, value in outcome.metrics.items():
            metrics[name] = {"value": value, "unit": units[name]}
    else:
        red = tracer.reduce()
        inp = MetricInput(cell=cell, cfg=cfg, spec=spec, trace=red,
                          record=outcome.record, acoustic=acoustic,
                          vocoder=vocoder)
        metrics = {}
        for m in bench["per_layer"]:
            if workload not in m.get("workloads", [workload]):
                continue
            value = metric_reader(m["name"])(inp)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=red.busy_s, window_s=red.window_s)
        result["breakdown"] = {"device_ops": red.device_ops(),
                               "idle_gaps": red.idle_gaps()}
    result["metrics"] = metrics
    result["device"] = device_info
    if outcome.control is not None:
        result["control"] = {name: check.report(nums, lim)
                             for name, nums in outcome.control.items()}
    result["record"] = {k: v for k, v in outcome.record.items()
                        if isinstance(v, (int, float))}
    result["checks"] = check.report(outcome.numbers, lim)
    return result
