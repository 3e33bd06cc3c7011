"""Small configurations and mixes for running the harness on the CPU."""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
REPO = ROOT.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench.harness import cell, families, traffic  # noqa: E402

CELLS = {"fs2_hifigan_v1.batch": ("fs2_hifigan_v1", "batch"),
         "fastspeech_vocos.longform": ("fastspeech_vocos", "longform"),
         "fs2_hifigan_v1.online": ("fs2_hifigan_v1", "online"),
         "fs2_hifigan_v1.train": ("fs2_hifigan_v1", "train")}


def config(name: str) -> dict:
    """The configuration at its families' small widths and depths."""
    cfg = json.loads((ROOT / "configs" / f"{name}.json").read_text())
    acoustic, vocoder = families.of(cfg)
    acoustic.tiny(cfg["acoustic"])
    vocoder.tiny(cfg["vocoder"])
    return cfg


def mix(name: str) -> dict:
    """The traffic mix at a few short sentences."""
    s = traffic.load(name)
    short = {"min": 5, "max": 20, "mean": 12, "concentration": 4.0}
    if s["mode"] == "closed":
        s.update(batch=2, sentences=6, check_batches=2,
                 t_cap=200 if s["entry"] == "synthesize" else 300,
                 text_buckets=[24])
    elif s["mode"] == "open":
        s.update(max_batch=3, sentences=16, t_cap=200, check_requests=4,
                 rate=20.0, gaps=64, text_buckets=[24])
    else:
        s.update(batch=3, sentences=12, mel_pad=64, frames_per_phoneme=3.0,
                 text_buckets=[16])
        short = {"min": 5, "max": 16, "mean": 10, "concentration": 4.0}
    s["lengths"] = short
    if "vocoder_buckets" in s:
        # the port's mel buckets under the small cap (128, then the cap)
        s["vocoder_buckets"] = [128, 200]
    return s


def run(workload: str, seed: int = 2**31 + 11, seconds: float = 0.6,
        trace: bool = False, **kw) -> dict:
    """One run of ``workload`` on the CPU at the small sizes."""
    cfg_name, mix_name = CELLS[workload]
    return cell.run(workload, seed, seconds, trace, time.perf_counter(),
                    device="cpu", cfg=kw.pop("cfg", config(cfg_name)),
                    spec=kw.pop("spec", mix(mix_name)), **kw)
