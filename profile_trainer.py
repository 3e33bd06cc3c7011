#!/usr/bin/env python3
"""Where the port's fit loop (``training.Trainer.fit``, what ``cli.train``
runs) spends its time, on one NVIDIA card.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 profile_trainer.py [--steady_steps 12] [--out PATH]

(``--out`` defaults to ``build/profile_trainer.json``.)

It writes ``chip_smoke.py``'s trainer corpus and step-0 checkpoint of the
committed flagship (``intended``/``first`` extraction, B 48, text bucket
128, mel bucket 896, 2 batches an epoch; ``build/trainer_smoke/``), with
HiFi-GAN V1 for the samples' audio, and times three runs from that
checkpoint, TF32 off as in ``chip_smoke.py``:

- ``bare``: the train step alone on the epoch's two batches, a synchronise
  after each (the median of 5, after 2 warm-up steps);
- ``smoke``: the fit at ``chip_smoke.py``'s cadences (6 steps: log every
  2, validation and saves every 3, a vocoded sample at 6, the profiler
  over steps 4-5), each part timed between two synchronises: model build,
  restore, batch assembly, train steps, validations (their batches
  included), samples, checkpoint saves, the profiler's stop and export;
- ``steady``: what every step pays at the shipped cadences
  (``configs/scaled/train.yaml`` logs every 200 steps, validates every
  1000, samples and saves every 5000): ``--steady_steps`` steps with no
  validation, sample, save or profiler among them and no synchronise
  added.  Its period is the host clock from the second step's start to the
  last one's, over the steps between; the batch assembly is timed on the
  host alone.  Beside the bare step it gives the steady host share
  (1 - bare / period) and how much of the assembly the card's queued work
  hides (bare + assembly - period).

Prints one JSON object and writes it to ``--out``.  Without a card it
exits non-zero.
"""

import argparse
import dataclasses
import json
import os
import shutil
import statistics
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "build", "trainer_profile")


def bare_steps(torch, trainer, cfg, batches, n=5, warmup=2):
    """Milliseconds of each synchronised train step on ``batches`` in
    turn, after ``warmup`` steps."""
    from smart_nar_fast_tts_tpu_torch.training import CheckpointManager
    state, _ = CheckpointManager(cfg.train.ckpt_path).restore(
        trainer.init_state(), step=0)
    out = []
    for i in range(warmup + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(state, batches[i % len(batches)],
                           trainer._dropout_generator(i))
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    del state
    torch.cuda.empty_cache()
    return out[warmup:]


def smoke_fit(torch, cfg):
    """The fit at the workspace's cadences, each part timed between two
    synchronises.  Returns (fit seconds, seconds of each part)."""
    import contextlib
    from unittest import mock

    from smart_nar_fast_tts_tpu_torch.data import dataset
    from smart_nar_fast_tts_tpu_torch.training import profiling
    from smart_nar_fast_tts_tpu_torch.training import trainer as trainer_mod
    parts, in_eval = {}, []

    def timed(fn, key):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            if not (key == "batch assembly" and in_eval):
                parts[key] = parts.get(key, 0.0) + (time.perf_counter()
                                                    - t0)
            return out
        return run

    validation = timed(trainer_mod.evaluate, "validation")

    def evaluate(*args, **kwargs):
        in_eval.append(True)
        try:
            return validation(*args, **kwargs)
        finally:
            in_eval.pop()
    make_step = trainer_mod.make_train_step
    T, M = trainer_mod.Trainer, trainer_mod.CheckpointManager
    patches = (
        mock.patch.object(trainer_mod, "make_train_step",
                          lambda *a, **k: timed(make_step(*a, **k),
                                                "train steps")),
        mock.patch.object(trainer_mod, "evaluate", evaluate),
        mock.patch.object(T, "init_state", timed(T.init_state,
                                                 "model build")),
        mock.patch.object(T, "_synth_sample", timed(T._synth_sample,
                                                    "samples")),
        mock.patch.object(M, "restore", timed(M.restore, "restore")),
        mock.patch.object(M, "save", timed(M.save, "checkpoint saves")),
        mock.patch.object(dataset.BucketBatcher, "_collate", timed(
            dataset.BucketBatcher._collate, "batch assembly")),
        mock.patch.object(profiling.StepProfiler, "_stop", timed(
            profiling.StepProfiler._stop, "profiler export")))
    with contextlib.ExitStack() as stack:
        for patch in patches:
            stack.enter_context(patch)
        trainer = T(cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    parts["other"] = wall - sum(parts.values())
    return wall, parts


def steady_fit(torch, cfg, steps):
    """``steps`` steps whose cadences all fall past the last; returns (the
    host clock at each step's start, the host seconds of each batch's
    assembly)."""
    from unittest import mock

    from smart_nar_fast_tts_tpu_torch.data import dataset
    from smart_nar_fast_tts_tpu_torch.training import Trainer
    starts, assembly = [], []
    collate = dataset.BucketBatcher._collate

    def timed_collate(*args, **kwargs):
        t0 = time.perf_counter()
        out = collate(*args, **kwargs)
        assembly.append(time.perf_counter() - t0)
        return out
    trainer = Trainer(cfg)
    step = trainer.train_step

    def timed_step(*args, **kwargs):
        starts.append(time.perf_counter())
        return step(*args, **kwargs)
    trainer.train_step = timed_step
    with mock.patch.object(dataset.BucketBatcher, "_collate", timed_collate):
        trainer.fit()
    torch.cuda.synchronize()
    return starts, assembly


def with_output(cfg, name, step_cfg=None, profile_start_step=None):
    """``cfg`` writing under ``OUT_DIR/name`` from a copy of the
    workspace's step-0 checkpoint."""
    out = os.path.join(OUT_DIR, name)
    shutil.copytree(os.path.join(cfg.train.ckpt_path, "0"),
                    os.path.join(out, "ckpt", "0"))
    train = dataclasses.replace(
        cfg.train, ckpt_path=os.path.join(out, "ckpt"),
        log_path=os.path.join(out, "log"),
        result_path=os.path.join(out, "result"),
        step=step_cfg or cfg.train.step,
        profile_start_step=(cfg.train.profile_start_step
                            if profile_start_step is None
                            else profile_start_step))
    return dataclasses.replace(cfg, train=train)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steady_steps", type=int, default=12)
    parser.add_argument("--out", default=os.path.join(
        REPO, "build", "profile_trainer.json"))
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_trainer: no CUDA card", file=sys.stderr)
        return 1
    if args.steady_steps < 3:
        parser.error("--steady_steps must be at least 3")
    sys.path.insert(0, REPO)
    import numpy as np

    import chip_smoke as cs
    from smart_nar_fast_tts_tpu_torch.config import Config
    from smart_nar_fast_tts_tpu_torch.serving import Synthesizer
    from smart_nar_fast_tts_tpu_torch.training import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    shutil.rmtree(OUT_DIR, ignore_errors=True)
    vocoder = cs.write_hifigan(torch, os.path.join(OUT_DIR, "hifigan"))
    _, _, inv = cs.bench_inputs(np)
    synth = Synthesizer.from_committed()
    paths = cs.trainer_workspace(torch, np, synth, inv, vocoder)
    del synth
    torch.cuda.empty_cache()
    cfg = Config.from_yaml_triplet(*paths)

    trainer = Trainer(cfg)
    batches = [b for b, _, _ in trainer.make_batcher("train.txt").batches(0)]
    bare = bare_steps(torch, trainer, cfg, batches)
    del trainer
    bare_ms = statistics.median(bare)

    smoke_cfg = with_output(cfg, "smoke")
    smoke_wall, parts = smoke_fit(torch, smoke_cfg)
    smoke_steps = smoke_cfg.train.step.total_step

    never = 10 ** 9
    steady_cfg = with_output(cfg, "steady", dataclasses.replace(
        cfg.train.step, total_step=args.steady_steps,
        log_step=args.steady_steps, synth_step=never, val_step=never,
        save_step=never), profile_start_step=0)
    starts, assembly = steady_fit(torch, steady_cfg, args.steady_steps)
    if len(starts) != args.steady_steps:
        raise AssertionError(f"{len(starts)} steps ran")
    period_ms = (starts[-1] - starts[1]) / (len(starts) - 2) * 1e3
    assembly_ms = statistics.mean(assembly) * 1e3

    doc = {
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": cs.nvidia_smi(),
        "batch": [cs.TRAIN_B, cs.TRAIN_L, cs.TRAIN_T],
        "bare": {"step_ms": bare, "median_ms": bare_ms},
        "smoke": {
            "steps": smoke_steps, "cadences": dataclasses.asdict(
                smoke_cfg.train.step),
            "fit_seconds": smoke_wall,
            "fit_ms_per_step": smoke_wall / smoke_steps * 1e3,
            "parts_seconds": parts,
            "parts_share": {k: v / smoke_wall for k, v in parts.items()},
            "host_share": 1.0 - smoke_steps * bare_ms / 1e3 / smoke_wall},
        "steady": {
            "steps": args.steady_steps,
            "period_ms": period_ms,
            "step_start_gaps_ms": [(b - a) * 1e3
                                   for a, b in zip(starts, starts[1:])],
            "batches_assembled": len(assembly),
            "assembly_ms_per_batch": assembly_ms,
            "host_share": 1.0 - bare_ms / period_ms,
            "assembly_hidden_ms": bare_ms + assembly_ms - period_ms},
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print(json.dumps(doc), flush=True)
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    shutil.rmtree(cs.TRAINER_DIR, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
