#!/usr/bin/env python3
"""Profile the port's acoustic-model train step on one NVIDIA card.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 profile_train_step.py [--steps 3] [--out PATH]

(``--out`` defaults to ``build/profile_train_step.json``.)

It builds the same step as ``chip_smoke.py``'s train phase (the committed
flagship with ``intended``/``first`` duration extraction, B 48, L 128,
T 896, targets from the port's own stage-A output, seeded dropout), warms up
two steps, then traces ``--steps`` steps with ``torch.profiler`` and prints
one JSON object: the steps' wall time, the card's busy time (the union of its
kernels' intervals) and idle share over that window, the device time of each
kernel by name and of each operator by self device time, and each hand-written
kernel's backward (its recompute of the plain version) timed alone at the
step's shapes by CUDA events.  Without a card it exits non-zero.
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def union_ms(intervals):
    """Total length of the union of (start, end) intervals in µs, as ms."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def backward_ms(torch, chip_smoke, fn, leaves, cts):
    """Device ms of one backward through ``fn`` (a kernel's
    autograd.Function recomputing its plain version), forward excluded."""
    leaves = [t.detach().clone().requires_grad_() for t in leaves]
    outs = fn(*leaves)
    return chip_smoke.device_ms(lambda: torch.autograd.grad(
        outs, leaves, cts, retain_graph=True), torch, reps=5, warmup=1)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--out", default=os.path.join(
        REPO, "build", "profile_train_step.json"))
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_train_step: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from smart_nar_fast_tts_tpu_torch import kernels
    from smart_nar_fast_tts_tpu_torch.config import ModelConfig
    from smart_nar_fast_tts_tpu_torch.models import FastSpeech2Loss
    from smart_nar_fast_tts_tpu_torch.serving import (Synthesizer,
                                                      committed_flagship)
    from smart_nar_fast_tts_tpu_torch.training import (create_train_state,
                                                       make_train_step)

    _, _, inv = cs.bench_inputs(np)
    synth = Synthesizer.from_committed()
    batch = cs.train_batch(torch, np, synth, inv)
    del synth
    state = create_train_state(committed_flagship(ModelConfig(
        duration_extraction="intended", duration_head_reduce="first")))
    step = make_train_step(FastSpeech2Loss())
    generator = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(2):
        step(state, batch, generator)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(state, batch, generator)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernel_events = [e for e in prof.events()
                     if e.device_type.name == "CUDA"]
    busy_ms = union_ms([(e.time_range.start, e.time_range.end)
                        for e in kernel_events])
    by_kernel = {}
    for e in kernel_events:
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
    ops = sorted(prof.key_averages(), key=lambda a: -a.self_device_time_total)

    # each kernel's backward alone, at the step's shapes
    rng = np.random.default_rng(5)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).cuda()
    B, L, T = cs.TRAIN_B, cs.TRAIN_L, cs.TRAIN_T
    valid_t = torch.arange(T, device="cuda")[None] < batch.mel_lens[:, None]
    valid_l = torch.arange(L, device="cuda")[None] < batch.src_lens[:, None]
    qkv_t = [randn(B, 2, T, 128) for _ in range(3)]
    qkv_l = [randn(B, 2, L, 128) for _ in range(3)]
    backward = {
        "flash_attention decoder (48, 2, 896, 128)": backward_ms(
            torch, cs, lambda *a: (kernels.flash_attention(*a, valid_t),),
            qkv_t, [randn(B, 2, T, 128)]),
        "flash_attention encoder (48, 2, 128, 128)": backward_ms(
            torch, cs, lambda *a: (kernels.flash_attention(*a, valid_l),),
            qkv_l, [randn(B, 2, L, 128)]),
        "alignment_attention (48, 2, 896, 128, 128)": backward_ms(
            torch, cs, lambda *a: (lambda r: (r[0], r[2]))(
                kernels.alignment_attention(
                    *a, valid_l, batch.src_lens, batch.mel_lens)),
            [qkv_t[0], qkv_l[1], qkv_l[2]], [randn(B, 2, T, 128), randn(B)]),
        "gaussian_upsample_banded (48, 128, 256) -> 896": backward_ms(
            torch, cs, lambda x: (kernels.gaussian_upsample_banded(
                x, torch.full((B, L), 7.0, device="cuda"), T,
                valid_l.float())[0],),
            [randn(B, L, 256)], [randn(B, T, 256)]),
    }
    per_step = {"flash_attention decoder (48, 2, 896, 128)": 4,
                "flash_attention encoder (48, 2, 128, 128)": 4,
                "alignment_attention (48, 2, 896, 128, 128)": 4,
                "gaussian_upsample_banded (48, 128, 256) -> 896": 1}
    step_ms = wall_ms / args.steps
    recompute_ms = sum(per_step[k] * v for k, v in backward.items())
    doc = {
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": cs.nvidia_smi(),
        "steps": args.steps, "step_ms": step_ms,
        "device_busy_ms_per_step": busy_ms / args.steps,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "kernels_per_step": len(kernel_events) / args.steps,
        "kernel_ms_per_step": dict(sorted(
            ((k, v / args.steps) for k, v in by_kernel.items()),
            key=lambda kv: -kv[1])[:40]),
        "op_self_device_ms_per_step": {
            a.key: a.self_device_time_total / 1e3 / args.steps
            for a in ops[:30]},
        "backward_recompute_ms_each": backward,
        "backward_recompute_ms_per_step": recompute_ms,
        "backward_recompute_share_of_step": recompute_ms / step_ms,
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print(json.dumps({k: v for k, v in doc.items()
                      if k not in ("kernel_ms_per_step",
                                   "op_self_device_ms_per_step")}))
    print(json.dumps({"top_kernels": dict(list(
        doc["kernel_ms_per_step"].items())[:15])}))
    print(json.dumps({"top_ops": dict(list(
        doc["op_self_device_ms_per_step"].items())[:15])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
