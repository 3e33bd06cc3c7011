#!/usr/bin/env python3
"""Profile the port's acoustic-model train step, or its vocoder GAN step,
on one NVIDIA card.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 profile_train_step.py [--step acoustic|vocoder] [--steps 3]
                                  [--out PATH]

(``--out`` defaults to ``build/profile_<step>_step.json``.)

``acoustic`` builds the same step as ``chip_smoke.py``'s train phase (the
committed flagship with ``intended``/``first`` duration extraction, B 48,
L 128, T 896, targets from the port's own stage-A output, seeded dropout);
``vocoder`` the same GAN step as its vocoder train phase (committed HiFi-GAN
V1, seeded full discriminator, B 16 × 8192-sample segments of the port's
own synthesis).  It warms up two steps, then traces ``--steps`` steps with
``torch.profiler`` and prints one JSON object: the steps' wall time, the
card's busy time (the union of its kernels' intervals) and idle share over
that window, the device time of each kernel by name and of each operator by
self device time; for ``vocoder`` also the step's phases (its
``tts.gan.*`` spans: host ms, device span, kernel ms); for
``acoustic`` each hand-written kernel's backward on the step's path (its
recompute of the plain version) timed alone at the step's shapes by CUDA
events.  Without a card it exits non-zero.
"""

import argparse
import json
import math
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


def phases_ms(prof, prefix, steps, kernel_events):
    """Per step, each ``record_function`` range whose name starts with
    ``prefix``: its host time, and on the card its span (from its start to
    its last kernel's end), busy time and kernel time.  The trace mirrors a
    range on the card from the first kernel launched in it, once for each
    stream, but leaves out the kernels the autograd engine's thread
    launches (the backward); so a phase holds every kernel that starts
    between its first mirror and the next phase's.  ``starts`` counts the
    phase starts found (the phases times the steps when the reading
    holds)."""
    host, mirrors = {}, []
    for e in prof.events():
        if not e.name.startswith(prefix):
            continue
        name = e.name[len(prefix):]
        if e.device_type.name == "CUDA":
            mirrors.append((e.time_range.start, name))
        else:
            host[name] = host.get(name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3 / steps
    mirrors.sort()
    starts = [m for i, m in enumerate(mirrors)
              if i == 0 or m[1] != mirrors[i - 1][1]]
    out = {name: dict(host_ms=t, device_span_ms=0.0, busy_ms=0.0,
                      kernel_ms=0.0) for name, t in host.items()}
    for (t0, name), (t1, _) in zip(starts, starts[1:] + [(math.inf, "")]):
        ks = [(k.time_range.start, k.time_range.end) for k in kernel_events
              if t0 <= k.time_range.start < t1]
        if ks:
            d = out[name]
            d["device_span_ms"] += (max(e for _, e in ks) - t0) / 1e3 / steps
            d["busy_ms"] += union_ms(ks) / steps
            d["kernel_ms"] += sum(e - s for s, e in ks) / 1e3 / steps
    return {"starts": len(starts), **out}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--step", choices=("acoustic", "vocoder"),
                        default="acoustic")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    args.out = args.out or os.path.join(REPO, "build",
                                        f"profile_{args.step}_step.json")
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

    texts, src_lens, inv = cs.bench_inputs(np)
    synth = Synthesizer.from_committed()
    if args.step == "acoustic":
        batch = cs.train_batch(torch, np, synth, inv)
        state = create_train_state(committed_flagship(ModelConfig(
            duration_extraction="intended", duration_head_reduce="first")))
        generator = torch.Generator(device="cuda").manual_seed(0)
        train = make_train_step(FastSpeech2Loss())

        def step():
            train(state, batch, generator)
    else:
        from smart_nar_fast_tts_tpu_torch.audio import MelSpectrogramConfig
        from smart_nar_fast_tts_tpu_torch.serving import committed_vocoder
        from smart_nar_fast_tts_tpu_torch.training import (
            VocoderOptimizer, create_vocoder_state, make_vocoder_train_step)
        from smart_nar_fast_tts_tpu_torch.vocoder import HiFiGANDiscriminator
        wav, mel_lens = synth.synthesize(texts, src_lens)
        segments = cs.vocoder_segments(torch, np, wav, mel_lens,
                                       synth.hop_length)
        tx = VocoderOptimizer()
        state = create_vocoder_state(committed_vocoder(),
                                     HiFiGANDiscriminator(seed=0), tx, tx)
        gan = make_vocoder_train_step(MelSpectrogramConfig())

        def step():
            gan(state, segments)
    del synth
    for _ in range(2):
        step()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device kernels and copies; record_function ranges mirrored on the
    # device (user annotations) overlap them and are left out
    kernel_events = [e for e in prof.events()
                     if e.device_type.name == "CUDA"
                     and not e.is_user_annotation]
    busy_ms = union_ms([(e.time_range.start, e.time_range.end)
                        for e in kernel_events])
    by_kernel = {}
    for e in kernel_events:
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
    # operators only: the ranges' device mirrors would count as operators
    ranges = {e.name for e in prof.events() if e.is_user_annotation}
    ops = sorted((a for a in prof.key_averages() if a.key not in ranges),
                 key=lambda a: -a.self_device_time_total)

    step_ms = wall_ms / args.steps
    doc = {
        "step": args.step,
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": cs.nvidia_smi(),
        "steps": args.steps, "step_ms": step_ms,
        "device_busy_ms_per_step": busy_ms / args.steps,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "kernels_per_step": len(kernel_events) / args.steps,
        "streams": len({e.device_resource_id for e in kernel_events}),
        "kernel_sum_ms_per_step": sum(by_kernel.values()) / args.steps,
        "convolution_kernel_ms_per_step": sum(
            v for k, v in by_kernel.items() if any(
                w in k for w in ("conv", "cudnn", "xmma", "grad"))
        ) / args.steps,
        "kernel_ms_per_step": dict(sorted(
            ((k, v / args.steps) for k, v in by_kernel.items()),
            key=lambda kv: -kv[1])[:40]),
        "op_self_device_ms_per_step": {
            a.key: a.self_device_time_total / 1e3 / args.steps
            for a in ops[:30]},
    }
    if args.step == "vocoder":
        from smart_nar_fast_tts_tpu_torch.tracing import PREFIX
        doc["phases_per_step"] = phases_ms(prof, PREFIX + "gan.", args.steps,
                                           kernel_events)
    if args.step == "acoustic":
        # each kernel's backward on the step's path alone, at its shapes
        # (self-attention at T 896 takes the einsum branch: no flash)
        rng = np.random.default_rng(5)

        def randn(*shape):
            return torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).cuda()
        B, L, T = cs.TRAIN_B, cs.TRAIN_L, cs.TRAIN_T
        valid_l = torch.arange(L, device="cuda")[None] < \
            batch.src_lens[:, None]
        backward = {
            "alignment_attention (48, 2, 896, 128, 128)": backward_ms(
                torch, cs, lambda *a: (lambda r: (r[0], r[2]))(
                    kernels.alignment_attention(
                        *a, valid_l, batch.src_lens, batch.mel_lens)),
                [randn(B, 2, T, 128), randn(B, 2, L, 128),
                 randn(B, 2, L, 128)], [randn(B, 2, T, 128), randn(B)]),
            "gaussian_upsample_banded (48, 128, 256) -> 896": backward_ms(
                torch, cs, lambda x: (kernels.gaussian_upsample_banded(
                    x, torch.full((B, L), 7.0, device="cuda"), T,
                    valid_l.float())[0],),
                [randn(B, L, 256)], [randn(B, T, 256)]),
        }
        per_step = {"alignment_attention (48, 2, 896, 128, 128)": 4,
                    "gaussian_upsample_banded (48, 128, 256) -> 896": 1}
        recompute_ms = sum(per_step[k] * v for k, v in backward.items())
        doc.update(backward_recompute_ms_each=backward,
                   backward_recompute_ms_per_step=recompute_ms,
                   backward_recompute_share_of_step=recompute_ms / step_ms)
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
