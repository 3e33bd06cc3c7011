"""Vocoder (fine-)tuning CLI of the port, with the flags of ``python -m
smart_nar_fast_tts_tpu.cli.train_vocoder`` plus ``--device``::

    python -m smart_nar_fast_tts_tpu_torch.cli.train_vocoder \\
        --wav_dir /path/to/wavs --steps 10000 [--batch_size 16] \\
        [--segment_size 8192] [--generator hifigan|vocos|melgan] \\
        [--restore_generator generator.pth.tar|generator.msgpack] \\
        [--out_dir ./output/vocoder] [--device cpu]

The GAN step is ``training/vocoder.py``'s, whatever the
generator family: the input mel and the real branch of the mel loss come
from the ``fused_log_mel`` kernel on the raw segments.  It runs on CUDA
unless ``--device cpu`` is given.  ``--restore_generator`` takes the port's
``.pth.tar`` of the same family or the JAX CLI's flax ``.msgpack``.
Checkpoints are ``generator_<step>.pth.tar`` holding ``{"generator":
state_dict}`` (upstream's layout, which ``vocoder.load_vocoder`` reads; the
JAX CLI writes ``.msgpack``), with ``config.json`` (``{"family": ...,
**config}``) and ``meta.json`` beside them.  ``--steps_per_dispatch`` K
runs K single GAN steps between the host's log and save checks (PyTorch
has no ``lax.scan``).

On several cards, one process per card under torchrun::

    torchrun --nproc_per_node N \\
        -m smart_nar_fast_tts_tpu_torch.cli.train_vocoder --wav_dir W ...

trains on a data mesh of ``gcd(batch_size // nodes, N)`` ranks per node, as
the JAX CLI meshes over ``gcd(batch // hosts, local devices)``; the port
raises where that leaves ranks idle.  Every rank draws the global batch
from ``default_rng(seed + node index)`` and computes its rows; the first
rank prints and writes the checkpoints.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import time

import numpy as np
import torch

from ..parallel import init_distributed, make_mesh, replicated
from ..parallel.mesh import node_layout, world

# the --debug_tiny generator configs of each family (the JAX CLI's)
TINY_GENERATORS = {
    "hifigan": dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
                    upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                    resblock_dilation_sizes=((1, 2),), n_mels=8),
    "vocos": dict(n_mels=8, dim=16, intermediate=32, n_layers=2, n_fft=32,
                  hop=8, win_length=32),
    "melgan": dict(n_mels=8, ngf=8, n_residual_layers=1, ratios=(4, 2))}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--wav_dir", type=str, required=True)
    parser.add_argument("--steps", type=int, default=10000)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--segment_size", type=int, default=8192)
    parser.add_argument("--learning_rate", type=float, default=2e-4)
    parser.add_argument("--steps_per_dispatch", type=int, default=1,
                        help="GAN steps between the host's log and save "
                             "checks")
    parser.add_argument("--generator",
                        choices=("hifigan", "vocos", "melgan"),
                        default="hifigan", help="generator family")
    parser.add_argument("--restore_generator", type=str, default=None,
                        help="checkpoint of the same family to warm-start "
                             "the generator: the port's .pth.tar or a flax "
                             ".msgpack")
    parser.add_argument("--out_dir", type=str, default="./output/vocoder")
    parser.add_argument("--save_every", type=int, default=1000)
    parser.add_argument("--log_every", type=int, default=100)
    parser.add_argument("--sampling_rate", type=int, default=22050)
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--debug_tiny", action="store_true",
                        help="tiny model/mel configs (CI smoke tests)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default cuda; 'cpu' runs the "
                             "kernels' plain versions on the CPU)")
    args = parser.parse_args(argv)
    init_distributed(args.device)
    rank = world()[0]
    node, nodes, n_local = node_layout()
    data_size = math.gcd(args.batch_size // nodes, n_local)
    if data_size < n_local:
        raise ValueError(
            f"--batch_size {args.batch_size} over {nodes} node(s) shards "
            f"over {data_size} of the {n_local} ranks per node: JAX would "
            "leave the others idle, a torchrun job cannot; launch "
            f"{data_size} ranks per node or make the batch per node a "
            f"multiple of {n_local}")

    from ..audio.stft import MelSpectrogramConfig
    from ..data.wavio import load_wav
    from ..training.vocoder import (VocoderOptimizer, create_vocoder_state,
                                    make_vocoder_train_step,
                                    sample_segments)
    from ..vocoder import HiFiGANDiscriminator
    from ..vocoder.convert import FAMILIES, generator_state

    paths = sorted(glob.glob(os.path.join(args.wav_dir, "**", "*.wav"),
                             recursive=True))
    if not paths:
        raise SystemExit(f"no .wav files under {args.wav_dir}")
    wavs = [load_wav(p, args.sampling_rate)[0].astype(np.float32)
            for p in paths]
    audio_s = sum(len(w) for w in wavs) / args.sampling_rate
    if rank == 0:
        print(f"{len(wavs)} wavs, {audio_s:.1f}s audio")

    sr = args.sampling_rate
    cfg_cls, gen_cls = FAMILIES[args.generator]
    if args.debug_tiny:
        gen_cfg = cfg_cls(**TINY_GENERATORS[args.generator], sampling_rate=sr)
        discriminator = HiFiGANDiscriminator(
            periods=(2, 3), period_channels=(4, 8), n_scales=2,
            scale_layers=((8, 15, 1, 1), (16, 41, 4, 4), (16, 5, 1, 1)),
            seed=args.seed)
        mel_cfg = MelSpectrogramConfig(
            sampling_rate=sr, n_fft=32, hop_length=8, win_length=32,
            n_mels=8, mel_fmax=None)
    else:
        gen_cfg = cfg_cls(sampling_rate=sr)
        discriminator = HiFiGANDiscriminator(seed=args.seed)
        mel_cfg = MelSpectrogramConfig(sampling_rate=sr)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        generator = gen_cls(gen_cfg)
    if args.restore_generator:
        # the checkpoint's topology must be this run's
        generator.load_state_dict(generator_state(
            args.generator, args.restore_generator, gen_cfg))

    tx = VocoderOptimizer(learning_rate=args.learning_rate)
    state = create_vocoder_state(generator, discriminator, tx, tx,
                                 device=args.device)
    mesh = make_mesh((-1, 1))
    replicated(mesh, state.generator, state.discriminator)
    step_fn = make_vocoder_train_step(mel_cfg, mesh=mesh)
    device_name = (torch.cuda.get_device_name(state.device)
                   if state.device.type == "cuda" else state.device.type)

    os.makedirs(args.out_dir, exist_ok=True)
    k = max(1, args.steps_per_dispatch)
    rng = np.random.default_rng(args.seed + node)
    t0 = time.perf_counter()
    step, last_log, saved = 0, 0, []
    while step < args.steps:
        for _ in range(k):
            batch = sample_segments(wavs, args.batch_size,
                                    args.segment_size, rng)
            metrics = step_fn(state, torch.from_numpy(batch))
        step += k
        if step - last_log >= args.log_every or step >= args.steps:
            disc, gen_total, mel = (float(metrics.disc),
                                    float(metrics.gen_total),
                                    float(metrics.mel))
            dt = time.perf_counter() - t0
            if rank == 0:
                print(f"step {step}: disc={disc:.4f} gen={gen_total:.4f} "
                      f"mel={mel:.4f} ({(step - last_log) / dt:.2f} "
                      "steps/s)", flush=True)
            if not np.isfinite(gen_total):
                raise FloatingPointError(f"non-finite loss at step {step}")
            last_log, t0 = step, time.perf_counter()
        if rank == 0 and (step % args.save_every < k
                          or step >= args.steps):
            path = os.path.join(args.out_dir, f"generator_{step}.pth.tar")
            torch.save({"generator": {
                n: v.detach().cpu()
                for n, v in state.generator.state_dict().items()}}, path)
            # the config beside the checkpoint rebuilds the topology in
            # load_vocoder (and synthesize --vocoder_ckpt); always rewritten
            with open(os.path.join(args.out_dir, "config.json"), "w") as f:
                json.dump({"family": args.generator, **gen_cfg.to_dict()},
                          f, indent=1)
            with open(os.path.join(args.out_dir, "meta.json"), "w") as f:
                json.dump({
                    "family": args.generator,
                    "steps_completed": step,
                    "steps_planned": args.steps,
                    "batch_size": args.batch_size,
                    "segment_size": args.segment_size,
                    "learning_rate": args.learning_rate,
                    "corpus": f"{args.wav_dir}: {len(wavs)} wavs, "
                              f"{audio_s:.1f}s",
                    "device": device_name,
                    "final_losses": {
                        "disc": round(float(metrics.disc), 4),
                        "gen_total": round(float(metrics.gen_total), 4),
                        "mel": round(float(metrics.mel), 4)},
                    "trainer": "smart_nar_fast_tts_tpu_torch.cli."
                               "train_vocoder (MPD+MSD, fused log-mel "
                               "kernel for the mel loss)",
                }, f, indent=1)
            saved.append(path)
            print(f"saved {path}", flush=True)
    return {"state": state, "saved": saved}


if __name__ == "__main__":
    main()
