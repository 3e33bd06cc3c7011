"""Export CLI of the port: a checkpoint → serving artifacts for one device.

The flags of ``python -m smart_nar_fast_tts_tpu.cli.export``, with
``--device`` in place of ``--platforms``::

    python -m smart_nar_fast_tts_tpu_torch.cli.export \\
        -p preprocess.yaml -m model.yaml -t train.yaml \\
        --restore_step N --out_dir artifacts/ \\
        [--vocoder_ckpt generator.pth.tar] [--batch_size 1] \\
        [--stream_chunk 64] [--device cpu]

Writes ``torch.export`` programs for every text bucket and frame capacity,
the vocoder buckets and the streaming window, the weights once in
``params.npz``, and ``manifest.json`` (``serving.export_serving_artifacts``).
Serve them with ``smart_nar_fast_tts_tpu_torch.serving.ExportedTTS`` on the
same device.  The checkpoint is the port's own (``cli.synthesize`` reads it
the same way); the vocoder a HiFi-GAN torch file (upstream's layout) or
flax ``.msgpack`` (``vocoder.load_hifigan``), as the JAX CLI.  It runs
on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

from ..device import resolve_device
from ._args import add_config_args, load_config


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    add_config_args(parser)
    parser.add_argument("--out_dir", type=str, required=True)
    parser.add_argument("--restore_step", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--vocoder_ckpt", type=str, default=None,
                        help="HiFi-GAN generator checkpoint (upstream torch "
                             "layout or flax .msgpack); acoustic-only "
                             "artifact if omitted")
    parser.add_argument("--stream_chunk", type=int, default=64)
    parser.add_argument("--device", type=str, default=None,
                        help="the device the programs are exported for "
                             "(default cuda)")
    parser.add_argument("--pitch_control", type=float, default=1.0)
    parser.add_argument("--energy_control", type=float, default=1.0)
    parser.add_argument("--duration_control", type=float, default=1.0)
    args = parser.parse_args(argv)

    from ..serving import export_serving_artifacts
    from .synthesize import load_model

    cfg = load_config(args)
    device = resolve_device(args.device)
    model, restored = load_model(cfg, args.restore_step, device)
    if restored == 0:
        print("WARNING: no checkpoint found; exporting random init")
    generator = None
    if args.vocoder_ckpt:
        from ..vocoder import load_hifigan
        generator = load_hifigan(args.vocoder_ckpt)
    # long-form serving: the acoustic grid over every serving frame
    # capacity, and vocoder buckets that also hold each capacity
    mel_caps = sorted(set(cfg.train.serving_mel_caps)
                      | {cfg.model.max_seq_len})
    voc_buckets = sorted(set(cfg.train.mel_buckets) | set(mel_caps))
    manifest = export_serving_artifacts(
        args.out_dir, model,
        text_buckets=cfg.train.text_buckets, mel_buckets=voc_buckets,
        batch_size=args.batch_size, max_mel_len=cfg.model.max_seq_len,
        mel_caps=mel_caps, generator=generator,
        stream_chunk=args.stream_chunk, p_control=args.pitch_control,
        e_control=args.energy_control, d_control=args.duration_control,
        device=device,
        provenance={"ckpt_path": cfg.train.ckpt_path,
                    "ckpt_step": restored,
                    "vocoder_ckpt": args.vocoder_ckpt or ""})
    n = (len(manifest["probe"]) + len(manifest["acoustic"])
         + len(manifest["vocoder"]) + ("streaming" in manifest))
    print(f"exported {n} programs to {args.out_dir} (ckpt step {restored}, "
          f"device {manifest['device']})")
    return manifest


if __name__ == "__main__":
    main()
