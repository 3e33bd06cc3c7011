#!/usr/bin/env python3
"""The port's G2P trainer (``cli.train_g2p``) at its full default run on
one NVIDIA card.

Run from the repository root, on a machine with a CUDA card:

    python3 profile_g2p.py [--epochs 120] [--out PATH]

(``--out`` defaults to ``build/g2p_profile/g2p_weights.npz``; the port's
default output path is left alone.)  It trains on the committed seed
lexicon with the CLI's defaults (augmentation, batch 64, Adam at 2e-3,
seed 0), TF32 off, and prints one JSON object: the wall seconds of the
call, the first epoch's seconds (setup and warm-up included), the steady
seconds per epoch (between the trainer's first and last epoch lines), the
printed losses, the report (held-out PER with and without stress) and the
card's name and power limit.  Without a card it exits non-zero.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_g2p: no CUDA card", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--epochs", type=int, default=120)
    parser.add_argument("--out", default=os.path.join(
        REPO, "build", "g2p_profile", "g2p_weights.npz"))
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    from chip_smoke import epoch_lines, nvidia_smi, run_train_g2p

    report, lines, wall = run_train_g2p(["--epochs", str(args.epochs),
                                         "--out", args.out])
    epochs = epoch_lines(lines)
    first, last = min(epochs), max(epochs)
    print(json.dumps({
        "epochs": args.epochs, "wall_seconds": wall,
        "first_epoch_seconds": epochs[first][0],
        "seconds_per_epoch": (epochs[last][0] - epochs[first][0])
        / (last - first),
        "losses": {e: loss for e, (_, loss) in sorted(epochs.items())},
        "report": report, "device": torch.cuda.get_device_name(0),
        "nvidia_smi": nvidia_smi()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
