"""Training CLI of the port (reference ``train.py:170-196``), with the flags
of ``python -m smart_nar_fast_tts_tpu.cli.train`` plus ``--device``::

    python -m smart_nar_fast_tts_tpu_torch.cli.train \\
        -p preprocess.yaml -m model.yaml -t train.yaml \\
        [--restore_step N] [--total_step N] [--device cpu]

It trains from the latest checkpoint under ``train.path.ckpt_path`` (the
port's own, ``training/checkpoint.py``), or from a fresh model when there
is none, on CUDA unless ``--device cpu`` is given, and fails without a card
otherwise.  ``--restore_step`` restores that step instead, as the JAX CLI's
help says (its trainer restores the latest step whatever the flag).

On several cards, one process per card under torchrun::

    torchrun --nproc_per_node N -m smart_nar_fast_tts_tpu_torch.cli.train \
        --distributed -p preprocess.yaml -m model.yaml -t train.yaml

joins the process group (NCCL; gloo with ``--device cpu``) and trains on
the mesh of ``train.yaml`` (``training/trainer.py``).  ``--distributed``
without torchrun's environment raises; under torchrun with more than one
rank the group is joined with or without it.
"""

from __future__ import annotations

import argparse

from ..parallel import init_distributed
from ..training.trainer import Trainer
from ._args import add_config_args, load_config


def main(argv=None) -> Trainer:
    parser = argparse.ArgumentParser(description=__doc__)
    add_config_args(parser)
    parser.add_argument("--restore_step", type=int, default=None,
                        help="checkpoint step to restore "
                             "(default: latest if any)")
    parser.add_argument("--total_step", type=int, default=None,
                        help="override train.yaml total_step")
    parser.add_argument("--distributed", action="store_true",
                        help="join the process group of a torchrun "
                             "launch (required to be one)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default cuda; 'cpu' runs the "
                             "kernels' plain versions on the CPU)")
    args = parser.parse_args(argv)
    init_distributed(args.device, require=args.distributed)

    cfg = load_config(args)
    trainer = Trainer(cfg, device=args.device)
    trainer.fit(total_steps=args.total_step, restore=True,
                restore_step=args.restore_step)
    return trainer


if __name__ == "__main__":
    main()
