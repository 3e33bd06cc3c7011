"""Validation CLI of the port (the reference's missing ``evaluate.py`` as a
tool, ``python -m smart_nar_fast_tts_tpu.cli.evaluate``'s flags plus
``--device``): run the val split against a checkpoint and print the
element-weighted average losses::

    python -m smart_nar_fast_tts_tpu_torch.cli.evaluate \\
        -p preprocess.yaml -m model.yaml -t train.yaml \\
        [--restore_step N] [--device cpu]

It reads the port's checkpoints (``training/checkpoint.py``), the latest
when ``--restore_step`` is not given, and runs on CUDA unless ``--device
cpu`` is given.  Returns the averaged ``LossBreakdown`` (Python floats;
None for an empty split).  Under torchrun (``--nproc_per_node N``) every
rank evaluates its rows of each batch on the Trainer's mesh, and the first
prints the global losses.
"""

from __future__ import annotations

import argparse

from ..parallel import init_distributed
from ..parallel.mesh import world
from ..training.checkpoint import CheckpointManager
from ..training.evaluate import validation_message, weighted_average
from ..training.trainer import Trainer
from ._args import add_config_args, load_config


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_config_args(parser)
    parser.add_argument("--restore_step", type=int, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default cuda; 'cpu' runs the "
                             "kernels' plain versions on the CPU)")
    args = parser.parse_args(argv)
    init_distributed(args.device)

    cfg = load_config(args)
    trainer = Trainer(cfg, device=args.device)
    state, _ = CheckpointManager(cfg.train.ckpt_path).restore(
        trainer.init_state(), step=args.restore_step)
    batcher = trainer.make_batcher("val.txt", pad_short="mask")
    losses = weighted_average(trainer.eval_step, state, batcher.batches(0))
    if world()[0] == 0:
        print(validation_message(state.step, cfg.train.step.total_step,
                                 losses))
    return losses


if __name__ == "__main__":
    main()
