"""Import a reference (PyTorch) checkpoint into the port's checkpoint store
(the flags of ``python -m smart_nar_fast_tts_tpu.cli.import_checkpoint``
plus ``--device``)::

    python -m smart_nar_fast_tts_tpu_torch.cli.import_checkpoint \\
        --torch_ckpt 160000.pth.tar -p P.yaml -m M.yaml -t T.yaml \\
        [--step 160000] [--device cpu]

The migration path for users of the reference repo: their
``output/ckpt/LJSpeech/<step>.pth.tar`` (``{"model": state_dict,
"optimizer": ...}``, or the state dict itself) becomes step ``<step>`` of
the port's ``CheckpointManager`` under ``train.path.ckpt_path``, which
``cli.synthesize``, ``cli.evaluate`` and ``cli.train --restore_step`` read.
The step is the file name's first number unless ``--step`` is given.  The
converted keys must be the model's keys and every shape the model's shape;
otherwise the CLI exits with the keys missing and extra (or the shapes that
differ) and writes nothing.  The optimizer starts afresh, as the JAX CLI
re-initialises optax's: the Noam schedule resumes at step + 1.  The model
is placed on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import re

from ._args import add_config_args, load_config


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--torch_ckpt", type=str, required=True)
    parser.add_argument("--step", type=int, default=None,
                        help="step to record (default: parsed from the "
                             "checkpoint filename)")
    add_config_args(parser)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default cuda)")
    args = parser.parse_args(argv)

    step = args.step
    if step is None:
        m = re.search(r"(\d+)", args.torch_ckpt.rsplit("/", 1)[-1])
        step = int(m.group(1)) if m else 0

    cfg = load_config(args)

    import torch

    from ..config import check_ported
    from ..models import FastSpeech2Align
    from ..models.convert import reference_state_dict_to_port
    from ..training.checkpoint import CheckpointManager
    from ..training.state import create_train_state

    check_ported(cfg.model)
    raw = torch.load(args.torch_ckpt, map_location="cpu", weights_only=True)
    sd = raw.get("model", raw) if isinstance(raw, dict) else raw
    converted = reference_state_dict_to_port(sd, cfg.model)

    model = FastSpeech2Align(cfg.model, cfg.preprocess)
    want = model.state_dict()
    a, b = set(want), set(converted)
    if a != b:
        missing, extra = sorted(a - b)[:5], sorted(b - a)[:5]
        raise SystemExit(f"param tree mismatch: missing={missing} "
                         f"extra={extra}")
    shapes = [(k, tuple(converted[k].shape), tuple(want[k].shape))
              for k in want if converted[k].shape != want[k].shape]
    if shapes:
        raise SystemExit(f"param shape mismatch (key, file, model): "
                         f"{shapes[:5]}")
    model.load_state_dict(converted)

    state = create_train_state(model, cfg.train.optimizer, args.device)
    state.step = step
    CheckpointManager(cfg.train.ckpt_path).save(
        state, {"epoch": 0, "in_epoch": 0, "imported": True}, force=True)
    print(f"imported step {step} -> {cfg.train.ckpt_path}")
    return step


if __name__ == "__main__":
    main()
