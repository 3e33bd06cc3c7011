"""Offline preprocessing CLI of the port (reference ``preprocess.py:7-14``),
with the flags of ``python -m smart_nar_fast_tts_tpu.cli.preprocess`` plus
``--device``::

    python -m smart_nar_fast_tts_tpu_torch.cli.preprocess preprocess.yaml \\
        [--prepare_align CORPUS_DIR] [--workers N] [--device cpu]

It writes the feature store under ``path.preprocessed_path`` from the wavs
and ``.lab`` files under ``path.data_path`` and the TextGrids under
``<preprocessed_path>/TextGrid/``.  ``--prepare_align`` first runs the
LJSpeech ``metadata.csv`` → ``.lab``/``.wav`` step the reference ships but
never invokes (``preprocessor/ljspeech.py:11-40``).  The mel features are
computed on CUDA unless ``--device cpu`` is given, and the run fails without
a card otherwise; ``--workers N`` > 1 fans the utterances out over N CPU
processes.  F0 runs on the host (``data/native_f0.py``).
"""

from __future__ import annotations

import argparse

from .. import yaml_subset
from ..config import Config
from ..data.preprocessor import Preprocessor


def main(argv=None) -> list[str]:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("config", type=str, help="path to preprocess.yaml")
    parser.add_argument("--prepare_align", type=str, default=None,
                        metavar="CORPUS_DIR",
                        help="run metadata.csv → .lab/.wav corpus prep "
                             "first (LJSpeech layout)")
    parser.add_argument("--workers", type=int, default=1,
                        help="parallel utterance workers (process pool)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device of the mel features (default "
                             "cuda)")
    args = parser.parse_args(argv)

    cfg = Config.from_dicts(yaml_subset.load(args.config) or {}, {}, {})
    pre = Preprocessor(cfg.preprocess, device=args.device)
    if args.prepare_align:
        from ..data.ljspeech import prepare_align
        prepare_align(args.prepare_align, cfg.preprocess)
    out = pre.build_from_path(num_workers=args.workers)
    print(f"preprocessed {len(out)} utterances "
          f"→ {cfg.preprocess.preprocessed_path}")
    return out


if __name__ == "__main__":
    main()
