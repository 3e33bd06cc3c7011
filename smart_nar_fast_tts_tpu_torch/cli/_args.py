"""Shared argument plumbing for the reference-compatible CLI triplet
(``smart_nar_fast_tts_tpu/cli/_args.py``)."""

from __future__ import annotations

import argparse
import dataclasses
import os

from ..config import Config, FeatureStats


def add_config_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("-p", "--preprocess_config", type=str,
                        required=True, help="path to preprocess.yaml")
    parser.add_argument("-m", "--model_config", type=str, required=True,
                        help="path to model.yaml")
    parser.add_argument("-t", "--train_config", type=str, required=True,
                        help="path to train.yaml")


def load_config(args: argparse.Namespace, need_stats: bool = True) -> Config:
    """The YAML triplet, with ``<preprocessed_path>/stats.json`` as the
    feature stats when the preprocess config carries none."""
    cfg = Config.from_yaml_triplet(
        args.preprocess_config, args.model_config, args.train_config)
    if need_stats and cfg.preprocess.stats is None:
        stats_path = os.path.join(cfg.preprocess.preprocessed_path,
                                  "stats.json")
        if os.path.exists(stats_path):
            cfg = dataclasses.replace(
                cfg, preprocess=dataclasses.replace(
                    cfg.preprocess,
                    stats=FeatureStats.from_stats_json(stats_path)))
    return cfg
