"""Shared CLI plumbing: config resolution + logging setup."""

from __future__ import annotations

import argparse
import dataclasses
import logging

from imm_tpu_torch.configs import get_preset
from imm_tpu_torch.utils.config import ExperimentConfig, apply_overrides, load_config


def add_config_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--preset", default=None, help="named preset (see imm_tpu_torch.configs)")
    parser.add_argument("--config", default=None, help="YAML config path")
    parser.add_argument("--workdir", default=None, help="checkpoint/log directory")
    parser.add_argument(
        "--device",
        default="cuda",
        choices=["cuda", "cpu"],
        help="where to run (default cuda; without a GPU this raises unless "
        "--device cpu is given)",
    )
    parser.add_argument(
        "overrides",
        nargs="*",
        help="dotted overrides, e.g. model.n_landmarks=30 train.batch_size=128",
    )


def resolve_config(args: argparse.Namespace) -> ExperimentConfig:
    if args.config:
        config = load_config(args.config)
    elif args.preset:
        config = get_preset(args.preset)
    else:
        raise SystemExit("provide --preset or --config")
    if args.overrides:
        config = apply_overrides(config, args.overrides)
    if args.workdir:
        config = dataclasses.replace(config, workdir=args.workdir)
    return config


def setup_logging() -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(message)s",
        datefmt="%H:%M:%S",
    )
