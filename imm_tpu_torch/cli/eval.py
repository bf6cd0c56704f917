"""Evaluate a trained model: landmark regression -> %IOD / %size.

``python -m imm_tpu_torch.cli.eval --preset synthetic_best --workdir runs/x
[--device cpu] [key=value ...]``

Restores the latest checkpoint in ``--workdir`` (without one, the model
initialised from ``train.seed``), runs the experiment's eval on its fixed
splits, with the parameter EMA's metrics (suffix ``_ema``) when the
checkpoint carries EMA parameters, logs each metric and prints the dict.
"""

from __future__ import annotations

import argparse
import logging

from imm_tpu_torch.cli._common import add_config_args, resolve_config, setup_logging
from imm_tpu_torch.experiment import build_experiment

log = logging.getLogger("imm_tpu_torch")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_config_args(parser)
    args = parser.parse_args(argv)
    setup_logging()
    config = resolve_config(args)
    exp = build_experiment(config, device=args.device, total_steps=0)
    state = exp.trainer.restore_or_init()
    log.info("evaluating checkpoint at step %d", state.host_step)
    results = exp.eval_fn(state)
    for k, v in results.items():
        log.info("%s = %.4f", k, v)
    print(results)
    return results


if __name__ == "__main__":
    main()
