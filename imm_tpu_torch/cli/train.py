"""Train an IMM model.

``python -m imm_tpu_torch.cli.train --preset synthetic_best [--steps N]
[--device cpu] [key=value ...]``

Runs on the GPU unless ``--device cpu`` is given; without a GPU it raises.
``--steps`` overrides the total number of optimizer steps (rounded up to
whole calls of ``train.steps_per_call`` steps). Checkpoints (``--workdir``)
and ``--supervise`` are not ported yet.
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
    parser.add_argument("--steps", type=int, default=None, help="override total steps")
    args = parser.parse_args(argv)
    setup_logging()
    config = resolve_config(args)
    exp = build_experiment(config, device=args.device, total_steps=args.steps)
    log.info(
        "experiment %s: %d steps, batch %d x %d/call, device %s",
        config.name, exp.trainer.total_steps, config.train.batch_size,
        config.train.steps_per_call, exp.device,
    )
    state = exp.run()
    log.info("finished at step %d", state.host_step)
    for k, v in exp.eval_fn(state).items():
        log.info("final %s = %.4f", k, v)
    return state


if __name__ == "__main__":
    main()
