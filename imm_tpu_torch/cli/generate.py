"""Pose-swap generation: the appearance of A in the pose of B.

``python -m imm_tpu_torch.cli.generate --preset swap --out swaps.npy
[--appearance a.jpg --pose b.jpg | --n 8] [--workdir W [--ema] |
--weights vars.npz | --seed 0] [--device cpu]``

With ``--appearance`` and ``--pose``, swaps the two image files (PNG or
JPEG, decoded on the run's device, centre square, resized to the model's
size: ``data.decode.load_image_with_hw``). Without them, draws ``--n``
appearance and ``--n`` pose faces from the synthetic blob-face generator on
the device. Writes the (n, S, S, 3) swaps, clipped to [0, 1], as ``.npy``,
or as a ``.png`` of three rows (appearance, pose, swap) of n images each. The model comes from the latest checkpoint in ``--workdir``
(``--ema``: its Polyak-averaged parameters), else from flax variables
flattened to an ``.npz`` (``--weights``, ``imm_tpu_torch.models.convert``),
else it is initialised from ``--seed``.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from imm_tpu_torch.cli._common import add_config_args, resolve_config, setup_logging
from imm_tpu_torch.data.decode import load_image_with_hw
from imm_tpu_torch.data.synthetic import SyntheticBlobFaces
from imm_tpu_torch.eval.swap import swap_fn
from imm_tpu_torch.experiment import build_experiment
from imm_tpu_torch.models.convert import load_flax_weights
from imm_tpu_torch.models.imm import init_model
from imm_tpu_torch.utils.device import get_device
from imm_tpu_torch.utils.viz import to_uint8, write_png

log = logging.getLogger("imm_tpu_torch")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_config_args(parser)
    parser.add_argument("--appearance", default=None, help="appearance image path")
    parser.add_argument("--pose", default=None, help="pose image path")
    parser.add_argument("--n", type=int, default=8, help="number of swaps")
    parser.add_argument("--out", default="swaps.npy", help="output .npy or .png path")
    parser.add_argument("--weights", default=None, help="flax variables as .npz")
    parser.add_argument("--seed", type=int, default=None,
                        help="init seed without --workdir or --weights (default: train.seed)")
    parser.add_argument(
        "--ema", action="store_true",
        help="generate with the Polyak-averaged params (requires a checkpoint "
        "trained with train.param_ema_decay > 0)",
    )
    args = parser.parse_args(argv)
    setup_logging()
    config = resolve_config(args)
    device = get_device(args.device)
    if bool(args.appearance) != bool(args.pose):
        raise SystemExit("--appearance and --pose go together: give both image paths")
    for path in (args.appearance, args.pose):
        if path and not os.path.isfile(path):
            raise SystemExit(f"no image file at {path}")
    if not args.out.endswith((".npy", ".png")):
        raise SystemExit("--out: write .npy or .png")
    if config.workdir and args.weights:
        raise SystemExit("--workdir and --weights both name the weights: give one")
    if args.ema and not config.workdir:
        raise SystemExit("--ema: the EMA params come from a checkpoint; give --workdir")

    if config.workdir:
        exp = build_experiment(config, device=device, total_steps=0, inference_only=True)
        state = exp.trainer.restore_or_init()
        model = exp.model
        if args.ema:
            if state.ema_params is None:
                raise SystemExit(
                    "--ema: checkpoint has no EMA params (train with "
                    "train.param_ema_decay > 0)"
                )
            with torch.no_grad():
                for k, p in model.named_parameters():
                    p.copy_(state.ema_params[k])
    else:
        seed = config.train.seed if args.seed is None else args.seed
        model = init_model(config.model, seed=seed, device=device)
        if args.weights:
            load_flax_weights(model, args.weights)

    size = config.model.image_size
    if args.appearance:
        app = load_image_with_hw(args.appearance, size, None, device)[0][None]
        pose = load_image_with_hw(args.pose, size, None, device)[0][None]
    else:
        faces = SyntheticBlobFaces(image_size=size)
        app = faces.sample(torch.Generator(device).manual_seed(1), args.n)["image"]
        pose = faces.sample(torch.Generator(device).manual_seed(2), args.n)["image"]
    out = swap_fn(model)(app, pose).clamp(0.0, 1.0).cpu().numpy()
    if args.out.endswith(".npy"):
        np.save(args.out, out)
    else:
        rows = (app.cpu().numpy(), pose.cpu().numpy(), out)
        grid = np.concatenate([np.concatenate(list(row), axis=1) for row in rows], axis=0)
        write_png(args.out, to_uint8(grid))
    log.info("wrote %s (%s)", args.out, out.shape)
    return out


if __name__ == "__main__":
    main()
