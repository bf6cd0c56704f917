"""Pose-swap generation: the appearance of A in the pose of B.

``python -m imm_tpu_torch.cli.generate --preset swap --out swaps.npy
[--weights vars.npz] [--seed 0] [--n 8] [--device cpu]``

Draws ``--n`` appearance and ``--n`` pose faces from the synthetic blob-face
generator on the device and writes the (n, S, S, 3) swaps, clipped to [0, 1],
as ``.npy``. ``--weights`` loads flax variables flattened to an ``.npz``
(``imm_tpu_torch.models.convert``); without it the model is initialised from
``--seed``. Restoring a training checkpoint (``--workdir``) and reading
input images from files come with later slices.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from imm_tpu_torch.cli._common import add_config_args, resolve_config, setup_logging
from imm_tpu_torch.data.synthetic import SyntheticBlobFaces
from imm_tpu_torch.eval.swap import pose_swap
from imm_tpu_torch.models.convert import load_flax_weights
from imm_tpu_torch.models.imm import init_model
from imm_tpu_torch.utils.device import get_device

log = logging.getLogger("imm_tpu_torch")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_config_args(parser)
    parser.add_argument("--n", type=int, default=8, help="number of swaps")
    parser.add_argument("--out", default="swaps.npy", help="output .npy path")
    parser.add_argument("--weights", default=None, help="flax variables as .npz")
    parser.add_argument("--seed", type=int, default=None,
                        help="init seed without --weights (default: train.seed)")
    args = parser.parse_args(argv)
    setup_logging()
    config = resolve_config(args)
    device = get_device(args.device)
    if config.workdir:
        raise SystemExit(
            "--workdir: checkpoint restore is not ported yet (ROADMAP.md, "
            "Queue 1 item 8); pass --weights vars.npz"
        )
    if not args.out.endswith(".npy"):
        raise SystemExit("--out: only .npy output is supported")

    seed = config.train.seed if args.seed is None else args.seed
    model = init_model(config.model, seed=seed, device=device)
    if args.weights:
        load_flax_weights(model, args.weights)

    faces = SyntheticBlobFaces(image_size=config.model.image_size)
    app = faces.sample(torch.Generator(device).manual_seed(1), args.n)["image"]
    pose = faces.sample(torch.Generator(device).manual_seed(2), args.n)["image"]
    out = pose_swap(model, app, pose).clamp(0.0, 1.0).cpu().numpy()
    np.save(args.out, out)
    log.info("wrote %s (%s)", args.out, out.shape)
    return out


if __name__ == "__main__":
    main()
