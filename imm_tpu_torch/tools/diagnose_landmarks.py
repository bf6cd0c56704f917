"""Error decomposition of a trained landmark model (an offline diagnostic).
Mirrors ``scripts/diagnose_landmarks.py``.

Restores a sweep checkpoint by registry variant name (the workdir and config
of ``tools.sweep_tps``) and decomposes the landmark-regression eval error
into what the next accuracy lever should target:

* per-GT-landmark test error: which eval targets carry the residual;
* heatmap concentration: the std (in px) of each landmark's marginal softmax
  distributions (diffuse or multimodal heatmaps read out imprecisely);
* landmark usage: each landmark's positional std across the eval set (a
  landmark that never moves carries no pose information) and the smallest
  distance between two landmarks' mean positions (collapse);
* readout conditioning: the singular values of the centred coordinate
  features (how many effective degrees of freedom the ridge readout gets).

Usage:
    python -m imm_tpu_torch.tools.diagnose_landmarks --variant NAME
        [--steps N] [--seed S] [--workdir DIR]
        [--device cpu] [--out docs/artifacts/torch/diagnose_<variant>.md]

Runs on the GPU unless ``--device cpu`` is given; a checkpoint written on the
GPU restores on the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from imm_tpu_torch.eval.regression import fit_landmark_regressor, predict_landmarks, sweep_coords
from imm_tpu_torch.experiment import build_experiment, synthetic_eval_splits
from imm_tpu_torch.ops.coords import marginal_distributions
from imm_tpu_torch.tools.sweep_tps import DEFAULT_STEPS, registry, variant_config, variant_workdir
from imm_tpu_torch.train.steps import make_eval_coords_fn

HEAT_IMAGES = 256  # test images whose heatmaps give the concentration statistics


def landmark_statistics(pred_lm: np.ndarray, gt: np.ndarray, heat: np.ndarray,
                        pred_test: np.ndarray, image_size: int) -> dict[str, np.ndarray | float]:
    """The decomposition, on host arrays.

    ``pred_lm`` (N, L, 2) regressed and ``gt`` (N, L, 2) annotated test
    points; ``heat`` (B, h, w, K) raw heatmaps of test images; ``pred_test``
    (N, K, 2) the model's test coordinates in [-1, 1]. Returns ``per_gt``
    (L,) %IOD, ``heat_std`` and ``pos_std`` (K,) in image pixels,
    ``min_pair_px`` and ``sv_norm`` (2K,), the singular values over the
    largest."""
    iod = np.linalg.norm(gt[:, 0] - gt[:, 1], axis=-1)
    per_gt = (np.linalg.norm(pred_lm - gt, axis=-1) / iod[:, None]).mean(axis=0) * 100.0
    py, px = (p.numpy() for p in marginal_distributions(torch.as_tensor(heat)))

    def marg_std_px(p, size):  # std of a marginal, in image pixels
        ruler = np.linspace(-1.0, 1.0, size)[None, :, None]
        mean = (p * ruler).sum(1, keepdims=True)
        var = (p * (ruler - mean) ** 2).sum(1)
        return np.sqrt(var).mean(0) * image_size / 2.0

    heat_std = (marg_std_px(py, heat.shape[1]) + marg_std_px(px, heat.shape[2])) / 2.0
    pos_std = pred_test.std(axis=0).mean(axis=-1) * image_size / 2.0
    means = pred_test.mean(axis=0)
    d = np.linalg.norm(means[:, None] - means[None, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    feats = pred_test.reshape(pred_test.shape[0], -1)
    sv = np.linalg.svd(feats - feats.mean(0), compute_uv=False)
    return {"per_gt": per_gt, "heat_std": heat_std, "pos_std": pos_std,
            "min_pair_px": float(d.min() * image_size / 2.0), "sv_norm": sv / sv[0]}


def render_report(variant: str, step: int, n: int, image_size: int, stats: dict) -> str:
    """The markdown of ``docs/artifacts/diagnose_*.md``."""
    per_gt, heat_std, pos_std, sv_norm = (stats[k] for k in ("per_gt", "heat_std", "pos_std",
                                                              "sv_norm"))
    lines = [
        f"# Landmark-error decomposition: {variant} @ step {step}",
        "",
        f"Eval split: synthetic keys 91/92, n={n}. Image {image_size}px, "
        f"K={len(heat_std)} unsupervised landmarks, {len(per_gt)} GT targets.",
        "",
        "## Per-GT-target test error (%IOD)",
        "",
        "| target | err %IOD |",
        "|---|---|",
    ]
    lines += [f"| {i} | {e:.2f} |" for i, e in enumerate(per_gt)]
    lines += [
        "",
        f"Overall test: **{per_gt.mean():.2f} %IOD** (mean of per-target rows).",
        "",
        "## Unsupervised landmark stats",
        "",
        "| k | heatmap marginal std (px) | positional std (px) |",
        "|---|---|---|",
    ]
    lines += [f"| {k} | {heat_std[k]:.1f} | {pos_std[k]:.1f} |" for k in range(len(heat_std))]
    lines += [
        "",
        f"Min pairwise distance between landmark means: **{stats['min_pair_px']:.1f} px** "
        "(collapse if ~0).",
        "",
        "## Readout conditioning",
        "",
        "Normalized singular values of the centered (N, 2K) coord features: "
        + ", ".join(f"{v:.3f}" for v in sv_norm),
        "",
        f"Effective rank (sv > 0.01·sv0): {int((sv_norm > 0.01).sum())} / {len(sv_norm)}",
    ]
    return "\n".join(lines) + "\n"


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--variant", required=True)
    parser.add_argument("--out", default=None)
    parser.add_argument("--workdir", default=None, help="override the derived sweep workdir")
    parser.add_argument("--steps", type=int, default=None,
                        help="budget the sweep ran this variant at, when it was neither baked "
                        f"nor the runner's default ({DEFAULT_STEPS}): part of the workdir key")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed the run trained under (part of the workdir key)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where to run (default cuda; without a GPU this raises)")
    args = parser.parse_args(argv)

    variant = registry()[args.variant]
    steps = args.steps or (variant.steps if variant.steps is not None else DEFAULT_STEPS)
    workdir = args.workdir or variant_workdir(args.variant, variant, steps, seed=args.seed)
    if not os.path.isdir(os.path.join(workdir, "checkpoints")):
        raise SystemExit(f"no checkpoints under {workdir}")
    # the workdir and config come from the sweep's own helpers, so this
    # restores under exactly the config the checkpoint was trained with
    config = variant_config(args.variant, variant, steps, workdir=workdir, seed=args.seed)
    exp = build_experiment(config, device=args.device, restore=True)
    state = exp.trainer.restore_or_init()
    print(f"[diagnose] restored {args.variant} at step {state.host_step}")

    dev, model = exp.device, exp.model
    n = config.eval_samples
    train_split, test_split = synthetic_eval_splits(config.model.image_size, n, dev)
    coords_fn = make_eval_coords_fn(model)
    pred_train = sweep_coords(coords_fn, train_split["image"], device=dev)
    pred_test = sweep_coords(coords_fn, test_split["image"], device=dev)
    w = fit_landmark_regressor(torch.as_tensor(pred_train), torch.as_tensor(train_split["landmarks"]))
    pred_lm = predict_landmarks(w, torch.as_tensor(pred_test)).numpy()
    model.eval()
    with torch.inference_mode():
        _, heat = model.encode_pose(torch.as_tensor(test_split["image"][:HEAT_IMAGES], device=dev))
    stats = landmark_statistics(pred_lm, test_split["landmarks"], heat.cpu().numpy(), pred_test,
                                config.model.image_size)
    report = render_report(args.variant, state.host_step, n, config.model.image_size, stats)
    out = args.out or os.path.join("docs", "artifacts", "torch", f"diagnose_{args.variant}.md")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        f.write(report)
    print(report, end="")
    print(f"[diagnose] wrote {out}")
    return stats


if __name__ == "__main__":
    main()
