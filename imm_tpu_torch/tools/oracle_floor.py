"""Oracle controls for the synthetic harness's K-landmark floor. Mirrors
``scripts/oracle_floor.py``.

Two oracles bound what any unsupervised K-landmark method can score on this
harness under the standard eval protocol (the fixed eval sets of
``experiment.py``: ``SyntheticBlobFaces.sample`` from generators seeded 91
and 92, n=1024, 128 px, %IOD on eye points (0, 1)):

A. **GT-parts regression**: the generator's own part coordinates through the
   eval's ridge regression; the protocol's numeric floor.

B. **Supervised K-landmark encoder**: the unsupervised model's
   ``PoseEncoder`` and spatial-softmax coordinates, trained supervised: a
   linear head maps the K coordinates to the 5 annotated points under an L2
   loss. Scored with the standard protocol (ridge refit from its K coords),
   it bounds what the architecture and bottleneck represent at a given K.

Writes one JSON line per measurement to ``--out`` (names already recorded
are skipped) and returns the records.

Usage:
    python -m imm_tpu_torch.tools.oracle_floor [--steps 6000] [--k 5,10,30]
        [--temporal [--pose-gap G]] [--device cpu]
        [--out docs/artifacts/torch/oracle_floor.jsonl]

Runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import time

import torch
from torch import nn

from imm_tpu_torch.data.synthetic import SyntheticBlobFaces
from imm_tpu_torch.experiment import synthetic_eval_splits
from imm_tpu_torch.eval.regression import (
    evaluate_landmarks,
    fit_landmark_regressor,
    landmark_error,
    predict_landmarks,
)
from imm_tpu_torch.models.nets import ConvBlock, FlaxBatchNorm, PoseEncoder, SameConv2d, lecun_normal_
from imm_tpu_torch.ops.coords import marginal_softmax_coords
from imm_tpu_torch.train.state import make_optimizer, piecewise_constant_config
from imm_tpu_torch.utils.device import get_device

EVAL_N = 1024
IMAGE_SIZE = 128
WINDOW = 50  # steps a logged loss averages (the JAX script's scan length)
DEFAULT_OUT = os.path.join("docs", "artifacts", "torch", "oracle_floor.jsonl")


def eval_sets(device=None):
    """The fixed (train, test) eval splits as host numpy dicts, drawn on
    ``device`` (default: the GPU) as ``experiment.py`` draws them."""
    return synthetic_eval_splits(IMAGE_SIZE, EVAL_N, get_device(device))


def gt_parts_oracle(train, test) -> dict:
    """Control A: the annotated points themselves as the predicted coords."""
    lm_train = torch.as_tensor(train["landmarks"])
    lm_test = torch.as_tensor(test["landmarks"])
    w = fit_landmark_regressor(lm_train, lm_train)
    err = landmark_error(predict_landmarks(w, lm_test), lm_test, norm="iod")
    return {"name": "gt_parts", "test_pct": float(err)}


class SupervisedPose(nn.Module):
    """PoseEncoder (bf16) -> spatial-softmax coords (f32) -> linear head to
    the annotated points.

    The gradient flows through the coordinate bottleneck, so the oracle has
    the unsupervised model's constraint: all landmark information passes as
    K softmax expectations. ``forward`` takes (B, S, S, 3) images and returns
    (coords (B, K, 2), points (B, n_annotated, 2)); train or eval mode is the
    module's own. The flax module's names: ``pose_encoder``, ``readout``."""

    def __init__(self, n_landmarks: int, n_annotated: int = 5):
        super().__init__()
        self.n_annotated = n_annotated
        self.pose_encoder = PoseEncoder(n_landmarks, dtype=torch.bfloat16)
        self.readout = nn.Linear(2 * n_landmarks, 2 * n_annotated)

    def forward(self, image: torch.Tensor):
        heatmaps = self.pose_encoder(image.permute(0, 3, 1, 2))
        coords = marginal_softmax_coords(heatmaps.permute(0, 2, 3, 1).float())
        pred = self.readout(coords.reshape(coords.shape[0], -1))
        return coords, pred.reshape(-1, self.n_annotated, 2)


def init_supervised_pose(n_landmarks: int, n_annotated: int = 5, seed: int = 0) -> SupervisedPose:
    """flax's initialisers (``lecun_normal`` kernels, zero biases, unit norm
    scales) drawn from a ``torch.Generator``."""
    model = SupervisedPose(n_landmarks, n_annotated)
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (ConvBlock, SameConv2d, FlaxBatchNorm)):
            m.reset_parameters(generator=gen)
    lecun_normal_(model.readout.weight, gen)
    nn.init.zeros_(model.readout.bias)
    return model


def oracle_name(k: int, temporal: bool = False, pose_gap: float = 0.0) -> str:
    if not temporal:
        return f"supervised_k{k}"
    return f"supervised_temporal_k{k}" + (f"_gap{pose_gap:g}" if pose_gap else "")


def supervised_oracle(k: int, steps: int, batch: int, train, test, temporal: bool = False,
                      pose_gap: float = 0.0, device=None) -> dict:
    """Control B: the supervised PoseEncoder + bottleneck at K landmarks,
    trained ``steps // 50 * 50`` steps (Adam at 1e-3, x0.3 at 60%, x0.1 more
    at 85%) and scored with the eval protocol.

    ``temporal=True`` measures the ceiling of the temporal protocol: the
    batches are ``sample_pair`` frames (one identity in two poses at
    ``pose_gap``), as the temporal recipe's image stream; the trunk,
    bottleneck, eval sets and scoring are unchanged. The training faces are
    drawn at the eval splits' image size."""
    dev = get_device(device)
    n_annotated = train["landmarks"].shape[1]
    model = init_supervised_pose(k, n_annotated).to(dev)
    params = dict(model.named_parameters())
    optimizer = make_optimizer(
        piecewise_constant_config(1e-3, {int(steps * 0.6): 0.3, int(steps * 0.85): 0.1}))
    opt_state = optimizer.init(params)
    faces = SyntheticBlobFaces(image_size=train["image"].shape[1], pair_pose_gap=pose_gap)
    gen = torch.Generator(dev).manual_seed(1)

    t0 = time.time()
    n_windows = steps // WINDOW
    model.train()
    for i in range(n_windows):
        window = torch.zeros((), device=dev)
        for _ in range(WINDOW):
            with torch.no_grad():
                if temporal:
                    d2 = faces.sample_pair(gen, batch // 2)
                    images = torch.cat([d2["image_a"], d2["image_b"]])
                    targets = torch.cat([d2["landmarks_a"], d2["landmarks_b"]])
                else:
                    d = faces.sample(gen, batch)
                    images, targets = d["image"], d["landmarks"]
            _, pred = model(images)
            loss = torch.mean(torch.square(pred - targets))
            grads = torch.autograd.grad(loss, list(params.values()))
            updates, opt_state = optimizer.update(dict(zip(params, grads)), opt_state, params)
            with torch.no_grad():
                for name, p in params.items():
                    p.add_(updates[name])
            window += loss.detach()
        if i % max(1, n_windows // 10) == 0 or i == n_windows - 1:
            print(f"  [k={k}] step {(i + 1) * WINDOW}/{steps} "
                  f"loss={float(window) / WINDOW:.5f} ({time.time() - t0:.0f}s)", flush=True)

    model.eval()

    def coords_fn(images):
        with torch.inference_mode():
            return model(images)[0]

    res = evaluate_landmarks(coords_fn, train, test, norm="iod", device=dev)
    return {
        "name": oracle_name(k, temporal, pose_gap),
        "k": k,
        "steps": steps,
        "batch": batch,
        "test_pct": round(res["landmark_error_test_pct"], 3),
        "train_pct": round(res["landmark_error_train_pct"], 3),
        "wall_s": round(time.time() - t0, 1),
    }


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--steps", type=int, default=6000)
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--k", default="5,10,30")
    parser.add_argument("--temporal", action="store_true",
                        help="measure the temporal-protocol ceiling: train on sample_pair "
                        "frames (the temporal recipe's image stream) instead of single frames")
    parser.add_argument("--pose-gap", type=float, default=0.0,
                        help="pair_pose_gap for --temporal (0 = the shipped temporal recipe)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where to run (default cuda; without a GPU this raises)")
    parser.add_argument("--out", default=DEFAULT_OUT)
    args = parser.parse_args(argv)

    dev = get_device(args.device)
    done = set()
    if os.path.exists(args.out):
        with open(args.out) as f:
            done = {json.loads(ln)["name"] for ln in f if ln.strip()}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    train, test = eval_sets(dev)
    records = []

    def record(rec):
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(f"[oracle] {rec['name']}: test={rec['test_pct']:.3f} %IOD", flush=True)
        records.append(rec)

    if "gt_parts" not in done:
        record(gt_parts_oracle(train, test))
    for k in (int(x) for x in args.k.split(",")):
        name = oracle_name(k, args.temporal, args.pose_gap)
        if name in done:
            print(f"[oracle] {name}: already recorded, skipping", flush=True)
            continue
        record(supervised_oracle(k, args.steps, args.batch, train, test, temporal=args.temporal,
                                 pose_gap=args.pose_gap, device=dev))
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return records


if __name__ == "__main__":
    main()
