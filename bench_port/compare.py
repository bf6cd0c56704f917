"""The numbers that decide ``correct``: what the timed path produced against
the plain reference, each held to a limit of the cell's own
(``workloads/<cell>.json``; the limits name the numbers compared).

Training (the first three optimizer steps of the window's own call):
- ``loss0_gap``: the largest relative gap of a raw loss term (the pixel term
  and each VGG tap) at the first step (``loss_gap``: over all three);
- ``grad_median_gap``: per leaf, the gap between the norms of the first
  gradient (the program's as Adam's first moment holds it after one step)
  over the reference's norm of that leaf or of the median leaf, whichever is
  larger; the median over the leaves (``grad_gap``: the worst leaf);
- ``stats1_gap``: the same, worst leaf, for the change of each BatchNorm
  statistic over the first step;
- ``change_gap``: the same, worst leaf, for the change of each parameter, of
  its EMA and of each BatchNorm statistic after the three steps, leaving out
  the parameters whose first gradient in the reference is under a thousandth
  of the median leaf's (they move under Adam by round-off alone).

Serving: ``image_gap``, the largest L2 distance of a generated image from
the reference's over the larger of that image's norm and the batch's median
image's, over the calls kept from the window.
"""

from __future__ import annotations

import math
import statistics

import torch

MOVED_SHARE = 1e-3


def _norms(d):
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def _gaps_of_norms(prog: dict, ref: dict, keys) -> dict[str, float]:
    """Per leaf: the gap between the two norms over the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    keys = list(keys)
    rn, pn = _norms({k: ref[k] for k in keys}), _norms({k: prog[k] for k in keys})
    med = statistics.median(rn.values())
    gaps = {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys}
    return {k: (g if math.isfinite(g) else math.inf) for k, g in gaps.items()}


def _worst(gaps: dict[str, float]) -> tuple[float, str]:
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def train_numbers(prog: dict, ref: dict, initial: dict) -> tuple[dict[str, float], dict[str, str]]:
    """-> ({number: value}, {number: the leaf or term that set it}). The
    cell's limits pick the numbers compared; ``loss_gap`` and ``grad_gap``
    are read for calibration only (their noise lies in the later steps and
    in one small leaf)."""
    raw_p, raw_r = prog["raw"].double().cpu(), ref["raw"].double().cpu()
    rel = ((raw_p - raw_r).abs() / raw_r.abs().clamp(min=1e-30))
    rel = torch.where(torch.isfinite(rel), rel, torch.full_like(rel, math.inf))
    at = int(rel.argmax())
    numbers = {"loss_gap": float(rel.max()), "loss0_gap": float(rel[0].max())}
    where = {"loss_gap": f"step {at // rel.shape[1]} term {at % rel.shape[1]}",
             "loss0_gap": f"step 0 term {int(rel[0].argmax())}"}

    grad = _gaps_of_norms(prog["grad0"], ref["grad0"], ref["grad0"])
    numbers["grad_gap"], where["grad_gap"] = _worst(grad)
    numbers["grad_median_gap"] = statistics.median(grad.values())
    keys = list(ref["stats1"])
    stats1 = _gaps_of_norms({k: prog["stats1"][k] - initial[k] for k in keys},
                            {k: ref["stats1"][k] - initial[k] for k in keys}, keys)
    numbers["stats1_gap"], where["stats1_gap"] = _worst(stats1)
    gn = _norms(ref["grad0"])
    med = statistics.median(gn.values())
    moved = [k for k, n in gn.items() if n >= MOVED_SHARE * med]
    change = {}
    for group, keys in (("params", moved), ("ema", moved), ("stats", list(ref["stats"]))):
        if keys and ref[group]:
            dp = {k: prog[group][k] - initial[k] for k in keys}
            dr = {k: ref[group][k] - initial[k] for k in keys}
            change.update({f"{group} {k}": g for k, g in _gaps_of_norms(dp, dr, keys).items()})
    numbers["change_gap"], where["change_gap"] = _worst(change)
    return {k: (v if math.isfinite(v) else math.inf) for k, v in numbers.items()}, where


def image_gap(outputs, refs: dict[int, torch.Tensor]) -> tuple[float, str]:
    """``outputs``: (call, pool index, image batch) kept from the window;
    ``refs``: pool index -> the reference's batch. Each image's L2 distance
    over the reference's norm of that image or of the batch's median image,
    whichever is larger; the largest over the images."""
    worst, at = 0.0, ""
    for call, j, out in outputs:
        r = refs[j].double()
        norm = r.flatten(1).norm(dim=1)
        norm = torch.maximum(norm, norm.median()).clamp(min=1e-30)
        d = (out.double() - r).flatten(1).norm(dim=1) / norm
        d = torch.where(torch.isfinite(d), d, torch.full_like(d, math.inf))
        if not float(d.max()) <= worst:
            worst, at = float(d.max()), f"call {call} image {int(d.argmax())}"
    return worst, at


def verdict(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    return all(numbers[k] <= limits[k] for k in limits)
