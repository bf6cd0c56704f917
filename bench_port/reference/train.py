"""The plain training step of the IMM recipe, in float32: pair synthesis,
both encoders, the equivariance pass, the bottleneck, the decoder, the
perceptual loss with its balancing EMA, the marginal-entropy term, the
gradients, Adam, the parameter EMA and the BatchNorm statistics.

``follow`` runs the first steps of a training run from given weights and a
data seed, and returns what the benchmark compares: each step's raw loss
terms, the first step's gradient and BatchNorm statistics, and the state
after the last step.
"""

from __future__ import annotations

import math

import torch

from bench_port.reference.data import blob_faces, tps_pair, transform_points
from bench_port.reference.model import (
    IMMReference,
    Precision,
    is_statistic,
    marginals,
    vgg_taps,
)


def _avg_pool2(x):
    return torch.nn.functional.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def raw_loss_terms(vgg, recon, target, loss_cfg, precision):
    """[pixel MSE, then one MSE per VGG tap] of NHWC recon against target."""
    both = torch.cat([recon, target], dim=0)
    for _ in range(loss_cfg["input_scale"].bit_length() - 1):
        both = _avg_pool2(both)
    feats = vgg_taps(vgg, both, loss_cfg["taps"], precision)
    b = recon.shape[0]
    terms = [torch.mean(torch.square(recon - target))]
    terms += [torch.mean(torch.square(feats[t][:b] - feats[t][b:])) for t in loss_cfg["taps"]]
    return torch.stack(terms)


def entropy(heat, temperature):
    py, px = marginals(heat, temperature)

    def ent(p, n):
        return -torch.sum(p * torch.log(p + 1e-12), dim=1) / math.log(float(n))

    return torch.mean(0.5 * (ent(py, heat.shape[1]) + ent(px, heat.shape[2])))


class TrainReference:
    """The recipe of one configuration (its ``model``, ``train``, ``pair`` and
    ``loss`` blocks) on the flat float32 state ``p``."""

    def __init__(self, config: dict, vgg, precision: Precision | None = None, half_batch=False):
        self.cfg = config
        self.prec = precision or Precision()
        self.net = IMMReference(config["model"], self.prec)
        self.vgg = vgg
        self.half_batch = half_batch  # a planted fault: the mean over half the batch
        t = config["train"]
        unsupported = (t["optimizer"] != "adam" or t["grad_clip"] or t["weight_decay"]
                       or t["sep_weight"] or t["equi_boundaries"] or t["skip_nonfinite_updates"]
                       or config["data"]["source"] != "synthetic"
                       or config["data"]["pair_mode"] != "tps"
                       or not (config["pair"]["enable_warp"] and config["pair"]["enable_jitter"]))
        if unsupported:
            raise ValueError("the reference follows the on-device TPS recipe with Adam only")

    def draw(self, gen):
        """One step's pair, drawn as the program draws it."""
        m, t = self.cfg["model"], self.cfg["train"]
        faces = blob_faces(gen, t["batch_size"], m["image_size"])
        return tps_pair(gen, faces, self.cfg["pair"])

    def loss(self, p, pair, ema, first: bool):
        """-> (total, raw terms, new BatchNorm statistics)."""
        source, target, ps, pt = pair
        if self.half_batch:
            h = source.shape[0] // 2
            source, target = source[:h], target[:h]
            ps, pt = tuple(x[:h] for x in ps), tuple(x[:h] for x in pt)
        m, t, lc = self.cfg["model"], self.cfg["train"], self.cfg["loss"]
        stats = {}
        content = self.net.content(p, source, True, stats)
        coords, heat = self.net.pose(p, target, True, stats)
        recon = self.net.decode(p, content, self.net.render(coords), True, stats)
        raw = raw_loss_terms(self.vgg, recon, target, lc, self.prec)
        live = raw.detach()
        norm = (live if first else ema) + 1e-8
        w = torch.tensor(lc["weights"][: raw.shape[0]], device=raw.device)
        total = torch.sum(w * raw / norm) / torch.sum(w)
        view_coords, _ = self.net.pose(p, source, True)  # the view's statistics are dropped
        g = self.cfg["pair"]["n_grid"]
        equi = torch.mean(torch.sum(torch.square(
            transform_points(ps, view_coords, g) - transform_points(pt, coords, g)), dim=-1))
        total = total + t["equi_weight"] * t["equi_factors"][0] * equi
        if t["ent_weight"] > 0:
            total = total + t["ent_weight"] * entropy(heat, m["temperature"])
        return total, live, stats

    def follow(self, weights: dict, data_seed: int, steps: int):
        """Train ``steps`` steps from ``weights`` on the pairs that a generator
        seeded ``data_seed`` gives. -> dict of ``raw`` (steps, terms), ``grad0``
        (the first step's gradient by name), ``stats1`` (the BatchNorm
        statistics after it), ``params``, ``ema`` and ``stats`` after the
        last step."""
        t, lc = self.cfg["train"], self.cfg["loss"]
        names = [k for k in weights if not is_statistic(k)]
        p = {k: v.detach().clone() for k, v in weights.items()}
        ema = {k: p[k].clone() for k in names}
        mu = {k: torch.zeros_like(p[k]) for k in names}
        nu = {k: torch.zeros_like(p[k]) for k in names}
        loss_ema = torch.ones(1 + len(lc["taps"]), device=next(iter(p.values())).device)
        gen = torch.Generator(loss_ema.device).manual_seed(data_seed)
        b1, b2, d = t["adam_b1"], t["adam_b2"], t["param_ema_decay"]
        raws, grad0, stats1 = [], None, None
        for step in range(steps):
            with torch.no_grad():
                pair = self.draw(gen)
            leaves = {k: p[k].requires_grad_(True) for k in names}
            total, live, stats = self.loss(p, pair, loss_ema, step == 0)
            grads = torch.autograd.grad(total, list(leaves.values()), allow_unused=True)
            with torch.no_grad():
                grads = {k: torch.zeros_like(p[k]) if g is None else g
                         for k, g in zip(names, grads)}
                if grad0 is None:
                    grad0 = grads
                raws.append(live)
                ema_prev = live if step == 0 else loss_ema
                loss_ema = lc["ema_decay"] * ema_prev + (1.0 - lc["ema_decay"]) * live
                lr = t["learning_rate"] * _lr_factor(t, step)
                c = float(step + 1)
                for k in names:
                    mu[k] = (1.0 - b1) * grads[k] + b1 * mu[k]
                    nu[k] = (1.0 - b2) * grads[k] * grads[k] + b2 * nu[k]
                    u = (mu[k] / (1.0 - b1**c)) / (torch.sqrt(nu[k] / (1.0 - b2**c)) + 1e-8)
                    p[k] = p[k].detach() - lr * u
                    if d > 0:
                        ema[k] = ema[k] * d + p[k] * (1.0 - d)
                p.update(stats)
                if stats1 is None:
                    stats1 = {k: v for k, v in p.items() if is_statistic(k)}
        return {
            "raw": torch.stack(raws),
            "grad0": grad0,
            "params": {k: p[k].detach() for k in names},
            "ema": ema,
            "stats": {k: v for k, v in p.items() if is_statistic(k)},
            "stats1": stats1,
        }


def _lr_factor(t: dict, step: int) -> float:
    factor = 1.0
    for i, b in enumerate(t["lr_boundaries"]):
        if step >= b:
            factor = t["lr_factors"][i + 1]
    return factor * 1.0 / t["lr_factors"][0]
