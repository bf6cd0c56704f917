"""Floating-point operations of a training step and of a swap call, counted
from the configuration's shapes: every convolution and matrix product, two
operations a multiply-add, forward and backward as autograd runs them (the
gradient of an input only where one is needed, of a weight only where it is
trained), nothing recomputed. ``torch.utils.flop_counter.FlopCounterMode``
counts the same set; a CPU test holds the two together."""

from __future__ import annotations

from bench_port.reference.model import VGG_CFG


def _conv(b, h, w, cin, cout, k, stride):
    """(output h, output w, forward operations) of a SAME convolution."""
    ho, wo = -(-h // stride), -(-w // stride)
    return ho, wo, 2 * b * ho * wo * cout * cin * k * k


def _encoder(model, b, train, first_dgrad=False):
    """Operations of one trunk (and nothing else), its output size."""
    h = w = model["image_size"]
    cin, total = 3, 0
    for i, (f, s) in enumerate(zip(model["filters"], model["strides"])):
        h, w, fwd = _conv(b, h, w, cin, f, 7 if i == 0 else 3, s)
        passes = 1 + (2 if train else 0) - (1 if train and i == 0 and not first_dgrad else 0)
        total += fwd * passes
        cin = f
    return total, h, w


def _pose(model, b, train):
    trunk, h, w = _encoder(model, b, train)
    _, _, head = _conv(b, h, w, model["filters"][-1], model["n_landmarks"], 1, 1)
    return trunk + head * (3 if train else 1)


def _decoder(model, b, train):
    h = w = model["image_size"]
    for s in model["strides"]:
        h, w = -(-h // s), -(-w // s)
    cin, total = model["filters"][-1] + model["n_landmarks"], 0
    n = len(model["decoder_filters"])
    for i, f in enumerate(model["decoder_filters"]):
        for _ in range(2):
            total += _conv(b, h, w, cin, f, 3, 1)[2] * (3 if train else 1)
            cin = f
        if i < n - 1:
            h, w = 2 * h, 2 * w
    return total + _conv(b, h, w, cin, 3, 3, 1)[2] * (3 if train else 1)


def _vgg(images, size, taps):
    """Forward and input-gradient operations of the VGG trunk up to its last tap."""
    last = max(i for i, name in enumerate(_vgg_names()) if name in taps)
    h = w = size
    cin, prev, total = 3, 1, 0
    for i, (block, width) in enumerate(VGG_CFG[: last + 1]):
        if block != prev:
            h, w, prev = h // 2, w // 2, block
        total += _conv(images, h, w, cin, width, 3, 1)[2] * 2
        cin = width
    return total


def _vgg_names():
    out, prev, idx = [], 1, 0
    for block, _ in VGG_CFG:
        if block != prev:
            prev, idx = block, 0
        idx += 1
        out.append(f"conv{block}_{idx}")
    return out


def _tps_grid(b, size, n_grid):
    n = n_grid * n_grid + 3
    return 2 * n * n * 2 * b + 2 * size * size * n * 2 * b


def _tps_points(b, k, n_grid, train):
    n = n_grid * n_grid + 3
    return 2 * n * n * 2 * b + 2 * b * k * n * 2 * (2 if train else 1)


def train_step_flops(config: dict) -> int:
    """One optimizer step: TPS pairs (two warps, the equivariance term
    mapping both passes' landmarks) or temporal pairs (one warped view, its
    landmarks mapped), with or without equivariance."""
    m, t, lc = config["model"], config["train"], config["loss"]
    b, s, k, g = t["batch_size"], m["image_size"], m["n_landmarks"], config["pair"]["n_grid"]
    tps, equi = config["data"]["pair_mode"] == "tps", t["equi_weight"] > 0
    total = _encoder(m, b, True)[0] + _pose(m, b, True) + _decoder(m, b, True)
    total += _vgg(2 * b, s // lc["input_scale"], lc["taps"])
    if tps and config["pair"]["enable_warp"]:
        total += 2 * _tps_grid(b, s, g)
    if equi:
        total += _pose(m, b, True) + (2 if tps else 1) * _tps_points(b, k, g, True)
        total += 0 if tps else _tps_grid(b, s, g)
    return total


def swap_call_flops(model: dict, batch: int) -> int:
    """One eval-mode swap: content encoder, pose encoder and head, decoder."""
    return _encoder(model, batch, False)[0] + _pose(model, batch, False) + _decoder(model, batch, False)
