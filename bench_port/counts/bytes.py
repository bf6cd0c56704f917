"""Least device time of one call of each of the program's custom ops: the
bytes of its inputs read once and of its outputs written once at the HBM
rate, or its float32 operations at the float32 rate, whichever is longer.
Copies of the smoke script's bound functions."""

from __future__ import annotations

from bench_port.counts.peaks import F32_FLOPS, HBM_BYTES_PER_S


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS)


def bottleneck_fwd_s(b, h, w, k, oh, ow):
    """Heatmaps read, coords and maps written; two marginal sums, the
    softmax-expectation, 7 operations per rendered value."""
    return bound_s(4 * b * (h * w * k + oh * ow * k + 2 * k),
                   b * (2 * h * w * k + 6 * (h + w) * k + 7 * oh * ow * k))


def bottleneck_bwd_s(b, h, w, k, oh, ow):
    """Heatmaps, dmaps and dcoords read, dH written; the forward's
    recomputation, 6 more per rendered value, 4 per written value."""
    return bound_s(4 * b * (2 * h * w * k + oh * ow * k + 2 * k),
                   b * (2 * h * w * k + 8 * (h + w) * k + 13 * oh * ow * k + 4 * h * w * k))


def warp_fwd_s(b, h, w, c, ho, wo, itemsize):
    """Images and grid read, output written; the coordinate math (14) and
    three lerps (9) per channel, per output pixel."""
    return bound_s(b * (h * w * c * itemsize + ho * wo * (8 + c * itemsize)),
                   b * ho * wo * (14 + 9 * c))


def bottleneck_shape(model: dict, batch: int):
    """(b, h, w, k, oh, ow) of the bottleneck at a configuration's sizes."""
    h = model["image_size"]
    for s in model["strides"]:
        h = -(-h // s)
    return batch, h, h, model["n_landmarks"], h, h
