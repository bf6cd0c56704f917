"""mfu.serve: the benchmark's own FLOPs of one call
(``counts/flops.py``, as the traffic's driver gives them for its
configuration) times the calls of the window, over the window's seconds, as
a share of the card's published bf16 peak. Read on the card only."""

from bench_port.counts.peaks import BF16_FLOPS


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    w = ctx.window
    return 100.0 * w["flops_per_unit"] * w["units"] / w["seconds"] / BF16_FLOPS
