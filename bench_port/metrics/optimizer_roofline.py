"""optimizer_roofline: the optimizer step's share of its roofline: the least
time of an Adam step with the parameter EMA and the gradients' global norm
over the cell's parameters (``counts/optimizer.py``: each byte once at the
HBM rate), over the device ms a step of the kernels launched under the span
``imm.update``, as ``optimizer_ms.train`` reads them, whatever implements
the update. None where that reading is None or 0."""

from bench_port.counts.optimizer import adam_step_s


def read(ctx):
    ms = ctx.cell.module("metrics", "optimizer_ms.train").read(ctx)
    if not ms:
        return None
    return 100.0 * 1e3 * adam_step_s(ctx.cell.config) / ms
