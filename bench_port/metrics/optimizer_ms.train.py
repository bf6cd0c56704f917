"""optimizer_ms.train: device ms an optimizer step of the kernels launched
under the span ``imm.update`` (gradient norm, Adam, the parameter EMA, the
NaN guard where on, the copy back into the model; ``spans.py``). 0 where the
step runs no such span; None without a device trace or spans."""

from bench_port.spans import device_ms


def read(ctx):
    return device_ms(ctx, "imm.update")
