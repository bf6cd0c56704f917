"""norm_relu_ms.serve: device ms a swap call of the kernels launched under
the span ``imm.norm_relu`` (each conv block's eval-mode BatchNorm and its
ReLU; ``spans.py``). 0 where the call runs no such span; None without a
device trace or spans."""

from bench_port.spans import device_ms


def read(ctx):
    return device_ms(ctx, "imm.norm_relu")
