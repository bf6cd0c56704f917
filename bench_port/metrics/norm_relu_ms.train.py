"""norm_relu_ms.train: device ms an optimizer step of the kernels launched
under the span ``imm.norm_relu`` (each conv block's BatchNorm in train mode
and its ReLU), forward and backward: a backward kernel goes to the span of
the forward op that made its autograd node (``spans.py``). 0 where the step
runs no such span; None without a device trace or spans."""

from bench_port.spans import device_ms


def read(ctx):
    return device_ms(ctx, "imm.norm_relu")
