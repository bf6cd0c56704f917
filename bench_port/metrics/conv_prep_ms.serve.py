"""conv_prep_ms.serve: device ms a swap call of the kernels launched under
the span ``imm.conv_prep`` (each convolution's SAME pad and casts before
``F.conv2d``; ``spans.py``). 0 where the call runs no such span; None
without a device trace or spans."""

from bench_port.spans import device_ms


def read(ctx):
    return device_ms(ctx, "imm.conv_prep")
