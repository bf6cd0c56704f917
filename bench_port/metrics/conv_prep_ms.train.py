"""conv_prep_ms.train: device ms an optimizer step of the kernels launched
under the span ``imm.conv_prep`` (what each convolution of the model and the
VGG loss does before ``F.conv2d``: the SAME pad and the casts of input,
weight and bias), forward and backward (``spans.py``). 0 where the step runs
no such span; None without a device trace or spans."""

from bench_port.spans import device_ms


def read(ctx):
    return device_ms(ctx, "imm.conv_prep")
