"""loss_ms.train: device ms an optimizer step of the kernels launched under
the span ``imm.loss`` (the VGG on the reconstruction and the target, the
pixel and feature terms, the loss EMA), forward and backward
(``spans.py``). 0 where the step runs no such span; None without a device
trace or spans."""

from bench_port.spans import device_ms


def read(ctx):
    return device_ms(ctx, "imm.loss")
