"""pair_synthesis_ms.train: device ms an optimizer step of the kernels
launched under the program's span ``imm.pairs``: the face draw and the pair
synthesis (TPS warps through K3, colour jitter), on a second profiled slice
of the cell with the host's ops (``spans.py``). 0 where the step runs no
such span; None without a device trace or on a program without spans."""

from bench_port.spans import device_ms


def read(ctx):
    return device_ms(ctx, "imm.pairs")
