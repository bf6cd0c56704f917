"""host_syncs_per_step.train: blocking runtime calls (stream, device and
event synchronizations, blocking copies) the host makes inside the
program's spans, an optimizer step: the step's own, since the harness's
read of the loss falls outside them (``spans.py``). None without a device
trace or spans."""

from bench_port.spans import syncs


def read(ctx):
    return syncs(ctx)
