"""optimizer_launches_per_step.train: kernel launches from the host an
optimizer step under the span ``imm.update``, each launch call counted once
by its correlation with the device as ``host_launches_per_step.train``
counts them (``spans.py``). 0 where the step runs no such span; None
without a device trace or spans."""

from bench_port.spans import launches


def read(ctx):
    return launches(ctx, "imm.update")
