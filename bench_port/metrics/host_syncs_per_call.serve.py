"""host_syncs_per_call.serve: blocking runtime calls the host makes inside
the span ``imm.swap``, a call: the call's own, since the harness's
synchronize after each call falls outside it (``spans.py``). None without a
device trace or spans."""

from bench_port.spans import syncs


def read(ctx):
    return syncs(ctx)
