"""Kernel and graph launches from the host in the profiled slice (each
launch call counted once, by its correlation with the device), per step or
call of the slice."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.has_device:
        return None
    return t.launches / t.units
