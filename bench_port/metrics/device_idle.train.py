"""The device's idle share in the measured window: one minus the device's
busy time per unit of work (the union of its kernels, copies and fills in
the lightly traced slice, over the slice's steps or calls) over the
window's wall time per unit (untraced, on the host's clock). The traced
slice alone reads higher: its tracer slows the host."""


def read(ctx):
    t, w = ctx.trace, ctx.window
    if t is None or not t.has_device:
        return None
    return 100.0 * (1.0 - (t.busy_s / t.units) / (w["seconds"] / w["units"]))
