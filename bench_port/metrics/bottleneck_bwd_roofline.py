"""bottleneck_bwd_roofline: the bottleneck backward's share of its roofline:
the least time of the calls of ``imm_tpu::bottleneck_bwd`` in the profiled
slice (heatmaps and both cotangents read once, d(heatmaps) written once, at
the cell's shapes), over the device time of the kernels launched under the
op, whatever implements it. Bound by bytes."""

from bench_port.counts.bytes import bottleneck_bwd_s, bottleneck_shape

OP = "imm_tpu::bottleneck_bwd"


def read(ctx):
    t = ctx.trace
    if t is None or not t.op_device_s.get(OP):
        return None
    least = bottleneck_bwd_s(*bottleneck_shape(ctx.cell.config["model"], ctx.window["batch"]))
    return 100.0 * least * t.op_calls[OP] / t.op_device_s[OP]
