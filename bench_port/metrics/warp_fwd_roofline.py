"""warp_fwd_roofline: the warp forward's share of its roofline: the least time
of the calls of the op ``imm_tpu::warp_fwd`` in the profiled slice (images
and grid read once, output written once, at the cell's shapes: float32 faces
and a grid at the image size), over the device time of the kernels launched
under the op, whatever implements it. Bound by bytes."""

from bench_port.counts.bytes import warp_fwd_s

OP = "imm_tpu::warp_fwd"


def read(ctx):
    t = ctx.trace
    if t is None or not t.op_device_s.get(OP):
        return None
    s = ctx.cell.config["model"]["image_size"]
    least = warp_fwd_s(ctx.window["batch"], s, s, 3, s, s, 4)
    return 100.0 * least * t.op_calls[OP] / t.op_device_s[OP]
