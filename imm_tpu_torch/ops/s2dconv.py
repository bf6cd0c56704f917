"""Space-to-depth reformulation of low-channel stride-1 convolutions.
Mirrors ``imm_tpu.ops.s2dconv``.

The input is re-laid as ``(H/b, W/b, b*b*C)`` blocks so that the same
arithmetic runs as a conv with ``b*b`` times the input channels at ``1/b``
the spatial resolution. The stride-1 conv is reformulated *exactly*: all
``b*b`` output phases come out as channel groups and are re-interleaved, so
``s2d_conv`` computes the same function as the direct conv with SAME
padding, and the kernel keeps its canonical ``(kh, kw, cin, cout)`` shape.
The zero taps inflate the operations by ``(b*ext / kh)**2`` (7x7: 2.04x at
b=2), for a contraction ``b*b`` times as deep.

The public functions keep the JAX package's layouts (NHWC images, HWIO
kernels) and channel packings; ``s2d_conv_nchw`` is the same conv on the
NCHW tensors the port's models carry. The block conv is ``F.conv2d``, where
the JAX package calls ``lax.conv``: no hand-written kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def s2d_kernel(kernel: torch.Tensor, block: int) -> torch.Tensor:
    """Transform a (kh, kw, cin, cout) stride-1 SAME kernel to block space.

    Returns (ext, ext, cin*b*b, cout*b*b) with channel packings
    in: ``ci*b*b + ry*b + rx``; out: ``co*b*b + py*b + px``.
    """
    kh, kw, cin, cout = kernel.shape
    if kh != kw or kh % 2 != 1:
        raise ValueError(f"odd square kernels only, got {tuple(kernel.shape)}")
    b = block
    p = kh // 2
    ext = (kh - 1) // b + 2  # block-space kernel extent
    pad_lo = (ext // 2) * b  # zero-pad so all gathered indices are valid
    kp = F.pad(kernel, (0, 0, 0, 0, pad_lo, pad_lo, pad_lo, pad_lo))
    dev = kernel.device
    a = torch.arange(ext, device=dev)[:, None, None]
    r = torch.arange(b, device=dev)[None, :, None]
    ph = torch.arange(b, device=dev)[None, None, :]
    # di = b*(a - ext//2) + r + p - ph, shifted by pad_lo into kp's index space
    d = b * (a - ext // 2) + r + p - ph + pad_lo  # (ext, b, b)
    full = kp[d[:, None, :, None, :, None], d[None, :, None, :, None, :]]
    # (ext, ext, b[ry], b[rx], b[py], b[px], cin, cout)
    return full.permute(0, 1, 6, 2, 3, 7, 4, 5).reshape(ext, ext, cin * b * b, cout * b * b)


def space_to_depth(x: torch.Tensor, block: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/b, W/b, C*b*b), channel packing ci*b*b+ry*b+rx."""
    n, h, w, c = x.shape
    b = block
    x = x.reshape(n, h // b, b, w // b, b, c)
    return x.permute(0, 1, 3, 5, 2, 4).reshape(n, h // b, w // b, c * b * b)


def depth_to_space(x: torch.Tensor, block: int) -> torch.Tensor:
    """Inverse of :func:`space_to_depth` (packing co*b*b+py*b+px)."""
    n, hh, ww, cbb = x.shape
    b = block
    c = cbb // (b * b)
    x = x.reshape(n, hh, ww, c, b, b)
    return x.permute(0, 1, 4, 2, 5, 3).reshape(n, hh * b, ww * b, c)


def s2d_conv_nchw(x: torch.Tensor, kernel: torch.Tensor, block: int = 2) -> torch.Tensor:
    """``s2d_conv`` on an NCHW input: (B, cin, H, W) -> (B, cout, H, W),
    the kernel (kh, kw, cin, cout) as ``s2d_conv`` takes it."""
    n, c, h, w = x.shape
    b = block
    if h % b or w % b:
        raise ValueError(f"spatial size {(h, w)} is not divisible by the block {b}")
    # space to depth with the channel packing ci*b*b + ry*b + rx
    xs = x.reshape(n, c, h // b, b, w // b, b).permute(0, 1, 3, 5, 2, 4)
    xs = xs.reshape(n, c * b * b, h // b, w // b)
    kb = s2d_kernel(kernel, b)
    ext = kb.shape[0]
    # block offsets a run over [-ext//2, ext-1-ext//2] (see s2d_kernel)
    lo, hi = ext // 2, ext - 1 - ext // 2
    y = F.conv2d(F.pad(xs, (lo, hi, lo, hi)), kb.permute(3, 2, 0, 1))
    cout = y.shape[1] // (b * b)
    # depth to space from the packing co*b*b + py*b + px
    y = y.reshape(n, cout, b, b, h // b, w // b).permute(0, 1, 4, 2, 5, 3)
    return y.reshape(n, cout, h, w)


def s2d_conv(x: torch.Tensor, kernel: torch.Tensor, block: int = 2) -> torch.Tensor:
    """Exactly the direct stride-1 SAME conv (``reference_conv``) via block
    relayout.

    Args:
      x: (B, H, W, cin) with H, W divisible by ``block``.
      kernel: (kh, kw, cin, cout), odd square kh.
      block: spatial block size b.

    Returns:
      (B, H, W, cout), equal to the direct conv up to float reassociation.
    """
    return s2d_conv_nchw(x.permute(0, 3, 1, 2), kernel, block).permute(0, 2, 3, 1)


def reference_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The direct stride-1 SAME conv (the function s2d_conv reproduces):
    NHWC input, HWIO kernel."""
    kh, kw = kernel.shape[:2]
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    xp = F.pad(x.permute(0, 3, 1, 2), (pw, kw - 1 - pw, ph, kh - 1 - ph))
    return F.conv2d(xp, kernel.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
