"""PyTorch/CUDA port of ``imm_tpu``: unsupervised landmarks through conditional
image generation (IMM, NeurIPS 2018), trained and served on an NVIDIA Hopper
GPU.

The JAX package ``imm_tpu`` is the reference; this package keeps its public
names and layouts (NHWC images, (B, h, w, K) heatmaps, (B, K, 2) (y, x)
coords) so the two can be compared on the same inputs and weights. It never
imports JAX or ``imm_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; see
``imm_tpu_torch.utils.device.get_device``.
"""
