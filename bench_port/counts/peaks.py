"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
full power limit of 700 W): the yardstick of every share of peak and every
roofline here, never a rate measured in the run."""

BF16_FLOPS = 989.4e12  # dense bf16 on the tensor cores
F32_FLOPS = 67e12  # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # HBM3
