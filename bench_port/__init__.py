"""The benchmark of the PyTorch/CUDA port ``imm_tpu_torch`` on one NVIDIA H100:
cells found by name under this folder, run by ``python3 -m bench_port.run``."""
