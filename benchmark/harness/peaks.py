"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12  # tensor cores, dense
F32_FLOPS = 67e12  # outside the tensor cores
