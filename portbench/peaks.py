"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit). Roofline shares and MFU
are stated against these, never against a rate measured on the card."""

BF16_TENSOR_FLOPS = 989e12   # bf16 / fp16 on the tensor cores
FP32_FLOPS = 67e12           # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12    # HBM3
