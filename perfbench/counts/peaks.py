"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit).  The card's own power
limit is printed beside every result."""

BF16_FLOPS = 989e12       # bf16 / fp16 tensor cores
INT8_OPS = 1979e12        # int8 tensor cores
TF32_FLOPS = 495e12
F32_FLOPS = 67e12         # CUDA cores, outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
