"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no
sparsity, at the full 700 W power limit)."""

BF16_FLOPS = 989e12      # bf16 / fp16 on the tensor cores
FP32_FLOPS = 67e12       # fp32 outside the tensor cores (TF32 off)
HBM_BYTES = 3.35e12      # HBM3 bytes/s

PEAK_FLOPS = {"bfloat16": BF16_FLOPS, "float32": FP32_FLOPS}
