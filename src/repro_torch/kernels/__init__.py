"""Hand-written Hopper kernels with their plain PyTorch versions.

  quantize_pack    — fused quantize→pack of many segments into wire bytes in
                     one launch, with the w_q tile moments and, on request,
                     each segment's scale (client upload, server broadcast)
  ternary_matmul   — x @ (w_q · unpack(W)) on 2-bit weights on the tensor
                     cores, x split exactly into three bf16 parts (packed
                     serving)
  aggregate        — Σ coeff_c · (code − 1) over stacked client wire bytes
                     (the T-FedAvg fan-in, rule "mean")
  vote             — weighted −1/+1 vote masses over the same stacked bytes
                     (the Byzantine-robust rule "majority")
  ternary_quantize — fused FTTQ apply: codes and θ_t from one read of θ
  pack2bit         — pack2bit / unpack2bit in the (K//4, N) matmul layout

Each wrapper dispatches on the tensor's device: the plain version for CPU
tensors, the CUDA kernel (built from ``csrc/`` at first use) for CUDA
tensors. ``ops`` holds the kernel-level entry points (``fttq_apply``);
``repack`` turns wire bytes into the matmul kernel's layout.
"""
