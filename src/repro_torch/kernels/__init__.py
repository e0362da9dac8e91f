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


def launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launch count in this process, by kernel name
    (each wrapper adds one where it launches its kernel)."""
    from repro_torch.kernels.aggregate import packed_weighted_sum
    from repro_torch.kernels.pack2bit import pack2bit, unpack2bit
    from repro_torch.kernels.quantize_pack import quantize_pack
    from repro_torch.kernels.ternary_matmul import ternary_matmul
    from repro_torch.kernels.ternary_quantize import ternary_quantize
    from repro_torch.kernels.vote import packed_vote_counts

    return {"quantize_pack": quantize_pack.launches, "ternary_matmul": ternary_matmul.launches,
            "aggregate": packed_weighted_sum.launches, "vote": packed_vote_counts.launches,
            "ternary_quantize": ternary_quantize.launches, "pack2bit": pack2bit.launches,
            "unpack2bit": unpack2bit.launches}
