"""Hand-written Hopper kernels with their plain PyTorch versions.

``quantize_pack``, ``ternary_matmul`` and ``aggregate.packed_weighted_sum``
dispatch on the tensor's device: the plain version for CPU tensors, the
CUDA kernel (built from ``csrc/`` at first use) for CUDA tensors.
``repack`` turns wire bytes into the matmul kernel's layout.
"""
