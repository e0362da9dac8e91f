"""PyTorch/CUDA port of the ternary-compression system in ``repro``.

The package mirrors ``repro``'s layout (``core``, ``comm``, ``kernels``,
``models``, ``configs``, ``launch``) so every module has an obvious
counterpart. It imports ``torch`` and ``numpy`` only. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; the hand-written
kernels under ``kernels/csrc`` are built with ``nvcc`` at first use.

Parameters are nested dicts of tensors with the reference's keys and
layouts (stacked ``(L, K, N)`` blocks, dense weights ``(in, out)``), so
wire record paths and flatten order match the JAX package exactly.
"""
