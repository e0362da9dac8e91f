"""PyTorch/CUDA port of the ternary-compression system in ``repro``.

The package mirrors ``repro``'s layout (``core``, ``comm``, ``kernels``,
``models``, ``configs``, ``launch``) so every module has an obvious
counterpart. It imports ``torch`` and ``numpy`` only. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; the hand-written
kernels under ``kernels/csrc`` are built with ``nvcc`` at first use.

Parameters are nested dicts of tensors with the reference's keys and
layouts (stacked ``(L, K, N)`` blocks, dense weights ``(in, out)``), so
wire record paths and flatten order match the JAX package exactly.

Two modules of ``repro`` have no counterpart, because they exist for XLA
only: ``launch/hlo_analysis.py`` (a trip-count-aware cost of compiled XLA
HLO; the port's dry-run counts FLOPs, bytes moved and collectives with
dispatch-level counters as its step runs, ``launch/dryrun.py``) and
``compat.py`` (shims between JAX 0.4 and 0.5 APIs; the port calls
PyTorch's APIs directly and has no such drift to bridge).
"""
