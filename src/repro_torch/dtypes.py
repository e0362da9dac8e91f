"""Dtype names as the wire writes them, mapped to torch and numpy.

The wire records a dtype by its numpy name (``"float32"``, ``"bfloat16"``,
...). numpy has no bfloat16, so a bfloat16 payload travels as the raw bytes
of a ``uint16`` array and is viewed back as ``torch.bfloat16``.
"""

from __future__ import annotations

import numpy as np
import torch

_TORCH = {
    "float64": torch.float64,
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int64": torch.int64,
    "int32": torch.int32,
    "int16": torch.int16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "uint16": torch.uint16,
    "uint32": torch.uint32,
    "uint64": torch.uint64,
    "bool": torch.bool,
}
_NAME = {v: k for k, v in _TORCH.items()}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _TORCH[name]
    except KeyError:
        raise TypeError(f"unknown dtype name {name!r}") from None


def dtype_name(dtype) -> str:
    """Wire name of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return _NAME[dtype]
    return np.dtype(dtype).name


def storage_numpy_dtype(name: str) -> np.dtype:
    """numpy dtype whose bytes carry a payload of wire dtype ``name``."""
    torch_dtype(name)
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def to_numpy(x) -> np.ndarray:
    """Host numpy array holding the bytes of ``x`` (bfloat16 as uint16).
    A CPU tensor is viewed, not copied."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.uint16)
        return x.cpu().numpy()
    return np.asarray(x)


def from_numpy(arr: np.ndarray, name: str) -> torch.Tensor:
    """CPU tensor of wire dtype ``name`` aliasing ``arr``'s memory."""
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if name == "bfloat16" else t


def is_floating(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_floating_point()
    return np.issubdtype(np.asarray(x).dtype, np.floating)


# fp32's least normal magnitude, which bf16 shares
TINY = 2.0 ** -126
# the dtypes XLA computes in fp32 with the rule below (fp16's own subnormals
# are normal in fp32)
_XLA_FLUSHED = (torch.float32, torch.bfloat16, torch.float16)


def flush_subnormal(t: torch.Tensor) -> torch.Tensor:
    """``t`` with every subnormal value replaced by a zero of its sign.

    XLA computes fp32 and bf16 on the CPU with denormals flushed, as the TPU
    does: a subnormal operand enters the arithmetic as zero, and a subnormal
    result comes out as zero (bf16 arithmetic runs in fp32 and is rounded
    after). The plain versions of the kernels apply this where the reference
    reads an operand or forms a result; normal values pass unchanged.
    t · [|t| ≥ TINY] is t where the test holds and t · 0, a zero of t's
    sign (NaN for NaN), where it fails."""
    return t * (t.abs() >= TINY)


def flush_subnormal_(t: torch.Tensor) -> torch.Tensor:
    """``flush_subnormal`` in place."""
    return t.mul_(t.abs() >= TINY)


def largest_subnormal(dtype: torch.dtype) -> float:
    """The value just below TINY in ``dtype`` (fp32 or bf16): for x of that
    dtype, |x| > it exactly when x is normal or infinite."""
    return TINY * (1.0 - torch.finfo(dtype).eps)


def flushed_abs(x: torch.Tensor) -> torch.Tensor:
    """|x| as XLA reads it, a subnormal as a zero: one pass over a new
    tensor. Normal values and their order are untouched, so a sum, mean or
    norm over it has the bits it has over |x| wherever x holds no
    subnormal."""
    a = x.abs()
    if a.dtype not in _XLA_FLUSHED:
        return a
    return torch.nn.functional.threshold_(a, largest_subnormal(a.dtype), 0.0)


def xla_op(op, *xs: torch.Tensor) -> torch.Tensor:
    """``op(*xs)`` as XLA forms one elementwise step: the operands flushed,
    the step computed in fp32 and flushed, the result rounded to the
    operands' promoted dtype. For normal operands and result this is
    ``op(*xs)`` bit for bit (PyTorch also computes a bf16 or fp16 step in
    fp32 and rounds once). Other dtypes (integers, fp64) pass through
    ``op``. The flush follows the rounding, as ``flush_subnormal`` states
    the rule; XLA on the CPU tests the 24-bit result before it is placed on
    the subnormal grid, so an exact product or quotient in [2^-126 − 2^-150,
    2^-126 − 2^-151), which rounds up to 2^-126, is kept here and flushed
    there. A sum or difference of fp32 values, a multiple of 2^-149, never
    falls in that window."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    if dt not in _XLA_FLUSHED:
        return op(*xs)
    return flush_subnormal(op(*(flush_subnormal(x).to(torch.float32) for x in xs))).to(dt)

