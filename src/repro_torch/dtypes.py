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
    reads an operand or forms a result; normal values pass unchanged. It is
    the whole rule for a sum or difference; a product or quotient is flushed
    by its exact value instead (``flushed_op``), since XLA flushes some that
    IEEE rounding takes up to TINY. t · [|t| ≥ TINY] is t where the test
    holds and t · 0, a zero of t's sign (NaN for NaN), where it fails."""
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


# XLA on the CPU tests a product or quotient for underflow on its 24-bit
# rounding, before it is placed on the subnormal grid: it keeps an exact
# result of magnitude ≥ KEEP = 2^-126 − 2^-151 (which rounds to 2^-126 at 24
# bits, a tie going to the even 2^-126) and flushes one below it. IEEE
# rounding also takes [2^-126 − 2^-150, KEEP) up to 2^-126, so a flush after
# the rounded result alone would keep that window. KEEP has 25 significant
# bits: its product with an fp32 value is exact in fp64.
KEEP = TINY - 2.0 ** -151


# the window's lower edge: IEEE rounding takes [WINDOW_LO, KEEP) up to 2^-126,
# XLA flushes it
WINDOW_LO = TINY - 2.0 ** -150


def _f32(v) -> np.ndarray:
    return np.asarray(v, np.float64).astype(np.float32)


def window_operands(op: str, n: int = 4096, seed: int = 31) -> tuple[np.ndarray, np.ndarray]:
    """fp32 pairs (a, b), numpy, whose exact a·b ("mul") or a/b ("div")
    has a magnitude in the window [WINDOW_LO, KEEP), both signs of a: the
    enumeration that the port's window checks (tests and ``chip_smoke.py``)
    run through every function forming such a product or quotient.

    mul: one a for each b drawn with a seeded significand in the binades
    2^-60 … 2^20 where one fits (at most one fp32 a does; for b > 1 it is
    subnormal). div: a quotient by an fp32 b lands in the window only where
    b = 2^k (elsewhere the grid below 2^-126·b steps over it), and then at
    a = 2^-126·b·(1 − 2^-24), the window's lower edge, a tie that IEEE
    rounds up to the even 2^-126: one pair for each k in 1 … 127 and each
    sign of b. The tests are exact in fp64 (an fp32 product has 48 bits,
    KEEP and the window's lower edge 25 and 24)."""
    if op == "div":
        b = np.ldexp(1.0, np.arange(1, 128))
        b = np.concatenate([b, -b])
        a = (WINDOW_LO * np.abs(b)).astype(np.float32)
        assert (a.astype(np.float64) == WINDOW_LO * np.abs(b)).all()
        return np.concatenate([a, -a]), np.concatenate([b, b]).astype(np.float32)
    rng = np.random.default_rng(seed)
    sig = 1.0 + rng.integers(0, 2 ** 23, n) / 2 ** 23
    b = _f32(np.ldexp(sig, rng.integers(-60, 21, n))).astype(np.float64)
    a = _f32(WINDOW_LO / b).astype(np.float64)
    for _ in range(2):
        up = np.nextafter(a.astype(np.float32), np.float32(np.inf)).astype(np.float64)
        down = np.nextafter(a.astype(np.float32), np.float32(0)).astype(np.float64)
        a = np.where(a * b < WINDOW_LO, up, np.where(down * b >= WINDOW_LO, down, a))
    ok = (a * b >= WINDOW_LO) & (a * b < KEEP)
    a, b = a[ok].astype(np.float32), b[ok].astype(np.float32)
    return np.concatenate([a, -a]), np.concatenate([b, b])


def window_pairs(op: str) -> tuple[np.ndarray, np.ndarray]:
    """``window_operands`` and, with the same b, each a's fp32 neighbours
    one step down and up (just below the window, or at or above KEEP)."""
    a, b = window_operands(op)
    down = np.nextafter(a, np.float32(0))
    up = np.nextafter(a, np.copysign(np.float32(np.inf), a))
    return np.concatenate([a, down, up]), np.concatenate([b, b, b])


def _ceil32(c: torch.Tensor) -> torch.Tensor:
    """The least fp32 value ≥ each fp64 value ≥ 0 of ``c`` (inf above fp32's
    range, NaN for NaN): c rounded to fp32, and one step up (the next bit
    pattern) where that fell below c."""
    f = c.to(torch.float32)
    up = (f.view(torch.int32) + 1).view(torch.float32)
    return torch.where(f.double() < c, up, f)


def keep_cut(b: torch.Tensor, op) -> torch.Tensor:
    """The cut c (fp32, b's shape) with: XLA keeps a ``op`` b (``torch.mul``
    or ``torch.div``, b flushed) exactly when |a| ≥ c. Both conditions of
    XLA's rule are in it: a normal (|a| ≥ TINY) and the exact result at
    least KEEP.

    A quotient: |a| ≥ KEEP·|b|, exact in fp64 (25 bits times 24).
    A product: |a| ≥ KEEP / |b|, whose least fp32 solution is the fp64
    quotient rounded up to fp32: an fp32 v with v·|b| ≠ KEEP differs from
    KEEP by a multiple of v·|b|'s last bit, at least 2^-48 of it, which
    puts v at least 2^-48 of the quotient away from it, far beyond the
    fp64 quotient's rounding (2^-53).
    b = 0 gives an infinite cut for a product (a · 0 is never kept but
    inf · 0) and TINY for a quotient; NaN gives NaN (nothing kept)."""
    mag = b.detach().to(torch.float64).abs()
    c = mag.mul_(KEEP) if op is torch.div else torch.full_like(mag, KEEP).div_(mag)
    return _ceil32(c).clamp_min_(TINY)


def flushed_op(op, a: torch.Tensor, b) -> torch.Tensor:
    """a ``op`` b (``torch.mul`` or ``torch.div``) as XLA forms it in fp32:
    a subnormal operand read as a zero of its sign, and a result flushed to
    a zero of its sign unless its exact magnitude is at least ``KEEP``. ``b``
    (a tensor that broadcasts against ``a``, best a scalar or per-row one,
    or a Python number taken in fp32) decides a cut on |a| that holds all of
    it, so ``a`` is read twice: r · [|a| ≥ c], which is r where XLA keeps it
    and r · 0 elsewhere, a zero of r's sign (the sign of XLA's flushed
    result, since r rounds the same exact value) or NaN where r is infinite
    or NaN, as XLA's ±0 ⊙ b is then. Other dtypes than fp32 (fp64) take
    ``op`` as it is."""
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(b, dtype=torch.float32, device=a.device)
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        return op(a, b)
    if op is torch.mul and a.numel() < b.numel():
        a, b = b, a
    b = flush_subnormal(b)
    return op(a, b).mul_(a.abs() >= keep_cut(b, op))


def xla_op(op, *xs) -> torch.Tensor:
    """``op(*xs)`` as XLA forms one elementwise step: the operands flushed,
    the step computed in fp32 and flushed, the result rounded to the
    operands' promoted dtype. For normal operands and result this is
    ``op(*xs)`` bit for bit (PyTorch also computes a bf16 or fp16 step in
    fp32 and rounds once). A multiply or divide (``op`` is ``torch.mul`` or
    ``torch.div``) with an fp32 or Python-number operand flushes as
    ``flushed_op`` does, by the exact result. The others need only the
    flush of their subnormals: a sum or difference of fp32 values is a
    multiple of 2^-149, and a product or quotient of two 8- or 11-bit
    significands (bf16, fp16) never lies within 2^-24 below 2^-126. A
    Python number among ``xs`` is taken in fp32 (as JAX rounds a Python
    scalar to an fp32 array's dtype) and does not enter the promotion.
    Other dtypes (integers, fp64) pass through ``op``."""
    ts = [x for x in xs if isinstance(x, torch.Tensor)]
    dt = ts[0].dtype
    for x in ts[1:]:
        dt = torch.promote_types(dt, x.dtype)
    if dt not in _XLA_FLUSHED:
        return op(*xs)
    fs = [flush_subnormal(x).to(torch.float32) if isinstance(x, torch.Tensor) else x
          for x in xs]
    wide = any(not isinstance(x, torch.Tensor) or x.dtype == torch.float32 for x in xs)
    if op in (torch.mul, torch.div) and len(fs) == 2 and wide:
        a, b = fs
        if not isinstance(a, torch.Tensor):
            a = torch.tensor(a, dtype=torch.float32, device=b.device).expand_as(b)
        return flushed_op(op, a, b).to(dt)
    return flush_subnormal(op(*fs)).to(dt)


def flush_plus(t: torch.Tensor) -> torch.Tensor:
    """t with every |t| ≤ the largest subnormal of its dtype made +0, in
    one op (``flush_subnormal`` keeps the zero's sign in three)."""
    return torch.nn.functional.hardshrink(t, largest_subnormal(t.dtype))


def flushed_product(g: torch.Tensor, scale: torch.Tensor,
                    cut: torch.Tensor | None = None) -> torch.Tensor:
    """g · scale as XLA forms it for the QAT backward's scale (1 or w_q; in
    fp32 a flushed w_q, of either zero sign). bf16: every operand and the
    fp32 product flushed, then rounded (an 8-bit significand times another
    is exact in fp32, so no product falls below ``KEEP`` and rounds to
    TINY).
    fp32: XLA reads a subnormal g as zero and keeps the product exactly
    where its exact value is at least KEEP: both are |g| ≥ cut for the
    scale's cut (``keep_cut``), given per element by the backward's
    plain version (the row's where the code is ±1, TINY where the scale is
    1; ``kernels.qat_backward``, whose kernel does it in one pass on the
    card) and computed here from ``scale`` where it is not given. So
    (g · scale) · [|g| ≥ cut]. A flushed product is a zero of the
    product's sign, as XLA's, but where the caller's w_q was flushed to
    +0."""
    if g.dtype != torch.float32:
        return xla_op(torch.mul, g, scale)
    if cut is None:
        cut = keep_cut(flush_subnormal(scale), torch.mul)
    return (g * scale).mul_(g.abs() >= cut)
