"""Ternary-weight matmul on 2-bit packed weights: ``csrc/ternary_matmul.cu``
(fp32 x) and ``csrc/ternary_matmul_bf16.cu`` (bf16 x).

Replaces the TPU kernel ``repro/kernels/ternary_matmul.py::_kernel``:
y = x @ (w_q · unpack(W)) with W the ``(K//4, N)`` uint8 layout of
``kernels.repack`` (each byte holds 4 K-consecutive codes of one column),
fp32 accumulation, w_q applied once to the finished sum.

The kernel runs on the tensor cores (bf16 → fp32: ``mma.sync`` for M ≤ 16,
``wgmma`` with the weights from registers above). The ternary
weights are exact in bf16 and x is split into three bf16 parts whose sum is
x exactly (``split_bf16x3``), so every product is exact and only the fp32
accumulation rounds, as in a fp32 matmul; ``ternary_matmul_split`` is that
arithmetic in plain PyTorch. Bound on the H100: bytes at decode (M = 4:
2^28 packed bytes a step, 84 µs at 3.35 TB/s), bf16 operations at prefill
(3 · 2MKN at 989 TFLOP/s). The design (see the source): weights as the A
operand from registers, the output computed transposed, K permuted inside
each 16-deep step so a thread unpacks whole bytes, a cp.async ring of
shared-memory stages, and K split across blocks when M and N alone give
too few blocks to fill 132 SMs.

bf16 x has kernels of its own (``ternary_matmul_bf16``): each output is one
bf16 × exact-weight product summed in fp32, times w_q in fp32, rounded to
bf16 (to nearest, ties to even) and returned as bf16, as the reference
kernel returns ``x.dtype``. Its bound is bytes at decode and 2MKN bf16
operations at prefill. One launch a call and no workspace: at decode
(M ≤ 16) an ``mma.sync`` kernel of 64 output columns a block whose 8 warps
each stream their own K stages through a cp.async ring; above, a ``wgmma``
kernel of 128 columns a block (a producer warp loading the weights by
cp.async and x by TMA, two consumer warpgroups taking turns at the tensor
cores) that spreads each unpacked weight byte over a 64-, 128- or 256-row
tile of x. Where the output tiles are too few for 132 SMs, K is split
across the blocks of a thread-block cluster, and each block adds its share
of the partial tiles, stored into it through distributed shared memory, in
split order, so results are deterministic. Both launch with programmatic
dependent launch: they stream their weights before the kernel ahead of
them ends. ``launch_shape_bf16`` is the launch rule.

``ternary_matmul`` dispatches on the tensor's device: the plain PyTorch
version for CPU tensors, the CUDA kernel for CUDA tensors (or it raises).
``ternary_matmul.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.pack2bit import unpack2bit_plain

BN = 128           # output columns per block (the bf16 wgmma kernel's too)
KC4 = 32           # packed rows per pipeline stage: the least K work of a split
SM_COUNT = 132     # streaming multiprocessors of an H100 SXM
MAX_SPLIT = 8      # bf16 K splits: the blocks of a portable thread-block cluster
BF16_STAGE4 = 16   # packed rows per stage of the bf16 kernels (64 K)
BF16_DECODE_BN = 64     # output columns per block of the bf16 mma.sync kernel
BF16_DECODE_WARPS = 8   # its warps, each a K slot


def ternary_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                         w_q: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (``repro.kernels.ref.ternary_matmul_ref``):
    the product in fp32 (exact for bf16 x), × w_q, cast to x's dtype."""
    w = unpack2bit_plain(packed, torch.float32)
    y = x.to(torch.float32) @ w
    return (y * w_q.to(torch.float32)).to(x.dtype)


def split_bf16x3(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's exact split of fp32 x into three bf16 parts (returned as
    bf16-valued fp32): hi = bf16(x), mid = bf16(x − hi), lo = bf16(x − hi −
    mid). Both subtractions are exact in fp32, so hi + mid + lo == x for
    every normal x."""
    x = x.to(torch.float32)
    hi = x.to(torch.bfloat16).to(torch.float32)
    r = x - hi
    mid = r.to(torch.bfloat16).to(torch.float32)
    lo = (r - mid).to(torch.bfloat16).to(torch.float32)
    return hi, mid, lo


def ternary_matmul_split(x: torch.Tensor, packed: torch.Tensor,
                         w_q: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: three products of the bf16
    parts of x with the exact weights, summed (lo + mid) + hi, then × w_q."""
    w = unpack2bit_plain(packed, torch.float32)
    hi, mid, lo = split_bf16x3(x)
    return ((lo @ w + mid @ w) + hi @ w) * w_q.to(torch.float32)


def launch_shape(m: int, k4: int, n: int) -> tuple[int, int]:
    """(row tile, K splits) for an (m, 4·k4) @ (4·k4, n) product. The row
    tile is 4 rows of x at decode-sized m and 16 up to 16 rows (mma.sync),
    else 32 (the warpgroup kernel); a block is BN output columns either
    way. K is split only as far as needed for two blocks per SM at
    decode-sized m (bound by bytes, so blocks keep reads in flight) and one
    per SM above (bound by issue, where every split adds workspace
    traffic), and never below one stage of K per split."""
    bm = 4 if m <= 4 else 16 if m <= 16 else 32
    target = 2 * SM_COUNT if bm == 4 else SM_COUNT
    blocks = -(-n // BN) * -(-m // bm)
    split = max(1, min(-(-target // blocks), k4 // KC4))
    per = max(1, -(-k4 // split))
    return bm, max(1, -(-k4 // per))


@functools.lru_cache(maxsize=1024)
def launch_shape_bf16(m: int, k4: int, n: int) -> tuple[int, int]:
    """(rows of x per block, K splits) of the bf16 kernels for an
    (m, 4·k4) @ (4·k4, n) product. Rows 8 or 16 select the ``mma.sync``
    kernel (blocks of ``BF16_DECODE_BN`` columns): decode-sized m, and any K
    that is not a multiple of 8, whose rows of x the TMA cannot address.
    Rows 64, 128 or 256 select the ``wgmma`` kernel (blocks of ``BN``
    columns), 256 only where its tiles alone fill half the card. K is split
    in powers of two across a thread-block cluster while the blocks stay
    within two per SM at decode (bound by bytes: blocks keep reads in
    flight) and one per SM above (bound by operations), and while every
    split keeps a stage for each of the decode kernel's warps, or two
    stages above: up to ``MAX_SPLIT`` splits at decode and half as many
    above, where a block has its SM to itself and clusters of 8 do not all
    fit the GPCs at once. Each split is a whole number of 64-K stages (the
    kernels round the same way)."""
    stage = BF16_STAGE4
    if m > 16 and k4 % 2 == 0 and k4 >= stage:
        bm = 64 if m <= 64 else 128
        if m > 192 and 2 * -(-n // BN) * -(-m // 256) > SM_COUNT:
            bm = 256                      # enough tiles unsplit: its K is never split
        bn, target, most, least = BN, SM_COUNT, MAX_SPLIT // 2, 2 * stage
    else:
        bm = 8 if m <= 8 else 16
        bn, target, most = BF16_DECODE_BN, 2 * SM_COUNT, MAX_SPLIT
        least = BF16_DECODE_WARPS * stage
    tiles = -(-n // bn) * -(-m // bm)
    split = 1
    while split < most and 2 * split * tiles <= target and k4 >= 2 * split * least:
        split *= 2
    per = -(-(-(-k4 // split)) // stage) * stage
    return bm, max(1, -(-k4 // per))


_ENTRIES = {torch.float32: ("ternary_matmul", "ternary_matmul_f32"),
            torch.bfloat16: ("ternary_matmul_bf16", "ternary_matmul_bf16")}


def _lib(dtype: torch.dtype):
    from repro_torch.kernels import _build

    lib, entry = _ENTRIES[dtype]
    fn = getattr(_build.load(lib), entry)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        ws = [p] if dtype == torch.float32 else []      # the fp32 entry's split-K workspace
        fn.argtypes = [p, p, p, p, *ws, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def ternary_matmul(x: torch.Tensor, packed: torch.Tensor,
                   w_q: torch.Tensor) -> torch.Tensor:
    """x: (M, K) fp32 or bf16 · packed: (K//4, N) uint8 · w_q: scalar
    tensor → (M, N) in x's dtype."""
    if x.ndim != 2 or packed.ndim != 2 or packed.shape[0] * 4 != x.shape[1]:
        raise ValueError(
            f"ternary_matmul: x {tuple(x.shape)} does not match packed "
            f"{tuple(packed.shape)} (want x (M, K), packed (K//4, N))"
        )
    if x.device.type == "cpu":
        return ternary_matmul_plain(x, packed, w_q)
    if x.device.type != "cuda":
        raise ValueError(f"ternary_matmul: unsupported device {x.device}")
    if x.dtype not in _ENTRIES:
        raise TypeError(f"ternary_matmul kernel takes float32 or bfloat16 x, got {x.dtype}")
    if packed.dtype != torch.uint8 or w_q.numel() != 1 or w_q.dtype != torch.float32:
        raise TypeError("ternary_matmul: packed must be uint8 and w_q one float32")
    if packed.device != x.device or w_q.device != x.device:
        raise ValueError("ternary_matmul: x, packed and w_q must share a device")
    if not (x.is_contiguous() and packed.is_contiguous()):
        raise ValueError("ternary_matmul: x and packed must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("ternary_matmul: x must be 16-byte aligned")
    m, _ = x.shape
    k4, n = packed.shape
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    fn = _lib(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if x.dtype == torch.bfloat16:
            bm, split = launch_shape_bf16(m, k4, n)
            wvec = 16 if n % 16 == 0 and packed.data_ptr() % 16 == 0 else 1
            err = fn(x.data_ptr(), packed.data_ptr(), w_q.data_ptr(), out.data_ptr(),
                     m, k4, n, bm, split, wvec, stream)
        else:
            bm, split = launch_shape(m, k4, n)
            ws = (torch.empty((split, m, n), dtype=torch.float32, device=x.device)
                  if split > 1 else out)
            wvec = next(v for v in (16, 4, 1) if n % v == 0 and packed.data_ptr() % v == 0)
            err = fn(x.data_ptr(), packed.data_ptr(), w_q.data_ptr(), out.data_ptr(),
                     ws.data_ptr(), m, k4, n, bm, split, wvec, stream)
    if err != 0:
        raise RuntimeError(f"ternary_matmul kernel launch failed: CUDA error {err}")
    ternary_matmul.launches += 1
    return out


ternary_matmul.launches = 0
