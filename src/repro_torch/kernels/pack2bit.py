"""2-bit ternary pack / unpack in the matmul layout: ``csrc/pack2bit.cu``.

Replaces the TPU kernels ``repro/kernels/pack2bit.py::_pack_kernel``
(``pack2bit``) and ``::_unpack_kernel`` (``unpack2bit``). Codes
c = I_t + 1 ∈ {0, 1, 2}, four K-consecutive codes of one column per byte:

    packed[k4, n] = Σ_j c[4·k4 + j, n] << 2j

This is the ``(K//4, N)`` layout ``ternary_matmul`` reads (and
``kernels.repack`` builds from wire bytes); the WIRE layout packs four
consecutive flat elements instead (``core.ternary.pack2bit``).
``pad_to_packable`` and ``unpack_padded`` round-trip a tensor of any shape
through it.

Bound on the H100: bytes — 1 byte of int8 and a quarter byte packed per
code. One thread takes 4 neighbouring columns of one packed row (one 32-bit
word out of four in, or the reverse); N % 4 ≠ 0 takes one column per
thread.

``pack2bit`` and ``unpack2bit`` dispatch on the tensor's device: the plain
PyTorch versions for a CPU tensor, the CUDA kernels for a CUDA tensor (or
they raise). ``pack2bit.launches`` and ``unpack2bit.launches`` count kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

_THREADS = 256
_MAX_BLOCKS = 132 * 16


def pack2bit_plain(i_t: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (``repro.kernels.ref.pack2bit_ref``):
    (K, N) int8 ternary → (K//4, N) uint8."""
    k, n = i_t.shape
    c = (i_t.to(torch.int32) + 1).reshape(k // 4, 4, n)
    b = c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)
    return (b & 0xFF).to(torch.uint8)


def unpack2bit_plain(packed: torch.Tensor, dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """Plain PyTorch version (``repro.kernels.ref.unpack2bit_ref``):
    (K//4, N) uint8 → (K, N) ternary values in ``dtype``."""
    k4, n = packed.shape
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=packed.device)
    codes = (packed.reshape(k4, 1, n) >> shifts.reshape(1, 4, 1)) & 3
    return (codes.reshape(4 * k4, n).to(torch.int32) - 1).to(dtype)


def _launch_blocks(work: int) -> int:
    return max(1, min(-(-max(work, 1) // _THREADS), _MAX_BLOCKS))


def _fn(name: str, argtypes: list):
    from repro_torch.kernels import _build

    fn = getattr(_build.load("pack2bit"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check_cuda(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous")


def pack2bit(i_t: torch.Tensor) -> torch.Tensor:
    """(K, N) int8 ternary → (K//4, N) uint8; K must be a multiple of 4."""
    if i_t.ndim != 2 or i_t.shape[0] % 4:
        raise ValueError(f"pack2bit: want (K, N) with K % 4 == 0, got {tuple(i_t.shape)}")
    if i_t.device.type == "cpu":
        return pack2bit_plain(i_t)
    _check_cuda(i_t, "pack2bit")
    if i_t.dtype != torch.int8:
        raise TypeError(f"pack2bit kernel takes int8, got {i_t.dtype}")
    k, n = i_t.shape
    out = torch.empty((k // 4, n), dtype=torch.uint8, device=i_t.device)
    if out.numel() == 0:
        return out
    vec = int(n % 4 == 0 and i_t.data_ptr() % 4 == 0 and out.data_ptr() % 4 == 0)
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = _fn("pack2bit_i8", [p, ll, ll, i, p, i, p])
    with torch.cuda.device(i_t.device):
        stream = torch.cuda.current_stream(i_t.device).cuda_stream
        err = fn(i_t.data_ptr(), k // 4, n, vec, out.data_ptr(),
                 _launch_blocks(out.numel() // (4 if vec else 1)), stream)
    if err != 0:
        raise RuntimeError(f"pack2bit kernel launch failed: CUDA error {err}")
    pack2bit.launches += 1
    return out


def unpack2bit(packed: torch.Tensor, dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """(K//4, N) uint8 → (K, N) ternary values in ``dtype``. The kernel
    writes int8; another dtype is a conversion of its result."""
    if packed.ndim != 2:
        raise ValueError(f"unpack2bit: want (K//4, N), got {tuple(packed.shape)}")
    if packed.device.type == "cpu":
        return unpack2bit_plain(packed, dtype)
    _check_cuda(packed, "unpack2bit")
    if packed.dtype != torch.uint8 or not (dtype == torch.int8 or dtype.is_floating_point):
        raise TypeError("unpack2bit kernel takes uint8 to int8 or a float dtype, "
                        f"got {packed.dtype} to {dtype}")
    k4, n = packed.shape
    out = torch.empty((4 * k4, n), dtype=torch.int8, device=packed.device)
    if out.numel() == 0:
        return out.to(dtype)
    vec = int(n % 4 == 0 and packed.data_ptr() % 4 == 0 and out.data_ptr() % 4 == 0)
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = _fn("unpack2bit_i8", [p, ll, ll, i, p, i, p])
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        err = fn(packed.data_ptr(), k4, n, vec, out.data_ptr(),
                 _launch_blocks(packed.numel() // (4 if vec else 1)), stream)
    if err != 0:
        raise RuntimeError(f"unpack2bit kernel launch failed: CUDA error {err}")
    unpack2bit.launches += 1
    return out.to(dtype)


pack2bit.launches = 0
unpack2bit.launches = 0


def pad_to_packable(i_t: torch.Tensor, lanes: int = 128) -> tuple[torch.Tensor, int]:
    """Flatten ``i_t`` and pad it with int8 0 (code 1, ternary value 0) to a
    multiple of ``4·lanes``: returns the ``(K, lanes)`` view ``pack2bit``
    takes and the original element count for ``unpack_padded``."""
    flat = i_t.reshape(-1)
    n = flat.numel()
    pad = (-n) % (4 * lanes)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, lanes), n


def unpack_padded(packed: torch.Tensor, n_elements: int, *,
                  dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """Inverse of ``pack2bit(pad_to_packable(x)[0])``: the flat ternary
    values of the first ``n_elements``."""
    return unpack2bit(packed, dtype).reshape(-1)[:n_elements]
