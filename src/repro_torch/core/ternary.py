"""Ternary wire format: 2-bit packed codes, 4 weights per byte.

Port of ``repro.core.ternary``. Code mapping: code = I_t + 1 ∈ {0, 1, 2};
value 3 is unused. Four CONSECUTIVE flat elements share a byte,
little-endian within the byte:

    byte = c0 | c1 << 2 | c2 << 4 | c3 << 6

When n % 4 ≠ 0 the trailing slots of the last byte carry code 1 (ternary
value 0), so a consumer that reads past ``n`` sees zeros, never −1.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.dtypes import torch_dtype

CODES_PER_BYTE = 4


def packed_nbytes(n_elements: int) -> int:
    """Bytes needed to store n ternary values at 2 bits each."""
    return (n_elements + CODES_PER_BYTE - 1) // CODES_PER_BYTE


def pack2bit(i_t: torch.Tensor) -> torch.Tensor:
    """Flat ternary {-1, 0, +1} (any shape) → 1-D uint8, 4 codes per byte."""
    flat = i_t.reshape(-1)
    codes = (flat.to(torch.int32) + 1).to(torch.uint8)
    pad = (-codes.numel()) % CODES_PER_BYTE
    if pad:
        codes = torch.cat([codes, codes.new_ones(pad)])
    c = codes.reshape(-1, CODES_PER_BYTE)
    return c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)


def unpack_codes(packed: torch.Tensor, n_elements: int) -> torch.Tensor:
    """uint8 bytes → the first ``n_elements`` flat wire codes (uint8)."""
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=packed.device)
    return ((packed.reshape(-1, 1) >> shifts) & 3).reshape(-1)[:n_elements]


def unpack2bit(packed: torch.Tensor, n_elements: int,
               dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """Inverse of ``pack2bit``: uint8 bytes → flat ternary array of n values."""
    return (unpack_codes(packed, n_elements).to(torch.int8) - 1).to(dtype)


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.array(x)).to(device)


@dataclasses.dataclass
class TernaryTensor:
    """A ternary-quantized tensor in wire format.

    Fields:
      packed: uint8 1-D, 4 codes/byte — a numpy array or a torch tensor.
      w_q:    the trained layer scale (scalar or per-layer broadcast shape),
              numpy or torch.
      shape:  logical (unpacked) shape.
      dtype:  logical dtype name for dequantization (``"float32"``, ...).
    """

    packed: Any
    w_q: Any
    shape: tuple
    dtype: str = "float32"

    @property
    def n_elements(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    def ternary(self, device: str | torch.device = "cpu") -> torch.Tensor:
        """Unpacked codes {-1, 0, +1} at logical shape (int8)."""
        packed = _as_tensor(self.packed, device)
        return unpack2bit(packed, self.n_elements, torch.int8).reshape(self.shape)

    def nbytes_wire(self) -> int:
        """Packed bytes plus the scale's bytes, from metadata only (a scale
        on the card is not read); a Python scalar counts as float64."""
        w = self.w_q
        if isinstance(w, torch.Tensor):
            scale_bytes = w.numel() * w.element_size()
        elif hasattr(w, "dtype") and hasattr(w, "shape"):
            scale_bytes = int(np.prod(w.shape)) * np.dtype(w.dtype).itemsize
        else:
            scale_bytes = np.asarray(w).nbytes
        packed = self.packed
        return (packed.numel() if isinstance(packed, torch.Tensor)
                else int(np.asarray(packed).size)) + scale_bytes

    def dequantize(self, device: str | torch.device = "cpu") -> torch.Tensor:
        dt = torch_dtype(self.dtype)
        w_q = _as_tensor(self.w_q, device).to(dt)
        return self.ternary(device).to(dt) * w_q

    def to_bytes(self) -> bytes:
        """The framed single-tensor wire buffer (``comm.wire.encode_tensor``)."""
        from repro_torch.comm.wire import encode_tensor

        return encode_tensor(self)

    @classmethod
    def from_bytes(cls, data: bytes) -> "TernaryTensor":
        """Inverse of ``to_bytes`` (CRC-checked)."""
        from repro_torch.comm.wire import decode_tensor

        return decode_tensor(data)


def encode_ternary(i_t: torch.Tensor, w_q, dtype: str = "float32") -> TernaryTensor:
    """Wrap ternary codes + scale into wire format."""
    return TernaryTensor(packed=pack2bit(i_t), w_q=w_q,
                         shape=tuple(i_t.shape), dtype=dtype)


def decode_ternary(t: TernaryTensor, device: str | torch.device = "cpu") -> torch.Tensor:
    return t.dequantize(device)
