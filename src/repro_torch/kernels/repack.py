"""Wire → kernel-layout repack: serve ternary weights without dequantizing.

Port of ``repro.kernels.repack``. The wire packs 2-bit codes along the
flattened row-major order (4 consecutive flat elements per byte); the
matmul kernel wants the ``(K//4, N)`` layout, each byte holding 4
K-consecutive codes of one column. For aligned shapes (K and N multiples of
4, every transformer matmul in the repo) ``repack_to_kernel_layout``
converts by uint8 plane arithmetic on the host, never materializing
unpacked codes or a dense weight; the kernel-layout bytes then move to the
device once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.compression import decompress_pytree, is_wire_leaf
from repro_torch.core.ternary import TernaryTensor
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.dtypes import to_numpy
from repro_torch.kernels.ternary_matmul import ternary_matmul
from repro_torch.tree import tree_map


@dataclasses.dataclass
class PackedTernary:
    """A ternary weight in the ``(K//4, N)`` kernel layout.

    Fields:
      packed: uint8 ``(K//4, N)`` — or ``(L, K//4, N)`` for stacked layers.
      w_q:    fp32 scale tensor (0-d, or ``(L, 1, 1)`` stacked).
      k:      logical contraction dim BEFORE padding to a multiple of 4.
      dtype:  logical dtype name of the dequantized weight.
    """

    packed: torch.Tensor
    w_q: torch.Tensor
    k: int
    dtype: str = "float32"

    def layer(self, i: int) -> "PackedTernary":
        """The i-th layer of a stacked weight."""
        return PackedTernary(self.packed[i], self.w_q[i], self.k, self.dtype)


def _repack2d_aligned(flat: np.ndarray, k: int, n: int,
                      out: np.ndarray | None = None) -> np.ndarray:
    """Wire flat-packed bytes of a (k, n) leaf → (k//4, n) kernel bytes.

    Requires k % 4 == 0 and n % 4 == 0. The wire byte grid reshapes to
    (k//4, 4, n//4); plane j2 (shift 2·j2) holds the codes of output
    columns j2::4, which then pack along K."""
    b4 = flat[: k * n // 4].reshape(k // 4, 4, n // 4)
    if out is None:
        out = np.empty((k // 4, n), np.uint8)
    for j2 in range(4):
        plane = (b4 >> np.uint8(2 * j2)) & np.uint8(0x3)
        out[:, j2::4] = (
            plane[:, 0]
            | (plane[:, 1] << np.uint8(2))
            | (plane[:, 2] << np.uint8(4))
            | (plane[:, 3] << np.uint8(6))
        )
    return out


def _repack2d_fallback(t_packed: np.ndarray, k: int, n: int) -> np.ndarray:
    """Unaligned shapes: unpack to int8 codes, zero-pad K to a multiple of
    4, repack along K (materializes the (k, n) codes; off the serve path)."""
    shifts = np.arange(4, dtype=np.uint8) * 2
    codes = (t_packed[:, None] >> shifts) & 0x3
    it = codes.reshape(-1)[: k * n].astype(np.int8) - 1
    it = it.reshape(k, n)
    k_pad = (-k) % 4
    if k_pad:
        it = np.concatenate([it, np.zeros((k_pad, n), np.int8)])
    c = (it + 1).astype(np.uint8).reshape((k + k_pad) // 4, 4, n)
    return c[:, 0] | (c[:, 1] << np.uint8(2)) | (c[:, 2] << np.uint8(4)) | (
        c[:, 3] << np.uint8(6))


def _repack2d(flat: np.ndarray, k: int, n: int, out=None) -> np.ndarray:
    if k % 4 == 0 and n % 4 == 0:
        return _repack2d_aligned(flat, k, n, out)
    packed = _repack2d_fallback(flat, k, n)
    if out is not None:
        out[...] = packed
    return packed


def repack_to_kernel_layout(t: TernaryTensor,
                            device: str | torch.device = DEFAULT_DEVICE) -> PackedTernary:
    """A decoded wire ``TernaryTensor`` → ``PackedTernary`` on ``device``.

    2-D leaves become ``(K//4, N)``; stacked 3-D leaves ``(L, K, N)`` become
    ``(L, K//4, N)`` with an ``(L, 1, 1)`` scale (a shared scale is
    broadcast per layer). Higher-rank leaves are not matmul weights."""
    device = resolve_device(device)
    shape = tuple(int(s) for s in t.shape)
    buf = to_numpy(t.packed)
    w_q = t.w_q if isinstance(t.w_q, torch.Tensor) else torch.from_numpy(np.array(t.w_q))
    w_q = w_q.to(torch.float32)
    if len(shape) == 2:
        k, n = shape
        packed = _repack2d(buf, k, n)
        return PackedTernary(torch.from_numpy(packed).to(device),
                             w_q.reshape(()).to(device), k, t.dtype)
    if len(shape) == 3:
        l, k, n = shape
        if (k * n) % 4:
            raise ValueError(f"stacked leaf {shape}: per-layer segment not byte-aligned")
        seg = k * n // 4
        packed = np.empty((l, (k + 3) // 4, n), np.uint8)
        for i in range(l):
            _repack2d(buf[i * seg:(i + 1) * seg], k, n, packed[i])
        if w_q.numel() == 1:
            w_q = w_q.reshape(()).expand(l, 1, 1).contiguous()
        elif w_q.numel() == l:
            w_q = w_q.reshape(l, 1, 1)
        else:
            raise ValueError(
                f"stacked leaf {shape}: scale size {w_q.numel()} is neither "
                f"shared (1) nor per-layer ({l})"
            )
        return PackedTernary(torch.from_numpy(packed).to(device),
                             w_q.to(device), k, t.dtype)
    raise ValueError(f"cannot repack rank-{len(shape)} leaf {shape} for matmul")


def packed_matmul(x: torch.Tensor, w: PackedTernary) -> torch.Tensor:
    """x @ dequant(w) through the ternary matmul kernel. Leading dims of x
    flatten into M; x is zero-padded when the logical K was padded."""
    if w.packed.ndim != 2:
        raise ValueError(
            f"packed_matmul wants a per-layer (K//4, N) weight, got "
            f"{tuple(w.packed.shape)} — index the leading axis first"
        )
    *lead, k = x.shape
    if k != w.k:
        raise ValueError(f"x contraction dim {k} != weight logical K {w.k}")
    x2 = x.reshape(-1, k)
    k_pad = w.packed.shape[0] * 4
    if k_pad != k:
        x2 = torch.nn.functional.pad(x2, (0, k_pad - k))
    y = ternary_matmul(x2.contiguous(), w.packed, w.w_q.reshape(()))
    return y.reshape(*lead, y.shape[-1])


def packed_params_from_wire(tree, device: str | torch.device = DEFAULT_DEVICE):
    """Decoded wire tree → servable params on ``device``: ternary matmul
    weights become ``PackedTernary``; every other leaf decodes dense."""
    device = resolve_device(device)

    def one(leaf):
        if isinstance(leaf, TernaryTensor) and len(leaf.shape) in (2, 3):
            return repack_to_kernel_layout(leaf, device)
        return decompress_pytree(leaf, device)

    return tree_map(one, tree, is_leaf=is_wire_leaf)
