"""Fused quantize→pack for client egress: ``csrc/quantize_pack.cu``.

Replaces the TPU kernel ``repro/kernels/quantize_pack.py::_kernel``
(``quantize_pack_segments``). One pass over a flat leaf turns it into wire
bytes (4 consecutive flat codes per byte, ``core.ternary.pack2bit`` layout)
and emits per-tile moments (Σ masked |θ_s|, selected count) from which
``scale_from_moments`` forms the trained scale w_q.

Bound on the H100: bytes — 4 B read and 0.25 B written per fp32 element.
The TPU kernel read a staged transpose of the leaf (``stage_encode``) so its
pack was a sublane shuffle; the CUDA kernel reads the leaf in place, one
float4 per thread and one wire byte out, so no staging copy is built. A
moment tile is the reference's 32,768 contiguous flat elements
(``BLOCK_S · LANES``): codes and counts match the reference exactly and only
the float sum's reduction order differs.

``quantize_pack`` dispatches on the tensor's device: the plain PyTorch
version for a CPU tensor, the CUDA kernel for a CUDA tensor (or it raises).
``quantize_pack.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.ternary import packed_nbytes

TILE = 32768          # elements per moment tile (BLOCK_S · LANES of the TPU kernel)


def n_tiles(n_elements: int) -> int:
    return max(1, -(-n_elements // TILE))


def quantize_pack_plain(x: torch.Tensor, scal: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (``quantize_pack_ref`` + ``moments_ref``).

    x: any-shape float tensor, read flat. scal: (2,) fp32 (denom, Δ).
    Returns (wire bytes (packed_nbytes(n),) uint8, moments (G, 2) fp32)."""
    flat = x.reshape(-1)
    n = flat.numel()
    xs = flat / scal[0].to(x.dtype)
    d = scal[1].to(x.dtype)
    pos, neg = xs > d, xs < -d
    codes = (1 + pos.to(torch.uint8) - neg.to(torch.uint8))
    pad = (-n) % 4
    if pad:
        codes = torch.cat([codes, codes.new_ones(pad)])
    c = codes.reshape(-1, 4)
    packed = c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)
    return packed, _tile_moments(xs, pos | neg)


def moments_plain(x: torch.Tensor, scal: torch.Tensor) -> torch.Tensor:
    """The tile moments alone (the reference's ``moments_ref``): (G, 2)
    fp32 per-tile [Σ masked |θ_s|, selected count]."""
    xs = x.reshape(-1) / scal[0].to(x.dtype)
    d = scal[1].to(x.dtype)
    return _tile_moments(xs, (xs > d) | (xs < -d))


def _tile_moments(xs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    n = xs.numel()
    g = n_tiles(n)
    a = torch.zeros(g * TILE, dtype=torch.float32, device=xs.device)
    a[:n] = torch.where(mask, xs.abs().to(torch.float32), 0.0)
    cnt = torch.zeros(g * TILE, dtype=torch.int32, device=xs.device)
    cnt[:n] = mask.to(torch.int32)
    return torch.stack(
        [a.reshape(g, TILE).sum(1), cnt.reshape(g, TILE).sum(1).to(torch.float32)],
        dim=1,
    )


def _lib():
    from repro_torch.kernels import _build

    lib = _build.load("quantize_pack")
    fn = lib.quantize_pack_f32
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_longlong, p, p, p, ctypes.c_longlong,
                       ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def quantize_pack(x: torch.Tensor, scal: torch.Tensor, out: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Ternarize + pack one flat leaf; see ``quantize_pack_plain``. With
    ``out`` (a contiguous uint8 tensor of ``packed_nbytes(n)`` on x's
    device, e.g. a slice of a larger wire buffer) the bytes land there."""
    n = x.numel()
    if out is not None and (out.dtype != torch.uint8 or not out.is_contiguous()
                            or out.numel() != packed_nbytes(n) or out.device != x.device):
        raise ValueError("quantize_pack: out must be contiguous uint8 of "
                         f"{packed_nbytes(n)} bytes on x's device")
    if x.device.type == "cpu":
        packed, moments = quantize_pack_plain(x, scal)
        if out is not None:
            packed = out.copy_(packed)
        return packed, moments
    if x.device.type != "cuda":
        raise ValueError(f"quantize_pack: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"quantize_pack kernel takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("quantize_pack: x must be contiguous")
    if scal.device != x.device or scal.dtype != torch.float32 or scal.shape != (2,):
        raise ValueError("quantize_pack: scal must be a (2,) float32 tensor on x's device")
    scal = scal.contiguous()
    g = n_tiles(n)
    packed = (torch.empty(packed_nbytes(n), dtype=torch.uint8, device=x.device)
              if out is None else out)
    moments = torch.empty((g, 2), dtype=torch.float32, device=x.device)
    vec = int(x.data_ptr() % 16 == 0)
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), n, scal.data_ptr(), packed.data_ptr(),
                 moments.data_ptr(), g, vec, stream)
    if err != 0:
        raise RuntimeError(f"quantize_pack kernel launch failed: CUDA error {err}")
    quantize_pack.launches += 1
    return packed, moments


quantize_pack.launches = 0


def scale_from_moments(moments: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    """The Prop-4.1 trained scale in ORIGINAL units:
    (Σ masked |θ_s| / (count + 1e-8)) · denom, with the count summed as an
    integer first, as the reference does."""
    num = moments[:, 0].sum()
    den = moments[:, 1].to(torch.int64).sum().to(torch.float32)
    return num / (den + 1e-8) * denom
