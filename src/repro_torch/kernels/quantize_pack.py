"""Fused quantize→pack for client egress: ``csrc/quantize_pack.cu`` (fp32)
and ``csrc/quantize_pack_bf16.cu`` (bf16).

Replaces the TPU kernel ``repro/kernels/quantize_pack.py::_kernel``
(``quantize_pack_segments``). One pass over flat segments turns them into
wire bytes (4 consecutive flat codes per byte, ``core.ternary.pack2bit``
layout) and emits per-tile moments (Σ masked |θ_s|, selected count) from
which ``scale_from_moments`` forms the trained scale w_q.

``quantize_pack_segments`` encodes many segments in ONE launch, as the TPU
kernel did: a segment table in device memory (source address, element
count, byte offset, first tile; ``segment_table``) gives every block its
segment, each with its own (denom, Δ) row, and the kernel can also form
every segment's scale on the device. ``quantize_pack`` is the one-segment
case: a one-row table.

Segments are fp32 or bf16, one dtype per launch (the reference drives one
launch per dtype group). A bf16 segment is computed in bf16, as the
reference kernel computes in x's dtype: xs = x / denom rounded to bf16,
compared with Δ rounded to bf16, |xs| widened to fp32 for the moments. The
bf16 entry has a kernel of its own, which reaches the same codes without a
division (see its source).

Subnormals are treated as XLA treats them (``dtypes.flush_subnormal``): a
subnormal weight, denom or Δ enters the arithmetic as a zero of its sign,
and a subnormal quotient is flushed before the compare and the moments.

Bound on the H100: bytes — 4 B (fp32) or 2 B (bf16) read and 0.25 B written
per element. The TPU kernel read a staged transpose of the leaf
(``stage_encode``) so its pack was a sublane shuffle; the CUDA kernels read
each segment in place, so no staging copy is built. A moment tile is the
reference's 32,768 contiguous flat elements (``BLOCK_S · LANES``),
restarting at every segment: codes and counts match the reference exactly
and only the float sum's reduction order differs.

Both wrappers dispatch on the tensor's device: the plain PyTorch version for
a CPU tensor, the CUDA kernel for a CUDA tensor (or they raise). Both count
their launches of either kernel in ``quantize_pack.launches``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.ternary import packed_nbytes
from repro_torch.dtypes import flush_subnormal, flushed_op

TILE = 32768          # elements per moment tile (BLOCK_S · LANES of the TPU kernel)


def n_tiles(n_elements: int) -> int:
    return max(1, -(-n_elements // TILE))


def _scaled(x: torch.Tensor, scal: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """xs = x / denom in x's dtype, read flat, and Δ in x's dtype, as the
    reference kernel forms them under XLA's subnormal rule: denom and Δ are
    rounded to x's dtype and then flushed, x is flushed, the quotient is
    formed in fp32 (bf16 arithmetic runs in fp32) and flushed by its exact
    value (``dtypes.flushed_op``) before it is rounded to x's dtype."""
    dt = x.dtype
    wide = torch.promote_types(dt, torch.float32)
    denom = flush_subnormal(scal[0].to(dt)).to(wide)
    q = flushed_op(torch.div, x.reshape(-1).to(wide), denom)
    return q.to(dt), flush_subnormal(scal[1].to(dt))


def quantize_pack_plain(x: torch.Tensor, scal: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (``quantize_pack_ref`` + ``moments_ref``).

    x: any-shape float tensor, read flat. scal: (2,) fp32 (denom, Δ).
    Returns (wire bytes (packed_nbytes(n),) uint8, moments (G, 2) fp32)."""
    xs, d = _scaled(x, scal)
    n = xs.numel()
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
    xs, d = _scaled(x, scal)
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


@dataclasses.dataclass(frozen=True)
class SegmentLayout:
    """Where each of a run of segments lands: its wire bytes at
    ``byte_offsets[s]`` of one buffer of ``n_bytes``, its moment tiles from
    ``tile_starts[s]`` of ``n_tiles`` rows."""

    sizes: tuple
    byte_offsets: tuple
    tile_starts: tuple
    n_bytes: int
    n_tiles: int


def segment_layout(sizes: Sequence[int]) -> SegmentLayout:
    """Segments back to back: bytes packed_nbytes(n) each, tiles
    n_tiles(n) each."""
    offs, tiles, b, t = [], [], 0, 0
    for n in sizes:
        offs.append(b)
        tiles.append(t)
        b += packed_nbytes(n)
        t += n_tiles(n)
    return SegmentLayout(tuple(int(n) for n in sizes), tuple(offs), tuple(tiles), b, t)


def segment_table(segments: Sequence[torch.Tensor]) -> tuple[torch.Tensor, SegmentLayout]:
    """The kernel's segment table for ``segments`` (flat sources of one
    dtype on one device): an (S, 5) int64 tensor on that device, one row per segment
    (source address, element count, byte offset, first tile, done counter
    = 0), built on the host and copied once per launch."""
    lay = segment_layout([x.numel() for x in segments])
    rows = np.zeros((len(segments), 5), dtype=np.int64)
    rows[:, 0] = [x.data_ptr() for x in segments]
    rows[:, 1] = lay.sizes
    rows[:, 2] = lay.byte_offsets
    rows[:, 3] = lay.tile_starts
    return torch.from_numpy(rows).to(segments[0].device), lay


def quantize_pack_segments_plain(segments: Sequence[torch.Tensor], scal: torch.Tensor,
                                 with_scales: bool = False):
    """Plain PyTorch version: ``quantize_pack_plain`` per segment, bytes
    and moments back to back (``segment_layout``), and with ``with_scales``
    each segment's ``scale_from_moments`` with its denom. Returns (bytes,
    moments (G, 2), scales (S,) fp32 or None)."""
    parts = [quantize_pack_plain(x, scal[i]) for i, x in enumerate(segments)]
    dev = scal.device
    packed = (torch.cat([p for p, _ in parts]) if parts
              else torch.empty(0, dtype=torch.uint8, device=dev))
    moments = torch.cat([m for _, m in parts])
    scales = None
    if with_scales:
        scales = torch.stack([scale_from_moments(m, scal[i, 0])
                              for i, (_, m) in enumerate(parts)]).to(torch.float32)
    return packed, moments, scales


# the kernel library and entry of each segment dtype
_ENTRIES = {torch.float32: ("quantize_pack", "quantize_pack_f32"),
            torch.bfloat16: ("quantize_pack_bf16", "quantize_pack_bf16")}


def _lib(dtype: torch.dtype):
    from repro_torch.kernels import _build

    lib, entry = _ENTRIES[dtype]
    fn = getattr(_build.load(lib), entry)
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, i, p, p, p, p, ll, p]
        fn.restype = ctypes.c_int
    return fn


def _check_out(out, n_bytes: int, device) -> None:
    if out is not None and (out.dtype != torch.uint8 or not out.is_contiguous()
                            or out.numel() != n_bytes or out.device != device):
        raise ValueError("quantize_pack: out must be contiguous uint8 of "
                         f"{n_bytes} bytes on x's device")


def quantize_pack_segments(segments: Sequence[torch.Tensor], scal: torch.Tensor, *,
                           out: torch.Tensor | None = None, with_scales: bool = False):
    """Ternarize + pack many flat segments of one dtype (fp32 or bf16) in
    one launch; see ``quantize_pack_segments_plain``. scal: (S, 2) fp32
    (denom, Δ) rows on
    the segments' device. With ``out`` (contiguous uint8 of the layout's
    ``n_bytes``) the bytes land there. Returns (bytes, moments (G, 2),
    scales (S,) fp32 or None)."""
    if not segments:
        raise ValueError("quantize_pack_segments: no segments")
    dev = segments[0].device
    lay = segment_layout([x.numel() for x in segments])
    _check_out(out, lay.n_bytes, dev)
    if scal.shape != (len(segments), 2) or scal.device != dev:
        raise ValueError("quantize_pack: scal must be (S, 2) on the segments' device")
    if dev.type == "cpu":
        packed, moments, scales = quantize_pack_segments_plain(segments, scal, with_scales)
        if out is not None:
            packed = out.copy_(packed)
        return packed, moments, scales
    if dev.type != "cuda":
        raise ValueError(f"quantize_pack: unsupported device {dev}")
    dtype = segments[0].dtype
    if dtype not in _ENTRIES:
        raise TypeError(f"quantize_pack: segments must be float32 or bfloat16, got {dtype}")
    for x in segments:
        if x.device != dev or x.dtype != dtype or not x.is_contiguous():
            raise TypeError("quantize_pack: segments must be contiguous, of one dtype, on one "
                            "device")
    if scal.dtype != torch.float32:
        raise TypeError("quantize_pack: scal must be float32")
    table, _ = segment_table(segments)
    scal = scal.contiguous()
    packed = (torch.empty(lay.n_bytes, dtype=torch.uint8, device=dev) if out is None else out)
    moments = torch.empty((lay.n_tiles, 2), dtype=torch.float32, device=dev)
    scales = (torch.empty(len(segments), dtype=torch.float32, device=dev)
              if with_scales else None)
    fn = _lib(dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(table.data_ptr(), len(segments), scal.data_ptr(), packed.data_ptr(),
                 moments.data_ptr(), None if scales is None else scales.data_ptr(),
                 lay.n_tiles, stream)
    if err != 0:
        raise RuntimeError(f"quantize_pack kernel launch failed: CUDA error {err}")
    quantize_pack.launches += 1
    return packed, moments, scales


def quantize_pack(x: torch.Tensor, scal: torch.Tensor, out: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Ternarize + pack one leaf, read flat: ``quantize_pack_segments`` over
    one segment; see ``quantize_pack_plain``. scal: (2,) fp32 (denom, Δ).
    With ``out`` (a contiguous uint8 tensor of ``packed_nbytes(n)`` on x's
    device, e.g. a slice of a larger wire buffer) the bytes land there."""
    if scal.shape != (2,):
        raise ValueError("quantize_pack: scal must be a (2,) tensor")
    packed, moments, _ = quantize_pack_segments([x.reshape(-1)], scal.reshape(1, 2), out=out)
    return packed, moments


quantize_pack.launches = 0


def scale_from_moments(moments: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    """The Prop-4.1 trained scale in ORIGINAL units:
    (Σ masked |θ_s| / (count + 1e-8)) · denom, with the count summed as an
    integer first, as the reference does; a subnormal denom, quotient or
    scale is a zero, as XLA computes them (``dtypes.flushed_op``)."""
    num = moments[:, 0].sum()
    den = moments[:, 1].to(torch.int64).sum().to(torch.float32)
    return flushed_op(torch.mul, flushed_op(torch.div, num, den + 1e-8),
                      flush_subnormal(denom.to(torch.float32)))
