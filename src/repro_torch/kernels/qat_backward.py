"""The QAT backward's elementwise step: ``csrc/qat_backward.cu``, with an
fp32 entry (``qat_backward``) and a bf16 one (``qat_backward_bf16``).

Not a port of a TPU kernel. The reference's straight-through backward
(``repro.core.fttq._fttq_bwd``) is elementwise arithmetic that XLA fuses;
the port's ``core.fttq.FTTQQuantize.backward`` reaches XLA's results under
its subnormal rule (a subnormal cotangent read as zero, a product flushed by
its exact value) in several PyTorch ops a weight, which on the card cost
more passes over the weights than the step could spare. The kernel does
them in one: for a (L, m) fp32 cotangent g, the forward's codes I_t and
per row a flushed w_q and its cut (``dtypes.keep_cut``), it writes
g_θ = (g · s) · [|g| ≥ t] (s = w_q, t = the cut where I_t ≠ 0; s = 1,
t = 2^-126 elsewhere) and the flushed terms g · I_t of g_wq, which the
caller sums per row as before.

The bf16 entry does the same for a bf16 weight under XLA's bf16 multiply:
g · I_t with a subnormal result made +0, and g_θ = g · s (s = w_q where
I_t ≠ 0, else 1) from the flushed operands, its exact fp32 product flushed
and rounded once to bf16.

Bound on the H100: bytes — two reads and two writes of 4 B (fp32) or 2 B
(bf16) per weight.

Each entry dispatches on the tensors' device: the plain PyTorch version for
CPU tensors, the CUDA kernel for CUDA tensors of its dtype (or it raises).
``qat_backward.launches`` and ``qat_backward_bf16.launches`` count kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.dtypes import TINY, flush_plus, flushed_product

_THREADS = 256
_MAX_BLOCKS = 132 * 16
_MAX_Y = 65535


def qat_backward_plain(g: torch.Tensor, i_t: torch.Tensor, w: torch.Tensor, cut: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (g_θ, flushed g · I_t), each (L, m), from a
    (L, m) cotangent and codes and (L, 1) flushed w_q and cuts."""
    sel = i_t != 0
    return (flushed_product(g, torch.where(sel, w, 1.0), torch.where(sel, cut, TINY)),
            flush_plus(g * i_t))


def qat_backward_bf16_plain(g: torch.Tensor, i_t: torch.Tensor, w: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the bf16 entry, and the CPU's for any dtype
    but fp32: (g_θ, flushed g · I_t), each (L, m), from a (L, m) cotangent
    and codes and the (L, 1) w_q."""
    g_it = g * i_t
    if g_it.dtype == torch.bfloat16:
        g_it = flush_plus(g_it)
    scale = torch.where(i_t != 0, w if w.dtype == torch.bfloat16 else flush_plus(w), 1.0)
    return flushed_product(g, scale), g_it


def _lib(entry: str = "qat_backward_apply"):
    """The library's fp32 entry (g, I_t, w, cut in) or its bf16 one
    (``qat_backward_bf16_apply``: g, I_t, w in)."""
    from repro_torch.kernels import _build

    fn = getattr(_build.load("qat_backward"), entry)
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        inputs = [p, p, p] if entry == "qat_backward_bf16_apply" else [p, p, p, p]
        fn.argtypes = inputs + [ll, ll, i, p, p, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _grid(rows: int, m: int, per_thread: int) -> tuple[int, int]:
    y = min(rows, _MAX_Y)
    x = max(1, min(-(-max(m // per_thread, 1) // _THREADS), _MAX_BLOCKS // min(y, _MAX_BLOCKS)))
    return x, y


def qat_backward(g: torch.Tensor, i_t: torch.Tensor, w: torch.Tensor, cut: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(g_θ, flushed g · I_t) of a (L, m) fp32 cotangent ``g`` and codes
    ``i_t`` with (L, 1) fp32 ``w`` (flushed w_q) and ``cut``; see
    ``qat_backward_plain``."""
    if g.device.type == "cpu":
        return qat_backward_plain(g, i_t, w, cut)
    if g.device.type != "cuda":
        raise ValueError(f"qat_backward: unsupported device {g.device}")
    if g.dim() != 2 or i_t.shape != g.shape or w.shape != (g.shape[0], 1) \
            or cut.shape != w.shape:
        raise ValueError("qat_backward: takes (L, m) g and codes and (L, 1) w and cut")
    if any(t.dtype != torch.float32 for t in (g, i_t, w, cut)):
        raise TypeError("qat_backward kernel takes float32")
    g, i_t, w, cut = (t.contiguous() for t in (g, i_t, w, cut))
    g_theta, g_it = torch.empty_like(g), torch.empty_like(g)
    rows, m = g.shape
    if g.numel() == 0:
        return g_theta, g_it
    vec = int(m % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (g, i_t, g_theta, g_it)))
    x, y = _grid(rows, m, 4)
    fn = _lib()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = fn(g.data_ptr(), i_t.data_ptr(), w.data_ptr(), cut.data_ptr(), rows, m, vec,
                 g_theta.data_ptr(), g_it.data_ptr(), x, y, stream)
    if err != 0:
        raise RuntimeError(f"qat_backward kernel launch failed: CUDA error {err}")
    qat_backward.launches += 1
    return g_theta, g_it


qat_backward.launches = 0


def qat_backward_bf16(g: torch.Tensor, i_t: torch.Tensor, w: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(g_θ, flushed g · I_t) of a (L, m) bf16 cotangent ``g`` and codes
    ``i_t`` with the (L, 1) bf16 w_q ``w``; see ``qat_backward_bf16_plain``,
    which CPU tensors of any dtype take."""
    if g.device.type == "cpu":
        return qat_backward_bf16_plain(g, i_t, w)
    if g.device.type != "cuda":
        raise ValueError(f"qat_backward_bf16: unsupported device {g.device}")
    if g.dim() != 2 or i_t.shape != g.shape or w.shape != (g.shape[0], 1):
        raise ValueError("qat_backward_bf16: takes (L, m) g and codes and an (L, 1) w")
    if any(t.dtype != torch.bfloat16 for t in (g, i_t, w)):
        raise TypeError("qat_backward_bf16 kernel takes bfloat16")
    g, i_t, w = (t.contiguous() for t in (g, i_t, w))
    g_theta, g_it = torch.empty_like(g), torch.empty_like(g)
    rows, m = g.shape
    if g.numel() == 0:
        return g_theta, g_it
    vec = int(m % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in (g, i_t, g_theta, g_it)))
    x, y = _grid(rows, m, 8)
    fn = _lib("qat_backward_bf16_apply")
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = fn(g.data_ptr(), i_t.data_ptr(), w.data_ptr(), rows, m, vec,
                 g_theta.data_ptr(), g_it.data_ptr(), x, y, stream)
    if err != 0:
        raise RuntimeError(f"qat_backward_bf16 kernel launch failed: CUDA error {err}")
    qat_backward_bf16.launches += 1
    return g_theta, g_it


qat_backward_bf16.launches = 0
