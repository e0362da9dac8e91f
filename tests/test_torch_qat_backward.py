"""The QAT backward's elementwise step (``kernels.qat_backward``), whose
plain version runs here, against XLA's arithmetic for the reference's
straight-through backward (``repro.core.fttq._fttq_bwd``): g · where(I_t ≠
0, w_q, 1) and the terms g · I_t of g_wq, bit for bit, on rows whose
cotangents hold every fp32 pattern of a seeded sample, subnormals, the
products that fall in the window below 2^-126, NaN and ±inf, with codes of
both signs, zeros of both signs and NaN, at factors below, at and above 1,
a subnormal one (flushed to a zero) and 2^100."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_subnormal_cases import qat_backward_rows
from repro_torch.core.fttq import backward_cuts
from repro_torch.dtypes import flush_plus
from repro_torch.kernels.qat_backward import qat_backward, qat_backward_plain

torch.set_num_threads(1)


def _xla(g, codes, w):
    jg, jc = jnp.asarray(g), jnp.asarray(codes)
    jw = jnp.asarray(w).reshape(-1, 1)
    g_theta = jg * jnp.where(jc != 0, jw, jnp.ones_like(jw))
    return np.asarray(g_theta), np.asarray(jg * jc)


def _bits_or_nan(got, want, what):
    g, w = got.numpy(), np.asarray(want)
    same = (g.view(np.uint32) == w.view(np.uint32)) | (np.isnan(g) & np.isnan(w))
    assert same.all(), f"{what}: {int((~same).sum())} of {same.size} differ"


def test_plain_version_is_xla_arithmetic():
    """g_θ and g·I_t bit for bit against XLA's (NaNs as NaNs), the flushed
    factor's products included; g·I_t's flushed zeros are +0 where XLA's
    keep the product's sign (its sum cannot tell them apart)."""
    g, codes, w = qat_backward_rows()
    tw = torch.from_numpy(w).reshape(-1, 1)
    wf = flush_plus(tw)
    (cut,) = backward_cuts([tw])
    g_theta, g_it = qat_backward(torch.from_numpy(g), torch.from_numpy(codes), wf, cut)
    want_theta, want_it = _xla(g, codes, w)
    zero = (want_theta == 0) & (g_theta.numpy() == 0)
    _bits_or_nan(g_theta[torch.from_numpy(~zero)], want_theta[~zero], "g_θ")
    nz = want_it != 0
    _bits_or_nan(g_it[torch.from_numpy(nz | np.isnan(want_it))],
                 want_it[nz | np.isnan(want_it)], "g·I_t")
    assert (g_it.numpy()[(want_it == 0)] == 0).all()


@pytest.mark.parametrize("shape", [(1, 37), (3, 8), (16, 64)])
def test_wrapper_on_the_cpu_is_its_plain_version(shape):
    """On CPU tensors the wrapper is the plain version, at row lengths that
    do and do not divide by 4, and it launches nothing."""
    rng = np.random.default_rng(shape[1])
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    codes = torch.from_numpy(rng.choice(np.array([1.0, -1.0, 0.0], np.float32), size=shape))
    w = torch.from_numpy(np.abs(rng.normal(size=(shape[0], 1))).astype(np.float32))
    (cut,) = backward_cuts([w])
    before = qat_backward.launches
    got = qat_backward(g, codes, w, cut)
    want = qat_backward_plain(g, codes, w, cut)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert qat_backward.launches == before


def _bf16_rows():
    """Every bf16 bit pattern of g in each of 20 rows whose codes are all
    +1, −1, +0, −0 or NaN, at the factors 0.37, 1, 2^100 and a subnormal
    one, as bf16 numpy bits: (g, codes, w)."""
    import ml_dtypes

    g = np.tile(np.arange(1 << 16, dtype=np.uint16).view(ml_dtypes.bfloat16), (20, 1))
    codes = np.array([1.0, -1.0, 0.0, -0.0, np.nan], np.float32).astype(ml_dtypes.bfloat16)
    c = np.repeat(codes, 4)[:, None] * np.ones((1, g.shape[1]), ml_dtypes.bfloat16)
    w = np.tile(np.array([0.37, 1.0, 2.0 ** 100, 3e-39], np.float32), 5).astype(
        ml_dtypes.bfloat16)
    return g, c.astype(ml_dtypes.bfloat16), w


def _t16(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)


def test_bf16_plain_version_is_xla_arithmetic():
    """The bf16 entry's plain version against XLA's bf16 arithmetic for
    ``_fttq_bwd`` (g · where(I_t ≠ 0, w_q, 1) and g · I_t): bit for bit on
    every bf16 pattern of g, NaNs as NaNs, but where XLA's g · I_t is a
    zero or subnormal: the plain version's +0 (a sum cannot tell them
    apart)."""
    from repro_torch.kernels.qat_backward import qat_backward_bf16

    g, c, w = _bf16_rows()
    jg, jc, jw = jnp.asarray(g), jnp.asarray(c), jnp.asarray(w).reshape(-1, 1)
    want_theta = np.asarray(jg * jnp.where(jc != 0, jw, jnp.ones_like(jw)))
    want_it = np.asarray(jg * jc)
    g_theta, g_it = qat_backward_bf16(_t16(g), _t16(c), _t16(w).reshape(-1, 1))
    assert g_theta.dtype == g_it.dtype == torch.bfloat16

    def check(got, want, keep, what):
        got = got.view(torch.int16).numpy().view(np.uint16)[keep]
        nan = np.isnan(want.astype(np.float32))[keep]
        same = (got == want.view(np.uint16)[keep]) | (nan & ((got & 0x7FFF) > 0x7F80))
        assert same.all(), f"{what}: {int((~same).sum())} differ"

    check(g_theta, want_theta, np.ones(g.shape, bool), "g_θ")
    tiny = np.abs(want_it.astype(np.float32)) < 2.0 ** -126
    check(g_it, want_it, ~tiny, "g·I_t")
    assert (g_it.view(torch.int16).numpy()[tiny] == 0).all()


@pytest.mark.parametrize("shape", [(1, 37), (3, 8), (16, 64)])
def test_bf16_wrapper_on_the_cpu_is_its_plain_version(shape):
    """On CPU tensors the bf16 entry is its plain version and launches
    nothing."""
    from repro_torch.kernels.qat_backward import qat_backward_bf16, qat_backward_bf16_plain

    rng = np.random.default_rng(shape[1])
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16()
    codes = torch.from_numpy(rng.choice(np.array([1.0, -1.0, 0.0], np.float32),
                                        size=shape)).bfloat16()
    w = torch.from_numpy(np.abs(rng.normal(size=(shape[0], 1))).astype(np.float32)).bfloat16()
    before = qat_backward_bf16.launches
    for a, b in zip(qat_backward_bf16(g, codes, w), qat_backward_bf16_plain(g, codes, w)):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert qat_backward_bf16.launches == before
