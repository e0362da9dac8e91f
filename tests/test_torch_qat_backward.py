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
