"""Port vs reference: the Mamba2 block's functions — the causal conv, the
segment sums, the chunked SSD scan (a length that is not a multiple of the
chunk included), the one-token decode update, softplus, and the block with
and without a cache — within 1e-5; and a decode chained over a prompt
against the chunked prefill of it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as jmb
from repro_torch.convert import params_from_jax
from repro_torch.models import mamba2 as mb

torch.set_num_threads(1)

TOL = 1e-5
D, H, N, EXPAND, W = 32, 4, 8, 2, 4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 6)).astype(np.float32)
    w = rng.normal(size=(W, 6)).astype(np.float32)
    st = rng.normal(size=(2, W - 1, 6)).astype(np.float32) if with_state else None
    wy, wst = jmb._causal_conv(jnp.asarray(x), jnp.asarray(w),
                               None if st is None else jnp.asarray(st))
    y, new = mb._causal_conv(_t(x), _t(w), None if st is None else _t(st))
    np.testing.assert_array_equal(y.numpy(), np.asarray(wy))
    np.testing.assert_array_equal(new.numpy(), np.asarray(wst))


def test_segsum_matches_reference():
    a = -np.abs(np.random.default_rng(1).normal(size=(2, 3, 6)).astype(np.float32))
    want = np.asarray(jmb._segsum(jnp.asarray(a)))
    got = mb._segsum(_t(a)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=TOL, atol=TOL)


def _ssd_inputs(l, seed=2, bsz=2, p=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bsz, l, H, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(bsz, l, H)))).astype(np.float32)
    a = -np.exp(rng.normal(size=(H,)) * 0.3).astype(np.float32)
    b = rng.normal(size=(bsz, l, N)).astype(np.float32)
    c = rng.normal(size=(bsz, l, N)).astype(np.float32)
    return x, dt, a, b, c


@pytest.mark.parametrize("l,chunk", [(16, 4), (13, 4), (5, 8), (12, 12)])
def test_ssd_chunked_matches_reference(l, chunk):
    args = _ssd_inputs(l)
    wy, wh = jmb.ssd_chunked(*map(jnp.asarray, args), chunk)
    y, h = mb.ssd_chunked(*map(_t, args), chunk)
    assert y.dtype == h.dtype == torch.float32
    _close(y, wy)
    _close(h, wh)


def test_ssd_result_does_not_depend_on_the_chunk():
    """The inter-chunk recurrence: 24 tokens in 6, 3 or 1 chunks."""
    args = list(map(_t, _ssd_inputs(24, seed=5)))
    y1, h1 = mb.ssd_chunked(*args, 24)
    for chunk in (4, 8):
        y, h = mb.ssd_chunked(*args, chunk)
        _close(y, y1.numpy(), 1e-4)
        _close(h, h1.numpy(), 1e-4)


def test_ssd_decode_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, H, 3)).astype(np.float32)
    dt = np.abs(rng.normal(size=(2, H))).astype(np.float32)
    a = -np.abs(rng.normal(size=(H,))).astype(np.float32)
    b, c = (rng.normal(size=(2, N)).astype(np.float32) for _ in range(2))
    st = rng.normal(size=(2, H, 3, N)).astype(np.float32)
    wy, wst = jmb.ssd_decode(*map(jnp.asarray, (x, dt, a, b, c, st)))
    y, new = mb.ssd_decode(*map(_t, (x, dt, a, b, c, st)))
    _close(y, wy)
    _close(new, wst)


def test_softplus_is_jax_softplus_above_20():
    x = np.array([-80.0, -20.0, -1.0, 0.0, 0.5, 19.9, 20.0, 20.5, 30.0, 90.0], np.float32)
    np.testing.assert_allclose(mb.softplus(_t(x)).numpy(), np.asarray(jax.nn.softplus(x)),
                               rtol=1e-7, atol=1e-7)


def _block_params(seed):
    jp = jmb.init_mamba(jax.random.PRNGKey(seed), D, H, N, EXPAND, W, jnp.float32)
    # non-trivial a_log, dt_bias and d_skip (init gives 0, 0 and 1)
    rng = np.random.default_rng(seed)
    for key in ("a_log", "dt_bias", "d_skip"):
        jp[key] = jnp.asarray(rng.normal(size=(H,)).astype(np.float32) * 0.5)
    jp["gate_norm"] = jnp.asarray(rng.normal(size=jp["gate_norm"].shape).astype(np.float32)
                                  * 0.1)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


KW = dict(n_heads=H, d_state=N, expand=EXPAND, conv_width=W)


@pytest.mark.parametrize("l,chunk", [(12, 4), (10, 4)])
def test_mamba_block_matches_reference(l, chunk):
    jp, p = _block_params(4)
    x = np.random.default_rng(5).normal(size=(2, l, D)).astype(np.float32)
    want, wc = jmb.mamba_block(jp, jnp.asarray(x), chunk=chunk, **KW)
    got, c = mb.mamba_block(p, _t(x), chunk=chunk, **KW)
    _close(got, want)
    _close(c["conv"], wc["conv"])
    _close(c["ssd"], wc["ssd"])


def test_mamba_block_decode_matches_reference_and_the_prefill():
    """Each one-token step with a cache against the reference's step, and
    the chain of 10 steps against the chunked prefill of the 10 tokens."""
    jp, p = _block_params(6)
    x = np.random.default_rng(7).normal(size=(2, 10, D)).astype(np.float32)
    d_in = EXPAND * D
    conv = np.zeros((2, W - 1, d_in + 2 * N), np.float32)
    ssd = np.zeros((2, H, d_in // H, N), np.float32)
    jcache = {"conv": jnp.asarray(conv), "ssd": jnp.asarray(ssd)}
    cache = {"conv": _t(conv), "ssd": _t(ssd)}
    outs = []
    for t in range(10):
        wo, jcache = jmb.mamba_block(jp, jnp.asarray(x[:, t:t + 1]), chunk=4, cache=jcache,
                                     **KW)
        o, cache = mb.mamba_block(p, _t(x[:, t:t + 1]), chunk=4, cache=cache, **KW)
        _close(o, wo)
        _close(cache["ssd"], jcache["ssd"])
        outs.append(o)
    full, fc = mb.mamba_block(p, _t(x), chunk=4, **KW)
    _close(torch.cat(outs, dim=1), full.numpy(), 1e-4)
    _close(cache["ssd"], fc["ssd"].numpy(), 1e-4)
    _close(cache["conv"], fc["conv"].numpy())   # in_proj rows at M = 2 vs M = 20
