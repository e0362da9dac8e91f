"""Port vs reference: the MoE layer on one device — routing (ties to the
lower expert index, as ``jax.lax.top_k``), the capacity and the rank of
each copy in its expert's queue (exact), and the layer's output and Switch
aux loss (within 1e-5 and 1e-6) with and without capacity drops, shared
experts and tied router probabilities."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.convert import params_from_jax
from repro_torch.models import moe

torch.set_num_threads(1)

D, F, E = 32, 16, 8


def _params(seed, n_shared=0, tie=False):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), D, F, E, n_shared, 2 * F, jnp.float32)
    if tie:   # experts 2k and 2k+1 get the same router column, not the same weights
        r = np.asarray(jp["router"]).copy()
        r[:, 1::2] = r[:, 0::2]
        jp["router"] = jnp.asarray(r)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _x(seed, b=2, s=12):
    return np.random.default_rng(seed).normal(size=(b, s, D)).astype(np.float32)


def test_route_ties_keep_the_lower_index():
    rng = np.random.default_rng(0)
    probs = rng.integers(0, 4, size=(64, E)).astype(np.float32) / 8.0   # many ties
    probs[0] = 0.25
    for k in (1, 2, 3, 8):
        wg, wi = jax.lax.top_k(jnp.asarray(probs), k)
        g, i = moe.route(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(g.numpy(), np.asarray(wg))


@pytest.mark.parametrize("t,k,e,cf", [(24, 2, 8, 1.25), (24, 2, 8, 0.25), (1, 8, 128, 1.25),
                                      (4096, 8, 128, 1.25), (1000, 6, 64, 1.0),
                                      (128, 8, 128, 16.0)])
def test_capacity_and_ranks_match_reference(t, k, e, cf):
    """The capacity is the reference's expression (rounded up to 256 from
    256 on); each copy's slot and keep flag equal the reference's cumsum
    over the one-hot routing."""
    capacity = max(int(t * k / e * cf), k)
    if capacity >= 256:
        capacity = -(-capacity // 256) * 256
    assert moe.capacity_of(t, k, e, cf) == capacity
    idx = np.random.default_rng(t).integers(0, e, size=(t, k))
    flat = jnp.asarray(idx).reshape(-1)
    onehot = jax.nn.one_hot(flat, e, dtype=jnp.int32)
    want_pos = jnp.sum((jnp.cumsum(onehot, axis=0) - 1) * onehot, axis=-1)
    flat_e, pos, keep = moe.dispatch(torch.from_numpy(idx), e, capacity)
    np.testing.assert_array_equal(flat_e.numpy(), np.asarray(flat))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want_pos < capacity))


CASES = {
    "plain": dict(top_k=2, capacity_factor=1.25),
    "drops": dict(top_k=2, capacity_factor=0.25),
    "shared": dict(top_k=2, capacity_factor=1.25, n_shared=2),
    "tied_top1": dict(top_k=1, capacity_factor=4.0, tie=True),
    "tied_top3_drops": dict(top_k=3, capacity_factor=0.5, tie=True, n_shared=1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_matches_reference(case):
    kw = dict(CASES[case])
    jp, p = _params(len(case), kw.pop("n_shared", 0), kw.pop("tie", False))
    x = _x(len(case) + 1)
    want, waux = jmoe.moe(jp, jnp.asarray(x), activation="silu", **kw)
    got, aux = moe.moe(p, torch.from_numpy(x), activation="silu", **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert aux.dtype == torch.float32
    assert abs(float(aux) - float(waux)) <= 1e-6
    if case == "drops":   # the case drops copies: some token gets less than its k
        t = x.shape[0] * x.shape[1]
        assert moe.capacity_of(t, 2, E, 0.25) < t * 2 // E


def test_tied_router_decides_by_the_lower_index():
    """With top-1 routing and tied router columns, taking the higher expert
    of a tied pair gives another output: the parity above rests on the
    tie order, not on luck."""
    jp, p = _params(3, tie=True)
    x = torch.from_numpy(_x(4))
    got, _ = moe.moe(p, x, top_k=1, capacity_factor=4.0)
    swapped = dict(p)
    for key in ("w_in", "w_gate", "w_out"):
        w = p[key].clone()
        w[0::2], w[1::2] = p[key][1::2], p[key][0::2]
        swapped[key] = w
    other, _ = moe.moe(swapped, x, top_k=1, capacity_factor=4.0)
    assert float((other - got).abs().max()) > 1e-3
