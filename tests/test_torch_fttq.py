"""Port vs reference: the FTTQ quantization-aware training quantizer
(``fttq_quantize`` forward codes, its straight-through backward), the
per-leaf factor tree ``init_wq_tree`` (one factor per leading index for
ndim ≥ 3, so an HWIO conv weight trains one per kernel row) and
``quantize_tree``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fttq as jfttq
from repro_torch.core import fttq
from repro_torch.tree import flatten_with_path, path_str

torch.set_num_threads(1)

# gradients: g_θ is an elementwise product (exact up to the w_q bits);
# g_wq sums up to ~2·10⁴ products in another order than XLA's
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-5


def _tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.normal(size=shape).astype(np.float32)

    return {
        "dense": {"w": normal(48, 40), "bias": normal(40)},
        "conv": {"w": normal(3, 3, 16, 8)},   # HWIO: 3 factors, one per kernel row
        "stack": {"w": normal(4, 24, 10)},    # stacked layers: 4 factors
        "norm": {"scale": normal(40)},
    }


def _jax_paths(tree) -> dict:
    return {jfttq._path_str(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_paths(tree) -> dict:
    return {path_str(p): x.detach().numpy() for p, x in flatten_with_path(tree)}


@pytest.mark.parametrize("rule", ["mean", "max"])
def test_init_wq_tree_matches_reference(rule):
    np_tree = _tree(0)
    cfg, jcfg = fttq.FTTQConfig(threshold_rule=rule), jfttq.FTTQConfig(threshold_rule=rule)
    ref = _jax_paths(jfttq.init_wq_tree(jax.tree_util.tree_map(jnp.asarray, np_tree), jcfg))
    got = _port_paths(fttq.init_wq_tree(
        {k: {n: torch.from_numpy(a) for n, a in v.items()} for k, v in np_tree.items()}, cfg))
    assert ref.keys() == got.keys() == {"dense/w", "conv/w", "stack/w"}
    assert got["conv/w"].shape == (3, 1, 1, 1) and got["stack/w"].shape == (4, 1, 1)
    assert got["dense/w"].shape == ()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)


def _torch_tree(np_tree):
    return {k: {n: torch.from_numpy(a.copy()) for n, a in v.items()} for k, v in np_tree.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_tree_forward_and_gradients_match_jax_grad(seed):
    """Same latent weights and factors: the QAT forward is bit-identical
    (codes times the same factor), and (g_θ, g_wq) from autograd match
    ``jax.grad`` of the reference through its custom VJP."""
    np_tree = _tree(seed)
    jcfg, cfg = jfttq.FTTQConfig(), fttq.FTTQConfig()
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    jwq = jfttq.init_wq_tree(jparams, jcfg)
    wq_np = jax.tree_util.tree_map(np.asarray, jwq)
    rng = np.random.default_rng(100 + seed)
    upstream = jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                                      np_tree)

    def jloss(p, w):
        q = jfttq.quantize_tree(p, w, jcfg)
        return sum(jnp.sum(a * b) for a, b in zip(jax.tree_util.tree_leaves(q),
                                                  jax.tree_util.tree_leaves(upstream)))

    jq = _jax_paths(jfttq.quantize_tree(jparams, jwq, jcfg))
    jg_p, jg_w = jax.grad(jloss, argnums=(0, 1))(jparams, jwq)

    params = _torch_tree(np_tree)
    for v in params.values():
        for t in v.values():
            t.requires_grad_(True)
    wq = {k: ({"w": torch.from_numpy(np.array(v["w"])).requires_grad_(True)}
              if v is not None and v.get("w") is not None else None)
          for k, v in wq_np.items()}
    q = fttq.quantize_tree(params, wq, cfg)
    got_q = _port_paths(q)
    assert jq.keys() == got_q.keys()
    for k in jq:
        np.testing.assert_array_equal(got_q[k], jq[k], err_msg=k)
    up = {k: {n: torch.from_numpy(a) for n, a in v.items()} for k, v in upstream.items()}
    loss = sum((a * b).sum() for (_, a), (_, b) in zip(flatten_with_path(q),
                                                      flatten_with_path(up)))
    loss.backward()
    g_p = {path_str(p): t.grad.numpy() for p, t in flatten_with_path(params)}
    g_w = {path_str(p): t.grad.numpy() for p, t in flatten_with_path(wq)}
    ref_gp, ref_gw = _jax_paths(jg_p), _jax_paths(jg_w)
    for k in ref_gp:
        np.testing.assert_allclose(g_p[k], ref_gp[k], rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)
    assert ref_gw.keys() == g_w.keys()
    for k in ref_gw:
        assert g_w[k].shape == ref_gw[k].shape
        np.testing.assert_allclose(g_w[k], ref_gw[k], rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize("rule", ["mean", "max"])
def test_qat_forward_ignores_the_threshold_rule(rule):
    """The reference's QAT forward thresholds with eq. (8) whatever
    ``threshold_rule`` says; the port's does too."""
    theta = np.random.default_rng(5).normal(size=(30, 20)).astype(np.float32)
    w = np.float32(0.3)
    ref = np.asarray(jfttq.quantize_tree(
        {"w": jnp.asarray(theta)}, {"w": jnp.asarray(w)},
        jfttq.FTTQConfig(threshold_rule=rule))["w"])
    got = fttq.quantize_tree({"w": torch.from_numpy(theta)}, {"w": torch.tensor(w)},
                             fttq.FTTQConfig(threshold_rule=rule))["w"]
    np.testing.assert_array_equal(got.numpy(), ref)
    codes = fttq.ternarize(fttq.scale_layer(torch.from_numpy(theta)),
                           fttq.fttq_threshold(fttq.scale_layer(torch.from_numpy(theta)), 0.7))
    np.testing.assert_array_equal(got.numpy(), (codes * w).numpy())


def test_fttq_quantize_whole_leaf_backward():
    """g_wq = Σ g·I_t; g_θ = g·w_q on quantized positions, g elsewhere."""
    theta = torch.randn(16, 12, generator=torch.Generator().manual_seed(0), requires_grad=True)
    w = torch.tensor(0.5, requires_grad=True)
    out = fttq.fttq_quantize(theta, w, 0.7)
    g = torch.randn(16, 12, generator=torch.Generator().manual_seed(1))
    out.backward(g)
    i_t = (out / 0.5).detach()
    assert set(i_t.unique().tolist()) <= {-1.0, 0.0, 1.0}
    torch.testing.assert_close(w.grad, (g * i_t).sum())
    torch.testing.assert_close(theta.grad, torch.where(i_t != 0, g * 0.5, g))


@pytest.mark.parametrize("rule", ["mean", "max"])
def test_ternary_stats_matches_reference(rule):
    """Parameter counts exact; the zero-code share within one code per
    leaf (Δ comes from a mean summed in another order than XLA's)."""
    np_tree = _tree(3)
    cfg, jcfg = fttq.FTTQConfig(threshold_rule=rule), jfttq.FTTQConfig(threshold_rule=rule)
    ref = jfttq.ternary_stats(jax.tree_util.tree_map(jnp.asarray, np_tree), jcfg)
    got = fttq.ternary_stats(jax.tree_util.tree_map(torch.from_numpy, np_tree), cfg)
    assert got.keys() == ref.keys()
    for key in ("total_params", "quantized_params", "quantized_fraction"):
        assert got[key] == ref[key], key
    assert abs(got["ternary_sparsity"] - ref["ternary_sparsity"]) * got["quantized_params"] <= 3
    assert 0.0 < got["ternary_sparsity"] < 1.0
    assert fttq.ternary_stats({"norm": {"scale": torch.ones(3)}}, cfg) == jfttq.ternary_stats(
        {"norm": {"scale": jnp.ones(3)}}, jcfg)
