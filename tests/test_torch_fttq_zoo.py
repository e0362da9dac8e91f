"""``core.fttq.init_wq_tree`` and ``quantize_tree`` of the port against the
reference on every zoo family's parameter tree at the reduced configs:
stacked 3-D blocks, 4-D MoE expert stacks (L, E, d, f) with one factor per
layer, the vlm's cross stack and zamba2's unstacked shared block."""

import jax
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.core import fttq as jfttq
from repro.models import transformer as jtf
from repro_torch.convert import params_from_jax
from repro_torch.core import fttq
from repro_torch.tree import flatten_with_path

torch.set_num_threads(1)


def _jax_paths(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_paths(tree):
    return {"".join(f"[{k!r}]" for _, k in path): v.detach().numpy()
            for path, v in flatten_with_path(tree)}


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_fttq_trees_match_reference(arch):
    """w_q per quantizable leaf (one per layer of a stacked 3-D block, one
    per layer of a 4-D MoE expert stack (L, E, d, f), one per cross layer,
    a scalar for zamba2's unstacked shared block) within rtol 1e-6, the
    same ``None`` leaves, and the quantized tree's codes exact."""
    jcfg = JC.get_reduced(arch)
    jp = jax.jit(lambda k: jtf.init_params(jcfg, k))(jax.random.PRNGKey(0))
    cfg = jfttq.FTTQConfig()
    jwq = jax.jit(lambda p: jfttq.init_wq_tree(p, cfg))(jp)
    p = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    wq = fttq.init_wq_tree(p, fttq.FTTQConfig())
    want, got = _jax_paths(jwq), _port_paths(wq)
    assert want.keys() == got.keys() and want
    none_j = [x is None for x in jax.tree_util.tree_leaves(jwq, is_leaf=lambda x: x is None)]
    none_p = [x is None for x in _with_none(wq)]
    assert none_j == none_p
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        np.testing.assert_allclose(got[key], w, rtol=1e-6, err_msg=key)
    if jcfg.family == "moe":
        assert want["['blocks']['moe']['w_in']"].shape == (jcfg.n_layers, 1, 1, 1)
    jq = _jax_paths(jax.jit(lambda p, w: jfttq.quantize_tree(p, w, cfg))(jp, jwq))
    q = _port_paths(fttq.quantize_tree(p, wq, fttq.FTTQConfig()))
    assert jq.keys() == q.keys()
    for key in want:
        # equal codes: the same zero pattern and signs, scaled by w_q
        np.testing.assert_array_equal(np.sign(q[key]), np.sign(jq[key]), err_msg=key)
        np.testing.assert_allclose(q[key], jq[key], rtol=1e-6, err_msg=key)


def _with_none(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _with_none(tree[k])
    else:
        yield tree
