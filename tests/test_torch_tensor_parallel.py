"""Tensor parallelism over the mesh's "model" axis (``parallel.tensor``), on
two ``gloo`` CPU ranks: the conjugate autograd functions, the shard and
gather round trips, FTTQ's whole-leaf statistics on shards, the global
norm, the vocab-parallel cross entropy, and the moe, ssm and hybrid
families stepping under a "model" axis. Each shard-side result is held to
the port's one-device function on the whole leaves, which the other test
files hold to the reference."""

import numpy as np
import pytest

from _torch_dist import run_ranks


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks("tp_basics", 2, tmp_path_factory.mktemp("tp"), timeout=120)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [] if tree is None else [np.asarray(tree)]


def test_conjugate_functions(ranks):
    """Exact: copy_to_model is the identity forward and sums the ranks'
    gradients backward; reduce_from_model sums forward and passes the
    gradient; gather_from_model concatenates forward and keeps this rank's
    slice backward; scatter_to_model is the reverse."""
    x = [np.arange(6.0).reshape(2, 3) + 10 * r for r in range(2)]
    g = [np.full((2, 3), r + 1.0) for r in range(2)]
    wide = np.arange(12.0).reshape(2, 6)
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["copy"][0], x[r])
        np.testing.assert_array_equal(out["copy"][1], g[0] + g[1])
        np.testing.assert_array_equal(out["reduce"][0], x[0] + x[1])
        np.testing.assert_array_equal(out["reduce"][1], g[r])
        np.testing.assert_array_equal(out["gather"][0], np.concatenate(x, axis=1))
        np.testing.assert_array_equal(out["gather"][1], wide[:, 3 * r:3 * r + 3])
        np.testing.assert_array_equal(out["scatter"][0], wide[:, 3 * r:3 * r + 3])
        np.testing.assert_array_equal(out["scatter"][1], np.concatenate(g, axis=1))


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-20b"])
def test_shard_and_gather_round_trip(ranks, arch):
    """shard_tree then gather_tree gives the whole params back bit for bit,
    and shard_state then gather_state a whole TrainState (params, Adam's
    moments, residuals with their pod dim); the shards have
    ``param_shapes(cfg, mesh)``: vocab rows, attention and MLP columns (wo
    and w_out rows) halved, granite's MQA wk/wv split mid-head."""
    for out in ranks:
        t = out["trees"][arch]
        assert t["round_trip"] and t["state_round_trip"] and t["local_shapes"]
    shapes = ranks[0]["trees"][arch]["shard_shapes"]
    assert shapes["embed/table"] == ({"olmo-1b": 64, "granite-20b": 64}[arch], 64)
    assert shapes["blocks/attn/wq"][-1] == 32 and shapes["blocks/attn/wo"][-2] == 32
    assert shapes["blocks/mlp/w_in"][-1] == 128 and shapes["blocks/mlp/w_out"][-2] == 128
    assert shapes["blocks/attn/wk"][-1] == {"olmo-1b": 32, "granite-20b": 8}[arch]


def test_fttq_on_shards_uses_whole_leaf_statistics(ranks):
    """The QAT forward on shards equals the whole leaves' bit for bit
    (codes and w_q · I_t); the STE backward's g_θ and the shards' summed
    g_wq within 1e-6 of each leaf's largest; init_wq_tree within rtol
    1e-6; ternary_stats' counts exact; the global norm within rtol 1e-6."""
    for out in ranks:
        f = out["fttq"]
        for a, b in zip(_leaves(f["q"][0]), _leaves(f["q"][1])):
            np.testing.assert_array_equal(a, b)
        for key in ("g_theta", "g_wq"):
            for a, b in zip(_leaves(f[key][0]), _leaves(f[key][1])):
                assert np.abs(a - b).max() <= 1e-6 * max(np.abs(a).max(), 1e-30), key
        for a, b in zip(_leaves(f["init_wq"][0]), _leaves(f["init_wq"][1])):
            np.testing.assert_allclose(b, a, rtol=1e-6)
        whole, shard = f["stats"]
        assert whole == shard
        np.testing.assert_allclose(f["norm"][1], f["norm"][0], rtol=1e-6)


def test_vocab_parallel_cross_entropy(ranks):
    """The vocab-parallel CE over two halves of V = 128 against the fp32
    log-softmax one: loss within rtol 1e-6, the gradient within 1e-6 of its
    largest."""
    for out in ranks:
        ce0, ce1, g0, g1 = out["ce"]
        np.testing.assert_allclose(ce1, ce0, rtol=1e-6)
        assert np.abs(g1 - g0).max() <= 1e-6 * np.abs(g0).max()


def test_kv_projections_left_whole_by_the_guard(ranks):
    """2 query heads over 2 ranks with one kv head of 15 dims: the guard
    shards wq by heads and leaves wk/wv whole, and each rank selects the kv
    head its query head reads. One step against the one-device step, to
    ``assert_step_matches``'s rule: loss within rtol 2e-6, params within
    1e-6 where |g| ≥ 1e-6 and within Adam's bound 2·lr elsewhere."""
    w = ranks[0]["whole_kv"]
    assert w["spec_wq"][-1] == "model" and "model" not in w["spec_wk"]
    np.testing.assert_allclose(w["loss"][1], w["loss"][0], rtol=2e-6)
    for a, b, m in zip(_leaves(w["params"][0]), _leaves(w["params"][1]), _leaves(w["m"])):
        small = np.abs(m) < 1e-7
        assert np.abs(a - b)[~small].max(initial=0.0) <= 1e-6
        assert np.abs(a - b)[small].max(initial=0.0) <= 2 * 1e-3


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mamba2-370m", "zamba2-1.2b"])
def test_other_families_still_raise(ranks, arch):
    """The moe, ssm and hybrid families, which raised under a "model" axis
    > 1 before their tensor parallelism was ported (ROADMAP item 14b-ii),
    now step under a "model" axis of 2: init_train_state and the train step
    with the mesh give the one-device loss within rtol 2e-6, and the prefill
    step on init_params' shards gives whole (B, 1, V) logits."""
    for out in ranks:
        got = out["steps"][arch]
        np.testing.assert_allclose(got["loss"][1], got["loss"][0], rtol=2e-6)
        assert got["logits_shape"] == (2, 1, 128)
