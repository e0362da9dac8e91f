"""Pods × model: the compressed cross-pod sync on tensor-parallel shards,
on four ``gloo`` CPU ranks (mesh (2, 1, 2) over ("pod", "data", "model")),
against the reference in a subprocess whose JAX sees four forced host
devices: its ``ternary_allreduce_tree`` inside ``shard_map`` manual over
"pod" (auto over "model"), whose max and mean are the whole leaf's, and its
compressed multi-pod train step with the params placed by its sharding
rules. The dense config is ``tests/test_parallel.py``'s (2 layers, d 64,
vocab 128, batch 8 × 16, ``adam(2e-3)``); qwen3-moe-30b-a3b and zamba2-1.2b
run at their reduced configs on the same batch (expert stacks, Mamba2
projections and the hybrid's shared block as shards)."""

import dataclasses

import numpy as np
import pytest

from _torch_dist import run_jax, run_ranks
from repro_torch.configs import get_reduced

STEPS = 3
LR = 2e-3
CFG = dict(name="t", family="dense", n_layers=2, d_model=64, vocab_size=128, n_heads=4,
           n_kv_heads=2, head_dim=16, d_ff=128)
FAMILIES = ["qwen3-moe-30b-a3b", "zamba2-1.2b"]
CFGS = {"dense": CFG, **{a: dataclasses.asdict(get_reduced(a)) for a in FAMILIES}}

_REFERENCE = """
import pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.compat import set_mesh, shard_map
from repro.models.transformer import ModelConfig, init_params
from repro.optim import adam
from repro.parallel.collectives import ternary_allreduce_tree
from repro.parallel.sharding import param_specs
from repro.train import TrainerConfig, init_train_state, make_train_step

tm = jax.tree_util.tree_map
auto = lambda n: (AxisType.Auto,) * n
results = {}
for name, CFG in CFGS.items():
    cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in CFG.items()})
    out = {"collective": []}

    # (a) the collective over whole leaves, each pod's (scalars of the whole leaf)
    shapes = jax.eval_shape(lambda k: init_params(cfg, k), jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    trees = [[tm(lambda s: (rng.normal(size=s.shape) * 1e-3).astype(np.float32), shapes)
              for _ in range(2)] for _ in range(STEPS)]
    out["trees"] = trees
    mesh_c = jax.make_mesh((2, 2), ("pod", "model"), axis_types=auto(2))

    def tree(g, r):
        s, nr = ternary_allreduce_tree(tm(lambda a: a[0], g), "pod",
                                       residuals=tm(lambda a: a[0], r), error_feedback=True)
        return s, tm(lambda a: a[None], nr)

    run = jax.jit(shard_map(tree, mesh=mesh_c, in_specs=(P("pod"), P("pod")),
                            out_specs=(P(), P("pod")), axis_names={"pod"}, check_vma=False))
    res = tm(lambda a: jnp.zeros((2,) + a.shape, jnp.float32), trees[0][0])
    for step in trees:
        synced, res = run(tm(lambda *pods: jnp.stack(pods), *step), res)
        out["collective"].append({"synced": tm(np.asarray, synced), "res": tm(np.asarray, res)})

    # (b) compressed training on (2, 1, 2), params placed by the sharding rules
    mesh = jax.make_mesh(MESH, ("pod", "data", "model"), axis_types=auto(3))
    batch = {"tokens": jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0, 128),
             "labels": jax.random.randint(jax.random.PRNGKey(2), (8, 16), 0, 128)}
    tcfg = TrainerConfig(qat=True, pod_compression=True, error_feedback=True)
    opt = adam(LR)
    state = init_train_state(cfg, tcfg, opt, jax.random.PRNGKey(0), n_pods=2)
    out["state"] = {"params": tm(np.asarray, state.params), "wq": tm(np.asarray, state.wq),
                    "opt_state": tm(np.asarray, state.opt_state), "step": int(state.step)}
    out["batch"] = tm(np.asarray, batch)
    specs = param_specs(cfg, mesh)
    put = lambda t: tm(lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp)), t, specs)
    state = type(state)(params=put(state.params), wq=state.wq,
                        opt_state={"step": state.opt_state["step"], "m": put(state.opt_state["m"]),
                                   "v": put(state.opt_state["v"])},
                        residuals=state.residuals, step=state.step)
    with set_mesh(mesh):
        js = jax.jit(make_train_step(cfg, tcfg, opt, mesh))
        losses = []
        for _ in range(STEPS):
            state, m = js(state, batch)
            losses.append(float(m["loss"]))
    out["train"] = {"losses": losses, "params": tm(np.asarray, state.params),
                    "wq": tm(np.asarray, state.wq), "residuals": tm(np.asarray, state.residuals)}
    results[name] = out
pickle.dump(results, open(OUT, "wb"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{config name: (the reference's results, the four ranks' results)}."""
    tmp = tmp_path_factory.mktemp("tp-pods")
    refs = run_jax(f"CFGS = {CFGS!r}\nSTEPS = {STEPS}\nLR = {LR}\nMESH = (2, 1, 2)\n"
                   + _REFERENCE, 4, tmp, timeout=300)
    out = {}
    for name, cfg in CFGS.items():
        ref = refs[name]
        # the new families' collective steps each from the reference's residuals
        res_in = None if name == "dense" else [_zeros_like(ref["collective"][0]["res"])] + [
            ref["collective"][k]["res"] for k in range(STEPS - 1)]
        out[name] = ref, run_ranks("tp_pods", 4, tmp / name.replace(".", "_"), timeout=150,
                                   cfg=cfg, state=ref["state"], batch=ref["batch"], lr=LR,
                                   steps=STEPS, trees=ref["trees"], residuals_in=res_in)
    return out


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return np.zeros_like(tree)


@pytest.fixture(scope="module")
def both(runs):
    return runs["dense"]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [] if tree is None else [np.asarray(tree)]


def _close(a, b, tol):
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("step", range(STEPS))
def test_collective_on_shards_matches_reference(both, step):
    """Each step of error feedback: every rank's mean (its shards, gathered
    over "model") within 1e-6 of each leaf's largest |value| of the
    reference's, and its pod's residuals too (the pod index is the rank's
    on the mesh: ranks 0-1 pod 0, 2-3 pod 1)."""
    ref, ranks = both
    want = ref["collective"][step]
    for rank, r in enumerate(ranks):
        got = r["collective"][step]
        for a, b in zip(_leaves(got["synced"]), _leaves(want["synced"])):
            _close(a, b, 1e-6)
        for a, b in zip(_leaves(got["res"]), _leaves(want["res"])):
            _close(a, b[rank // 2], 1e-6)


@pytest.mark.parametrize("step", range(STEPS))
def test_kernel_path_equals_the_plain_version_on_shards(both, step):
    """The kernel path (one quantize_pack launch with whole-leaf scalars in
    its segment table, the shards' moments summed over "model") against the
    plain version on the same shards: within 1e-6 of each leaf's largest."""
    _, ranks = both
    for r in ranks:
        got, plain = r["collective"][step], r["plain"][step]
        for part in ("synced", "res"):
            for a, b in zip(_leaves(got[part]), _leaves(plain[part])):
                _close(a, b, 1e-6)


def test_gathered_bytes_are_a_quarter_byte_a_shard_coordinate(both):
    """A rank receives from the other pod 0.25 B per compressed coordinate
    of its shards plus 4 B per w_q: the attention and MLP leaves, each
    halved over "model" (d 64, hd 16, 4 q and 2 kv heads, d_ff 128, 2
    layers)."""
    _, ranks = both
    whole = 2 * (64 * 64 + 2 * 64 * 32 + 64 * 64 + 3 * 64 * 128)
    for r in ranks:
        for step in r["collective"]:
            assert step["wire"]["all_gather"] == whole // 2 // 4 + 4 * 7


def test_compressed_training_matches_reference(both):
    """Three compressed steps over (2, 1, 2) from the reference's state:
    every loss within rtol 1e-5, the params within 2e-4 of each leaf's
    largest |value| (Adam's first steps on |g| ~ 1e-8, as in the multi-pod
    test), the w_q within rtol 1e-4, the residuals gathered over pods and
    shards within 1e-4 of each leaf's largest; all four ranks alike."""
    ref, ranks = both
    want = ref["train"]
    for r in ranks:
        got = r["train"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        for a, b in zip(_leaves(got["params"]), _leaves(want["params"])):
            _close(a, b, 2e-4)
        for a, b in zip(_leaves(got["wq"]), _leaves(want["wq"])):
            np.testing.assert_allclose(a, b, rtol=1e-4)
        for a, b in zip(_leaves(got["residuals"]), _leaves(want["residuals"])):
            _close(a, b, 1e-4)
    for r in ranks[1:]:
        for a, b in zip(_leaves(r["train"]["params"]), _leaves(ranks[0]["train"]["params"])):
            np.testing.assert_array_equal(a, b)


# the compressed coordinates of a rank's shards of the reduced configs: the
# quantizable leaves (not norms, embeddings, lm_head, a_log or dt_bias)
# whose whole last dim is a multiple of 4, halved where "model" splits them
_QWEN3_MOE = (2 * 64 * 64 + 2 * 2 * 64 * 32) // 2 + 2 * 64 * 64 // 2 \
    + 2 * 64 * 8 + 3 * 2 * 8 * 64 * 32 // 2            # attention, router, experts (E/2)
_ZAMBA2 = 5 * (64 * 280 + 4 * 144 + 128 * 64) // 2 + 5 * 8 \
    + (4 * 64 * 64 + 3 * 64 * 128) // 2                # Mamba2, d_skip, the shared block
SHARD_CODES = {"qwen3-moe-30b-a3b": (_QWEN3_MOE, 8), "zamba2-1.2b": (_ZAMBA2, 11)}


def _ties(x):
    """Where |x| / (max|x| + 1e-12) is within 1e-6 (relative) of Δ = 0.7 ·
    mean|x| / (max|x| + 1e-12): a code that two summation orders may set
    either way."""
    denom = np.abs(x).max() + 1e-12
    delta = 0.7 * np.abs(x).mean() / denom
    return np.abs(np.abs(x) / denom - delta) <= 1e-6 * delta


def _held_at_ties(got, want, ties, tol):
    """``got`` against ``want``: every element more than 1e-4 of max |want|
    apart (a code flipped, which moves it by w_q) at a proven tie, the rest
    within ``tol`` of max |want|, or 1e-5 where the leaf has a flip (one
    code more or less moves the leaf's w_q by ~1/count: 4e-6 measured).
    Returns the number of flipped elements."""
    scale = max(np.abs(want).max(), 1e-30)
    gap = np.abs(got - want)
    flip = gap > 1e-4 * scale
    assert ties[flip].all(), "a code differs away from a tie at Δ"
    assert gap[~flip].max(initial=0.0) <= (1e-5 if flip.any() else tol) * scale
    return int(flip.sum())


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_collective_on_shards_matches_reference(runs, arch, step):
    """As ``test_collective_on_shards_matches_reference`` on qwen3-moe's
    expert shards and zamba2's Mamba2 and shared-block shards, each step
    from the reference's residuals (so a tie does not carry into the next
    step): each rank's mean and its pod's residuals within 2e-6 of each
    leaf's largest |value| of the reference's (w_q sums up to 89,600
    elements, which the two packages add in their own orders: 1.3e-6
    measured on a 32,768-element expert stack), and the kernel path within
    1e-6 of the plain version on the same shards; a code may differ only at
    a proven tie at Δ (zamba2's in_proj has one at steps 0 and 1)."""
    ref, ranks = runs[arch]
    want = ref["collective"][step]
    res_in = _leaves(ref["collective"][step - 1]["res"]) if step else None
    x = [[g + (res_in[i][pod] if step else 0)
          for i, g in enumerate(_leaves(ref["trees"][step][pod]))] for pod in range(2)]
    for rank, r in enumerate(ranks):
        pod = rank // 2
        got, plain = r["collective"][step], r["plain"][step]
        for i, (a, b) in enumerate(zip(_leaves(got["synced"]), _leaves(want["synced"]))):
            _held_at_ties(a, b, _ties(x[0][i]) | _ties(x[1][i]), 2e-6)
        for i, (a, b) in enumerate(zip(_leaves(got["res"]), _leaves(want["res"]))):
            _held_at_ties(a, b[pod], _ties(x[pod][i]), 2e-6)
        for part in ("synced", "res"):
            for i, (a, b) in enumerate(zip(_leaves(got[part]), _leaves(plain[part]))):
                _held_at_ties(a, b, _ties(x[0][i]) | _ties(x[1][i]), 1e-6)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_gathered_bytes_are_a_quarter_byte_a_shard_coordinate(runs, arch):
    """A rank receives from the other pod 0.25 B per compressed coordinate
    of its shards plus 4 B per w_q (``SHARD_CODES``)."""
    _, ranks = runs[arch]
    codes, leaves = SHARD_CODES[arch]
    for r in ranks:
        for step in r["collective"]:
            assert step["wire"]["all_gather"] == codes // 4 + 4 * leaves


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_compressed_training_matches_reference(runs, arch):
    """Three compressed QAT steps over (2, 1, 2) from the reference's state,
    to ``test_compressed_training_matches_reference``'s tolerances: losses
    within rtol 1e-5, params within 2e-4 of each leaf's largest, w_q within
    rtol 1e-4, residuals within 1e-4; all four ranks alike."""
    ref, ranks = runs[arch]
    want = ref["train"]
    for r in ranks:
        got = r["train"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        for a, b in zip(_leaves(got["params"]), _leaves(want["params"])):
            _close(a, b, 2e-4)
        for a, b in zip(_leaves(got["wq"]), _leaves(want["wq"])):
            np.testing.assert_allclose(a, b, rtol=1e-4)
        for a, b in zip(_leaves(got["residuals"]), _leaves(want["residuals"])):
            _close(a, b, 1e-4)
    for r in ranks[1:]:
        for a, b in zip(_leaves(r["train"]["params"]), _leaves(ranks[0]["train"]["params"])):
            np.testing.assert_array_equal(a, b)
