"""Pods × model: the compressed cross-pod sync on tensor-parallel shards,
on four ``gloo`` CPU ranks (mesh (2, 1, 2) over ("pod", "data", "model")),
against the reference in a subprocess whose JAX sees four forced host
devices: its ``ternary_allreduce_tree`` inside ``shard_map`` manual over
"pod" (auto over "model"), whose max and mean are the whole leaf's, and its
compressed multi-pod train step with the params placed by its sharding
rules. The config is ``tests/test_parallel.py``'s (2 layers, d 64, vocab
128, batch 8 × 16, ``adam(2e-3)``)."""

import numpy as np
import pytest

from _torch_dist import run_jax, run_ranks

STEPS = 3
LR = 2e-3
CFG = dict(name="t", family="dense", n_layers=2, d_model=64, vocab_size=128, n_heads=4,
           n_kv_heads=2, head_dim=16, d_ff=128)

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
cfg = ModelConfig(**CFG)
auto = lambda n: (AxisType.Auto,) * n
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
mesh = jax.make_mesh((2, 1, 2), ("pod", "data", "model"), axis_types=auto(3))
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
pickle.dump(out, open(OUT, "wb"))
"""


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp-pods")
    ref = run_jax(f"CFG = {CFG!r}\nSTEPS = {STEPS}\nLR = {LR}\n" + _REFERENCE, 4, tmp)
    ranks = run_ranks("tp_pods", 4, tmp, timeout=150, cfg=CFG, state=ref["state"],
                      batch=ref["batch"], lr=LR, steps=STEPS, trees=ref["trees"])
    return ref, ranks


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
