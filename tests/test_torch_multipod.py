"""The port's multi-pod trainer on two ``gloo`` CPU ranks against the
reference's jitted multi-pod step, run in a subprocess whose JAX sees two
forced host devices (mesh (2, 1, 1) over ("pod", "data", "model")), from
the same numpy initial state and batch: ``tests/test_parallel.py``'s
config (2 layers, d 64, vocab 128, batch 8 × 16, ``adam(2e-3)``), with and
without pod compression, over 6 steps."""

import numpy as np
import pytest

from _torch_dist import run_jax, run_ranks

STEPS = 6
LR = 2e-3
CFG = dict(name="t", family="dense", n_layers=2, d_model=64, vocab_size=128, n_heads=4,
           n_kv_heads=2, head_dim=16, d_ff=128)
RUNS = {"exact": dict(qat=True, pod_compression=False, error_feedback=True),
        "compressed": dict(qat=True, pod_compression=True, error_feedback=True)}

_REFERENCE = """
import pickle
import jax, jax.numpy as jnp, numpy as np
from repro.compat import set_mesh
from repro.models.transformer import ModelConfig
from repro.optim import adam
from repro.train import TrainerConfig, init_train_state, make_train_step
cfg = ModelConfig(**CFG)
mesh = jax.make_mesh((2, 1, 1), ("pod", "data", "model"))
batch = {"tokens": jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0, 128),
         "labels": jax.random.randint(jax.random.PRNGKey(2), (8, 16), 0, 128)}
tm = jax.tree_util.tree_map
out = {"batch": tm(np.asarray, batch), "runs": {}}
for name, kw in RUNS.items():
    tcfg = TrainerConfig(**kw)
    opt = adam(LR)
    state = init_train_state(cfg, tcfg, opt, jax.random.PRNGKey(0), n_pods=2)
    if name == "exact":
        out["state"] = {"params": tm(np.asarray, state.params), "wq": tm(np.asarray, state.wq),
                        "opt_state": tm(np.asarray, state.opt_state),
                        "step": int(state.step)}
    with set_mesh(mesh):
        js = jax.jit(make_train_step(cfg, tcfg, opt, mesh))
        losses = []
        for _ in range(STEPS):
            state, m = js(state, batch)
            losses.append(float(m["loss"]))
    out["runs"][name] = {"losses": losses, "params": tm(np.asarray, state.params),
                         "wq": tm(np.asarray, state.wq),
                         "residuals": (tm(np.asarray, state.residuals)
                                       if state.residuals is not None else None)}
pickle.dump(out, open(OUT, "wb"))
"""


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multipod")
    ref = run_jax(f"CFG = {CFG!r}\nRUNS = {RUNS!r}\nSTEPS = {STEPS}\nLR = {LR}\n" + _REFERENCE,
                  2, tmp)
    ranks = run_ranks("trainer", 2, tmp, timeout=120, cfg=CFG, runs=RUNS, state=ref["state"],
                      batch=ref["batch"], lr=LR, steps=STEPS)
    return ref, ranks


def _leaves(tree):
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out += _leaves(tree[k])
    elif tree is not None:
        out.append(np.asarray(tree))
    return out


@pytest.mark.parametrize("run", list(RUNS))
def test_multipod_step_matches_reference(both, run):
    """Every step's loss within rtol 1e-5 of the reference's (measured
    ≤ 2.3e-7 over the 6 steps: another summation order); after 6 steps the
    params within 2e-4 of their largest |value| (measured ≤ 5.8e-5: Adam's
    first updates lr·g/(|g| + 1e-8) move a weight whose |g| is ~1e-8 by up
    to lr on rounding alone) and the w_q within rtol 1e-4 (measured equal);
    both ranks bit for bit alike."""
    ref, ranks = both
    want = ref["runs"][run]
    for r in ranks:
        got = r[run]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        for a, b in zip(_leaves(got["params"]), _leaves(want["params"])):
            assert np.abs(a - b).max() <= 2e-4 * np.abs(b).max()
        for a, b in zip(_leaves(got["wq"]), _leaves(want["wq"])):
            np.testing.assert_allclose(a, b, rtol=1e-4)
    for a, b in zip(_leaves(ranks[0][run]["params"]), _leaves(ranks[1][run]["params"])):
        np.testing.assert_array_equal(a, b)


def test_multipod_residuals_gather_to_the_reference_layout(both):
    """Each rank keeps its pod's (1, *shape) residual block; gathered they
    are the reference's (n_pods, *shape) tree, within 1e-4 of each leaf's
    largest |value| after 6 steps (measured ≤ 1.2e-6); the exact run has
    none."""
    ref, ranks = both
    want = ref["runs"]["compressed"]["residuals"]
    got = ranks[0]["compressed"]["residuals"]
    for a, b in zip(_leaves(got), _leaves(want)):
        assert a.shape == b.shape and a.shape[0] == 2
        assert np.abs(a - b).max() <= 1e-4 * max(np.abs(b).max(), 1e-12)
    assert ranks[0]["exact"]["residuals"] is None and ref["runs"]["exact"]["residuals"] is None


def test_multipod_training_converges_as_the_reference_asserts(both):
    """The reference test's assertions, on the port's losses: both runs
    converge and the compressed run stays within 25% of the exact one."""
    _, ranks = both
    exact, comp = ranks[0]["exact"]["losses"], ranks[0]["compressed"]["losses"]
    assert exact[-1] < exact[0]
    assert comp[-1] < comp[0]
    assert comp[-1] < exact[-1] * 1.25
