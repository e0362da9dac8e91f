"""Pods × FSDP for the MoE with microbatches: qwen3-moe-30b-a3b (reduced)
trained with the compressed cross-pod sync and 2 microbatches on four
``gloo`` CPU ranks (mesh (2, 2, 1) over ("pod", "data", "model")), against
the reference's compressed multi-pod step in a subprocess whose JAX sees
four forced host devices, with the params and moments placed by its
sharding rules. Each pod's rows are split into microbatches across its two
data ranks, as the reference's step body, manual over "pod", splits them."""

import numpy as np
import pytest

from _torch_dist import run_jax, run_ranks
from test_torch_tensor_parallel_pods import CFGS, LR, STEPS

MESH = (2, 2, 1)
MOE = "qwen3-moe-30b-a3b"

_MOE_REFERENCE = """
import pickle
import jax, numpy as np
from jax.sharding import AxisType, NamedSharding
from repro.compat import set_mesh
from repro.models.transformer import ModelConfig
from repro.optim import adam
from repro.parallel.sharding import param_specs
from repro.train import TrainerConfig, init_train_state, make_train_step

tm = jax.tree_util.tree_map
cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in CFG.items()})
mesh = jax.make_mesh(MESH, ("pod", "data", "model"), axis_types=(AxisType.Auto,) * 3)
batch = {"tokens": jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0, cfg.vocab_size),
         "labels": jax.random.randint(jax.random.PRNGKey(2), (8, 16), 0, cfg.vocab_size)}
tcfg = TrainerConfig(qat=True, pod_compression=True, error_feedback=True, microbatches=2)
opt = adam(LR)
state = init_train_state(cfg, tcfg, opt, jax.random.PRNGKey(0), n_pods=2)
out = {"state": {"params": tm(np.asarray, state.params), "wq": tm(np.asarray, state.wq),
                 "opt_state": tm(np.asarray, state.opt_state), "step": int(state.step)},
       "batch": tm(np.asarray, batch)}
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


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [] if tree is None else [np.asarray(tree)]


def _near_delta(x, rel: float = 1e-5):
    """Where |x| / (max|x| + 1e-12) is within ``rel`` (relative) of Δ = 0.7 ·
    mean|x| / (max|x| + 1e-12): a code that two summation orders of the
    microbatches' gradients may set either way."""
    denom = np.abs(x).max() + 1e-12
    delta = 0.7 * np.abs(x).mean() / denom
    return np.abs(np.abs(x) / denom - delta) <= rel * delta


@pytest.fixture(scope="module")
def moe_micro(tmp_path_factory):
    """(the reference's results, the four ranks' results) of qwen3-moe with
    2 microbatches on (2, 2, 1)."""
    tmp = tmp_path_factory.mktemp("fsdp-pods-moe")
    ref = run_jax(f"CFG = {CFGS[MOE]!r}\nSTEPS = {STEPS}\nLR = {LR}\nMESH = {MESH}\n"
                  + _MOE_REFERENCE, 4, tmp, timeout=300)
    return ref, run_ranks("tp_pods", 4, tmp, timeout=150, cfg=CFGS[MOE], state=ref["state"],
                          batch=ref["batch"], lr=LR, steps=STEPS, trees=[],
                          mesh_shape=MESH, tcfg={"microbatches": 2})


def test_moe_microbatches_within_each_pod_match_reference(moe_micro):
    """Three compressed QAT steps of qwen3-moe with 2 microbatches over
    (2, 2, 1): the reference's step body is manual over "pod", so a pod's
    rows stay its own, and its microbatch i is the pod's rows [i·B/4,
    (i+1)·B/4) of its block, half on each data rank, routed as one batch.
    Losses within rtol 1e-5 and w_q within rtol 1e-4; params within 2e-4
    and residuals within 1e-4 of each leaf's largest, as in
    ``test_compressed_training_on_data_shards_matches_reference``, except
    where a ternary code of the sync flipped: such an element must sit at a
    tie at Δ (``_near_delta``) in some step's compressed input of either
    pod, since the two packages sum the microbatches' gradients in their
    own orders (one w_gate element measured, 1.5e-6 of Δ from it). All four ranks alike."""
    ref, ranks = moe_micro
    want = ref["train"]
    # per leaf, the positions at a tie in any step's input of either pod
    inputs = [ranks[0]["train"]["synced_inputs"], ranks[2]["train"]["synced_inputs"]]
    ties = [np.zeros(a.shape, bool) for a in _leaves(inputs[0][0])]
    for pod in inputs:
        for step in pod:
            for i, x in enumerate(_leaves(step)):
                ties[i] |= _near_delta(x)
    for r in ranks:
        got = r["train"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        for a, b in zip(_leaves(got["wq"]), _leaves(want["wq"])):
            np.testing.assert_allclose(a, b, rtol=1e-4)
        for part, tol in (("params", 2e-4), ("residuals", 1e-4)):
            for i, (a, b) in enumerate(zip(_leaves(got[part]), _leaves(want[part]))):
                assert a.shape == b.shape
                off = np.abs(a - b) > tol * max(np.abs(b).max(), 1e-30)
                at = ties[i] if part == "params" else np.broadcast_to(ties[i], a.shape)
                assert at[off].all(), f"{part} leaf {i} differs away from a tie at Δ"
    for r in ranks[1:]:
        for a, b in zip(_leaves(r["train"]["params"]), _leaves(ranks[0]["train"]["params"])):
            np.testing.assert_array_equal(a, b)
