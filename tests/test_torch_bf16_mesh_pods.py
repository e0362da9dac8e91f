"""The reference's bf16 production cell across pods (``repro.launch.dryrun
.build_cell`` with "pod_compressed": bf16 params and compute, remat "full",
QAT, adam(1e-4), 2 microbatches, the ternary cross-pod sync with error
feedback, the batch constrained to "data"): olmo-1b reduced on pods x
model (2, 1, 2) and pods x data (2, 2, 1), two compressed steps on four
``gloo`` CPU ranks from the reference's state, against the reference's
compressed multi-pod step (``shard_map`` manual over "pod", params and
moments placed by its sharding rules, compiled with
``_torch_train_parity.PER_OP``) on four forced host devices, as
``test_torch_tensor_parallel_pods.py`` and ``test_torch_fsdp_pods.py`` run
its fp32 steps. The sync takes the fp32 accumulators (the reference's
``ternary_allreduce`` casts each leaf to fp32) and returns the mean in the
leaf's dtype."""

import dataclasses

import jax
import numpy as np
import pytest

from _torch_dist import REPO, run_jax, run_ranks
from _torch_train_parity import BF16, BF16_LR, EPS
from repro_torch.configs import get_reduced

MESHES = [(2, 1, 2), (2, 2, 1)]
STEPS = 2
CFG = dataclasses.asdict(get_reduced("olmo-1b", **BF16, mesh_batch_axes=("data",)))

_REFERENCE = """
import os, pickle, sys
sys.path.insert(0, os.path.join(REPO, "tests"))
import jax, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.compat import set_mesh
from repro.models.transformer import ModelConfig
from repro.optim import adam
from repro.parallel.sharding import param_specs
from repro.train import TrainerConfig, init_train_state, make_train_step
import _torch_train_parity as T

tm = jax.tree_util.tree_map
cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in CFG.items()})
tcfg = TrainerConfig(qat=True, pod_compression=True, error_feedback=True, microbatches=2)
opt = adam(T.BF16_LR)
results = {}
for shape in MESHES:
    mesh = jax.make_mesh(shape, ("pod", "data", "model"), axis_types=(AxisType.Auto,) * 3)
    state = init_train_state(cfg, tcfg, opt, jax.random.PRNGKey(0), n_pods=2)
    batch = T.batch_np(cfg, 8)
    out = {"state": {"params": tm(np.asarray, state.params), "wq": tm(np.asarray, state.wq),
                     "opt_state": tm(np.asarray, state.opt_state), "step": int(state.step)},
           "batch": batch}
    specs = param_specs(cfg, mesh)
    put = lambda t: tm(lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp)), t, specs)
    rep = lambda t: tm(lambda x: jax.device_put(x, NamedSharding(mesh, P())), t)
    place = lambda s: type(s)(params=put(s.params), wq=rep(s.wq),
                              opt_state={"step": rep(s.opt_state["step"]),
                                         "m": put(s.opt_state["m"]), "v": put(s.opt_state["v"])},
                              residuals=tm(lambda x: jax.device_put(
                                  x, NamedSharding(mesh, P("pod"))), s.residuals),
                              step=rep(s.step))
    b = {k: jax.device_put(v, NamedSharding(mesh, P(("pod", "data")))) for k, v in batch.items()}
    state = place(state)
    with set_mesh(mesh):
        js = jax.jit(make_train_step(cfg, tcfg, opt, mesh)).lower(state, b).compile(T.PER_OP)
        losses = []
        for _ in range(STEPS):
            new, m = js(state, b)
            state = place(new)
            losses.append(float(m["loss"]))
    out["train"] = {"losses": losses, "params": tm(np.asarray, state.params),
                    "wq": tm(np.asarray, state.wq), "m": tm(np.asarray, state.opt_state["m"]),
                    "residuals": tm(np.asarray, state.residuals)}
    results[shape] = out
pickle.dump(results, open(OUT, "wb"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mesh shape: (the reference's results, the four ranks' results)}."""
    tmp = tmp_path_factory.mktemp("bf16-mesh-pods")
    refs = run_jax(f"REPO = {REPO!r}\nCFG = {CFG!r}\nSTEPS = {STEPS}\nMESHES = {MESHES!r}\n"
                   + _REFERENCE, 4, tmp, timeout=300)
    return {shape: (refs[shape], run_ranks(
        "tp_pods", 4, tmp / "x".join(map(str, shape)), timeout=200, cfg=CFG,
        state=refs[shape]["state"], batch=refs[shape]["batch"], lr=BF16_LR, steps=STEPS,
        trees=[], mesh_shape=shape, tcfg={"microbatches": 2})) for shape in MESHES}


def _leaves(tree) -> list:
    return [np.asarray(x).astype(np.float32) for x in jax.tree_util.tree_leaves(tree)]


def _ulp(b: np.ndarray) -> np.ndarray:
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(b), 2.0 ** -126))) - 7)


def _dtypes(tree) -> list:
    return [str(np.asarray(x).dtype) for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("shape", MESHES)
def test_gathered_bytes_are_a_quarter_byte_a_shard_coordinate(runs, shape):
    """Each step's sync: a rank receives from the other pod 0.25 B per
    compressed coordinate of its shards plus 4 B per leaf's w_q, and its
    shards are half of each whole leaf (the mesh's size-2 axis cuts
    them)."""
    ref, ranks = runs[shape]
    factors = {jax.tree_util.keystr(p) for p, w in jax.tree_util.tree_flatten_with_path(
        ref["train"]["wq"], is_leaf=lambda x: x is None)[0] if w is not None}
    whole = sum(x.size for p, x in jax.tree_util.tree_flatten_with_path(
        ref["train"]["params"])[0] if jax.tree_util.keystr(p) in factors)
    for r in ranks:
        assert len(r["train"]["sync_wire"]) == STEPS
        for w in r["train"]["sync_wire"]:
            assert w["all_gather"] == w["codes"] // 4 + 4 * w["leaves"]
            assert 2 * w["codes"] == whole


@pytest.mark.parametrize("shape", MESHES)
def test_compressed_bf16_steps_match_reference(runs, shape):
    """Two compressed bf16 steps from the reference's state. The dtypes
    exact (bf16 params and w_q, fp32 residuals); the losses within rtol
    2^-13 (``assert_bf16_later_step_matches``'s; measured 2.0e-5); the w_q
    within one bf16 ulp (measured equal). The packages' bf16 gradients
    differ by ulps, so the codes of the sync flip where a pod's fp32
    accumulator lies at Δ: each flip moves that element's residual by a
    scale and its mean by one, and Adam's steps may take the other sign
    where a gradient is near zero. So, per leaf, with the worst measured
    over both meshes in parentheses:

    - the params: at least 99% within one bf16 ulp of each value plus
      2^-6·lr (99.58%), and all within one ulp plus 5·lr, two Adam steps
      of at most 1.25·lr each taken with opposite signs (3.66·lr);
    - the residuals: at least 98% within 8ε of the leaf's largest |value|
      (98.96%), and all within 0.3 of it (a flip's move, 0.158); a leaf the
      sync does not compress keeps zero residuals in both.

    All four ranks alike, bit for bit."""
    ref, ranks = runs[shape]
    want = ref["train"]
    for r in ranks:
        got = r["train"]
        for part in ("params", "wq", "residuals"):
            assert _dtypes(got[part]) == _dtypes(want[part]), part
        assert "bfloat16" in _dtypes(got["params"]) and "float32" in _dtypes(got["residuals"])
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=2.0 ** -13)
        for a, b in zip(_leaves(got["params"]), _leaves(want["params"])):
            d, ulp = np.abs(a - b), _ulp(b)
            assert (d <= ulp + 2.0 ** -6 * BF16_LR).mean() >= 0.99
            assert (d <= ulp + 5 * BF16_LR).all()
        for a, b in zip(_leaves(got["wq"]), _leaves(want["wq"])):
            assert (np.abs(a - b) <= _ulp(b)).all()
        for a, b in zip(_leaves(got["residuals"]), _leaves(want["residuals"])):
            top = np.abs(b).max()
            if top == 0:
                assert not a.any()
                continue
            d = np.abs(a - b)
            assert (d <= 8 * EPS * top).mean() >= 0.98
            assert d.max() <= 0.3 * top
    for r in ranks[1:]:
        for part in ("params", "wq", "residuals"):
            for a, b in zip(jax.tree_util.tree_leaves(r["train"][part]),
                            jax.tree_util.tree_leaves(ranks[0]["train"][part])):
                np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                              np.asarray(b).view(np.uint8))


@pytest.mark.parametrize("shape", MESHES)
def test_sync_inputs_are_fp32_accumulators(runs, shape):
    """What each step hands the sync, gradient plus residual, is fp32, as
    the reference's ``ternary_allreduce`` casts it."""
    _, ranks = runs[shape]
    for r in ranks:
        for x in r["train"]["synced_inputs"]:
            assert set(_dtypes(x)) == {"float32"}
