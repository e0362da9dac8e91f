"""Shared by the tensor-parallel train-step parity tests: the reference's
GSPMD step on a (data, model) mesh of forced host devices (params, Adam's
moments and batch placed by its own sharding rules, axes of type Auto, so
JAX 0.9 partitions the step), and the port's step on ``gloo`` CPU ranks on
the same mesh shape from the same state and batch, gathered into whole
leaves, beside the port's one-device step."""

import concurrent.futures
import types

import numpy as np
import torch

from _torch_dist import REPO, run_jax, run_ranks
from _torch_dist_cases import _np
from _torch_train_parity import (
    EPS, LR, assert_bf16_later_step_matches, assert_bf16_step_matches, assert_step_matches, pairs,
)

SHAPES = [(1, 2), (2, 2)]

_REFERENCE = """
import dataclasses, os, pickle, sys
sys.path.insert(0, os.path.join(REPO, "tests"))
import jax, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.compat import set_mesh
from repro.optim import adam
from repro.parallel.sharding import param_specs
from repro.train import TrainerConfig, make_train_step
import _torch_train_parity as T

tm = jax.tree_util.tree_map


def as_np(st):
    return {"params": tm(np.asarray, st.params), "wq": tm(np.asarray, st.wq),
            "opt_state": tm(np.asarray, st.opt_state), "step": int(st.step)}


out = {}
for key, arch, shape, tkw, ov, run in RUNS:
    lr, bf16 = run.get("lr", T.LR), ov.get("param_dtype") == "bfloat16"
    jcfg, cfg, st = T.reference_state(arch, tkw, lr=lr, **ov)
    batch = T.batch_np(cfg, ROWS)
    step = jax.jit(make_train_step(jcfg, TrainerConfig(pod_compression=False, **tkw),
                                   adam(lr)))
    mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    specs = param_specs(jcfg, mesh)
    put = lambda t, s: tm(lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp)), t, s)
    rep = lambda t: tm(lambda x: jax.device_put(x, NamedSharding(mesh, P())), t)
    place = lambda st: type(st)(params=put(st.params, specs), wq=rep(st.wq),
                                opt_state={"step": rep(st.opt_state["step"]),
                                           "m": put(st.opt_state["m"], specs),
                                           "v": put(st.opt_state["v"], specs)},
                                residuals=None, step=rep(st.step))
    placed = place(st)
    b = {k: jax.device_put(v, NamedSharding(mesh, P("data"))) for k, v in batch.items()}
    steps = []
    with set_mesh(mesh):
        if bf16:      # each op rounded as the program writes it, as the port rounds it
            step = step.lower(placed, b).compile(T.PER_OP)
        for _ in range(run.get("steps", 1)):
            new, m = step(placed, b)
            placed = place(new)
            steps.append({"new": as_np(placed), "metrics": {k: float(v) for k, v in m.items()}})
    out[key] = {"state": as_np(st), "batch": batch, **steps[0], "steps": steps}
    if run.get("reference_one"):
        # the reference's own one-device steps (no mesh, so no mesh axes)
        one = jax.jit(make_train_step(
            dataclasses.replace(jcfg, mesh_batch_axes=(), mesh_ep_axis=""),
            TrainerConfig(pod_compression=False, **tkw), adam(lr)))
        one, s1, out[key]["one_steps"] = one.lower(st, batch).compile(T.PER_OP), st, []
        for _ in steps:
            s1, m = one(s1, batch)
            out[key]["one_steps"].append(
                {"new": as_np(s1), "metrics": {k: float(v) for k, v in m.items()}})
pickle.dump(out, open(OUT, "wb"))
"""


def both(archs, tmp, shapes=SHAPES, rows: int = 2, variants=None, timeout: float = 150,
         tcfg=None, overrides=None, lr: float = LR, steps: int = 1,
         reference_one: bool = False):
    """{(arch, shape): (reference new state, its metrics, port sharded new
    state, its metrics, port one-device new state, its metrics)} for every
    arch on every (data, model) mesh shape, from the reference's state and
    a batch of ``rows`` rows; ``variants`` ({name: (archs, shapes,
    TrainerConfig kwargs, ModelConfig overrides[, the port's own
    overrides])}) adds (arch, shape, name) keys. Each value also carries
    whether every rank's new leaves had their local shapes after every step
    (``[6]``), a step each the same six (``[7]``), and rank 0's digest of
    its last gathered state and its shard codes against one process's
    (``[9]``, ``_torch_dist_cases.tp_steps``). ``tcfg`` and
    ``overrides`` (TrainerConfig kwargs and ModelConfig overrides), ``lr``
    and ``steps`` hold for every run; a bf16 run's reference step is
    compiled with ``_torch_train_parity.PER_OP``. ``reference_one`` (bf16
    runs): ``[8]`` holds the reference's own one-device steps from the
    same state, (new state, metrics) a step."""
    tkw0, ov0 = tcfg or {}, overrides or {}
    extra = {"lr": lr, "steps": steps, "reference_one": reference_one}
    runs = [((a, s), a, s, tkw0, ov0, {}) for a in archs for s in shapes]
    for name, (v_archs, v_shapes, tkw, ov, *port) in (variants or {}).items():
        runs += [((a, s, name), a, s, {**tkw0, **tkw}, {**ov0, **ov}, port[0] if port else {})
                 for a in v_archs for s in v_shapes]
    ref = {}
    # one reference process per arch, side by side: XLA compiles each step
    # on one core, and the compiles are most of the time
    with concurrent.futures.ThreadPoolExecutor() as pool:
        for part in pool.map(lambda a: run_jax(
                f"REPO = {REPO!r}\nRUNS = {[r[:5] + (extra,) for r in runs if r[1] == a]!r}\n"
                f"ROWS = {rows}\n" + _REFERENCE, 4, tmp), sorted({r[1] for r in runs})):
            ref.update(part)
    args = [{"arch": a, "shape": s, "tcfg": tkw, "overrides": ov, "port": port,
             "state": ref[k]["state"], "batch": ref[k]["batch"], **extra}
            for k, a, s, tkw, ov, port in runs]
    got = run_ranks("tp_steps", 4, tmp, timeout=timeout, runs=args, lr=LR)
    out = {}
    for i, (key, *_rest) in enumerate(runs):
        r, g = ref[key], got[0][i]
        shapes_ok = all(rank[i] is None or rank[i]["local_shapes"] for rank in got)
        per_step = [(_ns(rs["new"]), rs["metrics"], _port(gs["tp"]), gs["tp_metrics"],
                     _port(gs["one"]), gs["one_metrics"])
                    for rs, gs in zip(r["steps"], g["steps"])]
        one_ref = [(_ns(rs["new"]), rs["metrics"]) for rs in r.get("one_steps", ())]
        out[key] = (*per_step[0], shapes_ok, per_step, one_ref,
                    {"codes": g.get("codes"), "digest": g.get("digest")})
    return out


def _ns(state: dict):
    return types.SimpleNamespace(**state)


def _port(state: dict):
    """A rank's state as numpy (bf16 leaves as ``ml_dtypes.bfloat16``
    arrays) → the port's ``TrainState``, every leaf's bits as the rank
    produced them."""
    from repro_torch.convert import params_from_jax
    from repro_torch.train import TrainState

    def conv(tree):
        return None if tree is None else params_from_jax(tree, "cpu")

    return TrainState(params=conv(state["params"]), wq=conv(state["wq"]),
                      opt_state=conv(state["opt_state"]), residuals=None,
                      step=torch.tensor(state["step"], dtype=torch.int32))


def _key(arch, shape, variant):
    return (arch, shape) if variant is None else (arch, shape, variant)


def check_reference(results, arch, shape, variant=None):
    """The port's sharded step against the reference's GSPMD step on the
    same mesh shape: ``assert_step_matches``'s tolerances (loss rtol 2e-6)."""
    jnew, jm, new, m = results[_key(arch, shape, variant)][:4]
    assert_step_matches(jnew, jm, new, m)


def check_one_device(results, arch, shape, variant=None):
    """The port's sharded step against its own one-device step from the
    same state, to the same tolerances (the one-device state as the
    reference)."""
    _, _, new, m, one, m1 = results[_key(arch, shape, variant)][:6]
    ref = types.SimpleNamespace(params=_np(one.params), wq=_np(one.wq),
                                opt_state=_np(one.opt_state), step=int(one.step))
    assert_step_matches(ref, m1, new, m)


def check_reference_bf16(results, arch, shape, variant=None, **tol):
    """Each bf16 step of the port's sharded run against the reference's
    GSPMD step on the same mesh shape: the first within
    ``assert_bf16_step_matches``'s tolerances (``tol`` widens them where a
    caller states why), with the params where |g| < 1e-6 held to Adam's
    ill-conditioned bound as the fp32 check holds them (the vlm's cross
    norms have |g| ≈ 1e-8, Adam's ε); each later one within
    ``assert_bf16_later_step_matches``'s."""
    for i, (jnew, jm, new, m, *_) in enumerate(results[_key(arch, shape, variant)][7], 1):
        if i == 1:
            assert_bf16_step_matches(jnew, jm, new, m, g_floor=1e-6, **tol)
        else:
            assert_bf16_later_step_matches(jnew, jm, new, m, i, **{
                k: v for k, v in tol.items() if k in ("m_tol", "v_tol")})


def _one_np(one):
    return types.SimpleNamespace(params=_np(one.params), wq=_np(one.wq),
                                 opt_state=_np(one.opt_state), step=int(one.step))


def reference_gap(jmesh, jmm, jone, jom) -> dict:
    """The reference's own gap between its mesh step and its one-device
    step: relative on the loss and grad norm, and Adam's m and v as the
    worst leaf's max |Δ| over its largest |value|."""
    gap = {k: abs(jmm[k] - jom[k]) / abs(jom[k]) for k in ("loss", "grad_norm")}
    for name in ("m", "v"):
        gap[name] = max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
                        for a, b in pairs(jmesh.opt_state[name], jone.opt_state[name]))
    return gap


def check_one_device_bf16(results, arch, shape, variant=None):
    """Each bf16 step of the port's sharded run against the port's own
    one-device steps from the same state. The tolerances are
    ``check_reference_bf16``'s, each widened to twice the reference's own
    gap between its GSPMD step on this mesh and its one-device step
    (``both(..., reference_one=True)``) where that is larger: a cut over
    "model" makes each rank's row-parallel product a bf16 partial that the
    all-reduce sums, a rounding the one-device product does not make, and
    the reference's partitioned step makes the same one (gemma3-4b's loss
    moves 8.5e-5 against its one-device step in both packages, zamba2's
    Adam v 29ε in the reference's)."""
    entry = results[_key(arch, shape, variant)]
    for i, ((jnew, jm, new, m, one, m1), (jone, jom)) in enumerate(zip(entry[7], entry[8]), 1):
        gap = reference_gap(jnew, jm, jone, jom)
        first = i == 1
        tol = {"loss_rtol": max(2.0 ** (-14 if first else -13), 2 * gap["loss"]),
               "gn_rtol": max(EPS / (4 if first else 2), 2 * gap["grad_norm"]),
               "m_tol": max(8 * EPS, 2 * gap["m"]), "v_tol": max(16 * EPS, 2 * gap["v"])}
        if first:
            assert_bf16_step_matches(_one_np(one), m1, new, m, g_floor=1e-6, **tol)
        else:
            assert_bf16_later_step_matches(_one_np(one), m1, new, m, i, **tol)
