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
from _torch_train_parity import LR, assert_step_matches

SHAPES = [(1, 2), (2, 2)]

_REFERENCE = """
import os, pickle, sys
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
for key, arch, shape, tkw, ov in RUNS:
    jcfg, cfg, st = T.reference_state(arch, tkw, **ov)
    batch = T.batch_np(cfg, ROWS)
    step = jax.jit(make_train_step(jcfg, TrainerConfig(pod_compression=False, **tkw),
                                   adam(T.LR)))
    mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    specs = param_specs(jcfg, mesh)
    put = lambda t, s: tm(lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp)), t, s)
    rep = lambda t: tm(lambda x: jax.device_put(x, NamedSharding(mesh, P())), t)
    placed = type(st)(params=put(st.params, specs), wq=rep(st.wq),
                      opt_state={"step": rep(st.opt_state["step"]),
                                 "m": put(st.opt_state["m"], specs),
                                 "v": put(st.opt_state["v"], specs)},
                      residuals=None, step=rep(st.step))
    b = {k: jax.device_put(v, NamedSharding(mesh, P("data"))) for k, v in batch.items()}
    with set_mesh(mesh):
        new, m = step(placed, b)
    out[key] = {"state": as_np(st), "batch": batch, "new": as_np(new),
                "metrics": {k: float(v) for k, v in m.items()}}
pickle.dump(out, open(OUT, "wb"))
"""


def both(archs, tmp, shapes=SHAPES, rows: int = 2, variants=None, timeout: float = 150):
    """{(arch, shape): (reference new state, its metrics, port sharded new
    state, its metrics, port one-device new state, its metrics)} for every
    arch on every (data, model) mesh shape, from the reference's state and
    a batch of ``rows`` rows; ``variants`` ({name: (archs, shapes,
    TrainerConfig kwargs, ModelConfig overrides[, the port's own
    overrides])}) adds (arch, shape, name) keys. Each value also carries
    whether every rank's new leaves had their local shapes (``[6]``)."""
    runs = [((a, s), a, s, {}, {}, {}) for a in archs for s in shapes]
    for name, (v_archs, v_shapes, tkw, ov, *port) in (variants or {}).items():
        runs += [((a, s, name), a, s, tkw, ov, port[0] if port else {})
                 for a in v_archs for s in v_shapes]
    ref = {}
    # one reference process per arch, side by side: XLA compiles each step
    # on one core, and the compiles are most of the time
    with concurrent.futures.ThreadPoolExecutor() as pool:
        for part in pool.map(lambda a: run_jax(
                f"REPO = {REPO!r}\nRUNS = {[r[:5] for r in runs if r[1] == a]!r}\n"
                f"ROWS = {rows}\n" + _REFERENCE, 4, tmp), sorted({r[1] for r in runs})):
            ref.update(part)
    args = [{"arch": a, "shape": s, "tcfg": tkw, "overrides": ov, "port": port,
             "state": ref[k]["state"], "batch": ref[k]["batch"]}
            for k, a, s, tkw, ov, port in runs]
    got = run_ranks("tp_steps", 4, tmp, timeout=timeout, runs=args, lr=LR)
    out = {}
    for i, (key, *_rest) in enumerate(runs):
        r, g = ref[key], got[0][i]
        shapes_ok = all(rank[i] is None or rank[i]["local_shapes"] for rank in got)
        out[key] = (_ns(r["new"]), r["metrics"], _port(g["tp"]), g["tp_metrics"],
                    _port(g["one"]), g["one_metrics"], shapes_ok)
    return out


def _ns(state: dict):
    return types.SimpleNamespace(**state)


def _port(state: dict):
    from repro_torch.train import TrainState

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return None if tree is None else torch.from_numpy(np.asarray(tree))

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


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return None if tree is None else tree.numpy()
