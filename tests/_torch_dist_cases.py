"""One rank of a multi-device test: ``python _torch_dist_cases.py <case>
<rank> <world> <dir>``. Joins a ``gloo`` group through ``file://<dir>/rdv``,
reads its arguments from ``<dir>/args.pkl``, runs ``<case>`` and pickles
what it returns (numpy arrays and numbers) to ``<dir>/out<rank>.pkl``.
Imports torch and the port only (``tests/_torch_dist.py`` starts it)."""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import sys

import torch
import torch.distributed as dist

from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_jax
from repro_torch.launch.mesh import AXES, make_mesh
from repro_torch.parallel.collectives import set_mesh
from repro_torch.models.transformer import ModelConfig, forward, init_params
from repro_torch.optim import adam
from repro_torch.parallel.collectives import (
    reset_wire_bytes, ternary_allreduce, ternary_allreduce_tree, ternary_allreduce_tree_plain,
    wire_bytes,
)
from repro_torch.tree import tree_map


def _np(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _torch(tree, device):
    return params_from_jax(tree, device)


def collectives(rank, world, *, single, steps, device="cpu"):
    """``ternary_allreduce`` on this pod's ``single[rank]``, then
    ``ternary_allreduce_tree`` with error feedback over ``steps`` (each a
    list of per-pod gradient trees); each step also through the plain
    version from the same inputs (the kernel path's residuals)."""
    mesh = make_mesh((world,), ("pod",), device=device)
    group = mesh.group("pod")
    reset_wire_bytes()
    mean, _ = ternary_allreduce(torch.from_numpy(single[rank]).to(mesh.device), group)
    out = {"single": _np(mean), "single_wire": wire_bytes(), "steps": [], "plain": []}
    res = None
    for step in steps:
        grads = _torch(step[rank], mesh.device)
        synced_p, res_p = ternary_allreduce_tree_plain(grads, group, residuals=res)
        reset_wire_bytes()
        synced, res = ternary_allreduce_tree(grads, group, residuals=res)
        out["steps"].append({"synced": _np(synced), "res": _np(res), "wire": wire_bytes()})
        out["plain"].append({"synced": _np(synced_p), "res": _np(res_p)})
    return out


def fanin(rank, world, *, stacked, coeffs, staged, seg_coeffs, nbytes, n_out, c_odd,
          device="cpu"):
    """The sharded folds (sum and vote; stacked and segment forms) and a
    fold of ``c_odd`` clients, which the axis does not divide."""
    from repro_torch.kernels.aggregate import fanin_table, packed_weighted_sum
    from repro_torch.kernels.vote import packed_vote_counts
    from repro_torch.parallel.fanin import (
        fanin_vote_counts, fanin_vote_counts_segments, fanin_weighted_sum,
        fanin_weighted_sum_segments,
    )

    mesh = make_mesh((world,), ("data",), device=device)
    dev = mesh.device
    st, co = torch.from_numpy(stacked).to(dev), torch.from_numpy(coeffs).to(dev)
    sg, sc = torch.from_numpy(staged).to(dev), torch.from_numpy(seg_coeffs).to(dev)
    table = fanin_table(nbytes, n_out, dev)
    before = (packed_weighted_sum.launches, packed_vote_counts.launches)
    out = {
        "sum": fanin_weighted_sum(st, co, mesh=mesh),
        "vote": fanin_vote_counts(st, co, mesh=mesh),
        "sum_segments": fanin_weighted_sum_segments(sg, sc, table, mesh=mesh),
        "vote_segments": fanin_vote_counts_segments(sg, co, table, mesh=mesh),
        "sum_odd": fanin_weighted_sum(st[:c_odd], co[:c_odd], mesh=mesh),
    }
    out = _np(out)
    out["launches"] = (packed_weighted_sum.launches - before[0],
                       packed_vote_counts.launches - before[1])
    return out


def _tcfg(kw):
    from repro_torch.train import TrainerConfig

    return TrainerConfig(**kw)


def _state(state_np, device):
    from repro_torch.train import TrainState

    return TrainState(params=_torch(state_np["params"], device),
                      wq=_torch(state_np["wq"], device) if state_np["wq"] is not None else None,
                      opt_state=_torch(state_np["opt_state"], device), residuals=None,
                      step=torch.tensor(state_np["step"], dtype=torch.int32, device=device))


def trainer(rank, world, *, cfg, runs, state, batch, lr, steps):
    """The multi-pod step on a (world, 1, 1) mesh for each TrainerConfig
    of ``runs``, from the reference's initial ``state``."""
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.trainer import gather_residuals

    cfg = ModelConfig(**cfg)
    mesh = make_mesh((world, 1, 1), AXES, device="cpu")
    b = _torch(batch, "cpu")
    b = {k: v.to(torch.int64) for k, v in b.items()}
    out = {}
    for name, kw in runs.items():
        tcfg, opt = _tcfg(kw), adam(lr)
        s = _state(state, "cpu")
        fresh = init_train_state(cfg, tcfg, opt, params=s.params, device="cpu",
                                 n_pods=world, mesh=mesh)
        s = dataclasses.replace(s, residuals=fresh.residuals)
        step = make_train_step(cfg, tcfg, opt, mesh=mesh)
        losses = []
        for _ in range(steps):
            s, m = step(s, b)
            losses.append(float(m["loss"]))
        s = gather_residuals(s, mesh)
        out[name] = {"losses": losses, "params": _np(s.params),
                     "residuals": _np(s.residuals) if s.residuals is not None else None,
                     "wq": _np(s.wq)}
    return out


def elastic(rank, world, *, cfg, tcfg, batch, lr):
    """One compressed step on 2 pods from the port's seed-0 state, every
    pod's residuals gathered, the whole state re-placed onto a 1-pod mesh
    of rank 0 (a pod lost), and one more step there, beside a one-process
    step from the same state."""
    from repro_torch.parallel.sharding import P, NamedSharding, param_shardings
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.checkpoint import flatten
    from repro_torch.train.fault import elastic_reshard
    from repro_torch.train.trainer import gather_residuals, local_state

    cfg, tcfg, opt = ModelConfig(**cfg), _tcfg(tcfg), adam(lr)
    b = {k: v.to(torch.int64) for k, v in _torch(batch, "cpu").items()}
    mesh2 = make_mesh((world, 1, 1), AXES, device="cpu")
    s = init_train_state(cfg, tcfg, opt, seed=0, device="cpu", n_pods=world, mesh=mesh2)
    s, m2 = make_train_step(cfg, tcfg, opt, mesh=mesh2)(s, b)
    host = gather_residuals(s, mesh2)
    mesh1 = make_mesh((1, 1), ("data", "model"), ranks=[0], device="cpu")
    mesh1.device_mesh                       # every rank builds the DeviceMesh together
    if rank != 0:
        return {"loss2": float(m2["loss"])}
    shard1, repl = param_shardings(cfg, mesh1), NamedSharding(mesh1, P())
    state1 = dataclasses.replace(
        host,
        params=elastic_reshard(host.params, shard1),
        wq=elastic_reshard(host.wq, repl),
        opt_state={"step": elastic_reshard(host.opt_state["step"], repl),
                   "m": elastic_reshard(host.opt_state["m"], shard1),
                   "v": elastic_reshard(host.opt_state["v"], shard1)},
        residuals=elastic_reshard(host.residuals, repl),
        step=elastic_reshard(host.step, repl))
    placed = [leaf for _, leaf in flatten(state1) if isinstance(leaf, torch.Tensor)]
    whole = [leaf for _, leaf in flatten(local_state(state1)) if isinstance(leaf, torch.Tensor)]
    before = [leaf for _, leaf in flatten(host) if isinstance(leaf, torch.Tensor)]
    new1, m1 = make_train_step(cfg, tcfg, opt, mesh=mesh1)(state1, b)
    new0, m0 = make_train_step(cfg, tcfg, opt)(host, b)
    after1 = [leaf for _, leaf in flatten(new1) if isinstance(leaf, torch.Tensor)]
    after0 = [leaf for _, leaf in flatten(new0) if isinstance(leaf, torch.Tensor)]
    return {"loss2": float(m2["loss"]), "loss1": float(m1["loss"]), "loss0": float(m0["loss"]),
            "all_dtensors": all(hasattr(x, "full_tensor") for x in placed),
            "n_leaves": len(before),
            "identical": len(whole) == len(before) and all(
                torch.equal(a, b_) for a, b_ in zip(whole, before)),
            "next_identical": len(after1) == len(after0) and all(
                torch.equal(a, b_) for a, b_ in zip(after1, after0)),
            "residual_shape": tuple(host.residuals["embed"]["table"].shape)}


def moe_forward(rank, world, *, tokens):
    """The a2a MoE forward on a (2, 2) data × model mesh (EP over "model",
    this rank's data rows), beside the scatter dispatch on the same rows;
    then the int8 wire beside the plain one."""
    mesh = make_mesh((2, world // 2), ("data", "model"), device="cpu")
    rows = torch.from_numpy(tokens).to(torch.int64).chunk(2)[mesh.index("data")]
    base = dict(capacity_factor=16.0, mesh_batch_axes=("data",), mesh_ep_axis="model")
    out = {}
    with set_mesh(mesh):
        cfg_g = get_reduced("qwen3-moe-30b-a3b", moe_impl="gspmd", **base)
        cfg_a = get_reduced("qwen3-moe-30b-a3b", moe_impl="a2a", **base)
        params = init_params(cfg_g, seed=0, device="cpu")
        lg, _, _ = forward(cfg_g, params, rows)
        la, _, _ = forward(cfg_a, params, rows)
        out["gap"] = float((la - lg).abs().max() / lg.abs().max())
        cfg_b = get_reduced("deepseek-moe-16b", moe_impl="a2a", moe_wire="bf16", **base)
        cfg_q = dataclasses.replace(cfg_b, moe_wire="int8")
        params = init_params(cfg_b, seed=0, device="cpu")
        reset_wire_bytes()
        lb, _, _ = forward(cfg_b, params, rows)
        wire_b = wire_bytes()["all_to_all"]
        reset_wire_bytes()
        lq, _, _ = forward(cfg_q, params, rows)
        wire_q = wire_bytes()["all_to_all"]
        out["rel_l2"] = float(torch.linalg.vector_norm(lb - lq) /
                              (torch.linalg.vector_norm(lb) + 1e-9))
        out["wire"] = (wire_b, wire_q)
    return out


def moe_train(rank, world, *, tokens, labels, steps):
    """QAT steps of deepseek-moe (reduced) with the int8 a2a wire, EP over
    the "data" axis of a (world, 1) mesh: the step's losses."""
    from repro_torch.train import TrainerConfig, init_train_state, make_train_step

    mesh = make_mesh((world, 1), ("data", "model"), device="cpu")
    cfg = get_reduced("deepseek-moe-16b", moe_impl="a2a", moe_wire="int8", capacity_factor=16.0,
                      mesh_batch_axes=("data",), mesh_ep_axis="data")
    tcfg, opt = TrainerConfig(qat=True, pod_compression=False), adam(2e-3)
    state = init_train_state(cfg, tcfg, opt, seed=0, device="cpu")
    step = make_train_step(cfg, tcfg, opt, mesh=mesh)
    batch = {"tokens": torch.from_numpy(tokens).to(torch.int64),
             "labels": torch.from_numpy(labels).to(torch.int64)}
    losses = []
    with set_mesh(mesh):
        for _ in range(steps):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
    return {"losses": losses}


def q8_a2a(rank, world, *, x):
    """``quantized_all_to_all`` of this rank's block of ``x`` over a
    (world,) "model" mesh, and ``_q8`` of it."""
    from repro_torch.models.moe_a2a import _q8, quantized_all_to_all

    mesh = make_mesh((world,), ("model",), device="cpu")
    block = torch.from_numpy(x).chunk(world)[rank].contiguous()
    q, s = _q8(block)
    out = quantized_all_to_all(block, mesh.group("model"))
    return {"out": out.numpy(), "q": q.numpy(), "s": s.numpy()}


CASES = {f.__name__: f for f in (collectives, fanin, trainer, elastic, moe_forward, moe_train,
                                  q8_a2a)}


def main() -> None:
    case, rank, world, work = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    with open(os.path.join(work, "args.pkl"), "rb") as f:
        kwargs = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{work}/rdv", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        out = CASES[case](rank, world, **kwargs)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(work, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main()
