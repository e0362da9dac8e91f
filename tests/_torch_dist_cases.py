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
from repro_torch.tree import tree_leaves, tree_map


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
    the "data" axis of a (world, 1) mesh, the state made on the mesh (its
    "data" entries cut, FSDP): the step's losses."""
    from repro_torch.train import TrainerConfig, init_train_state, make_train_step

    mesh = make_mesh((world, 1), ("data", "model"), device="cpu")
    cfg = get_reduced("deepseek-moe-16b", moe_impl="a2a", moe_wire="int8", capacity_factor=16.0,
                      mesh_batch_axes=("data",), mesh_ep_axis="data")
    tcfg, opt = TrainerConfig(qat=True, pod_compression=False), adam(2e-3)
    state = init_train_state(cfg, tcfg, opt, seed=0, device="cpu", mesh=mesh)
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


# --------------------------------------------------------------------------
# Tensor parallelism over the "model" axis.
# --------------------------------------------------------------------------


def tp_basics(rank, world, *, device="cpu"):
    """On a (1, world) data x model mesh: the four conjugate functions
    forward and backward; shard/gather round trips of params and of a
    TrainState; FTTQ's QAT forward, its backward, init_wq_tree and
    ternary_stats on shards against the whole leaves; the global norm; the
    vocab-parallel cross entropy against the plain one; and one step of the
    moe, ssm and hybrid families against one device."""
    from repro_torch.core import fttq
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.transformer import param_shapes
    from repro_torch.optim import global_norm
    from repro_torch.parallel.sharding import param_specs
    from repro_torch.parallel.tensor import (
        copy_to_model, gather_from_model, gather_state, gather_tree, model_axis, param_shards,
        reduce_from_model, scatter_to_model, shard_state, shard_tree, vocab_parallel_ce,
    )
    from repro_torch.train import TrainerConfig, init_train_state, make_train_step
    from repro_torch.train.checkpoint import flatten
    from repro_torch.tree import flatten_with_path

    mesh = make_mesh((1, world), ("data", "model"), device=device)
    dev, tp = mesh.device, model_axis(mesh)
    out = {}
    def run(fn, x, upstream):
        x = x.detach().requires_grad_(True)
        y = fn(x)
        y.backward(upstream)
        return y.detach().cpu().numpy(), x.grad.cpu().numpy()

    x = torch.arange(6.0, device=dev).reshape(2, 3) + 10 * rank
    g = torch.full((2, 3), float(rank + 1), device=dev)
    wide = torch.arange(6.0 * world, device=dev).reshape(2, 3 * world)
    out["copy"] = run(lambda t: copy_to_model(t, tp), x, g)
    out["reduce"] = run(lambda t: reduce_from_model(t, tp), x, g)
    out["gather"] = run(lambda t: gather_from_model(t, tp, 1), x, wide)
    out["scatter"] = run(lambda t: scatter_to_model(t, tp, 1), wide, g)

    out["trees"] = {}
    for arch in ("olmo-1b", "granite-20b"):
        cfg = get_reduced(arch)
        specs = param_specs(cfg, mesh)
        whole = init_params(cfg, seed=0, device=dev)
        shards = shard_tree(whole, specs, mesh)
        back = gather_tree(shards, specs, mesh)
        state = init_train_state(cfg, TrainerConfig(), adam(1e-3), seed=0, device=dev,
                                 n_pods=2)
        state_back = gather_state(shard_state(state, specs, mesh), specs, mesh)
        out["trees"][arch] = {
            "round_trip": all(torch.equal(a, b) for (_, a), (_, b) in
                              zip(flatten_with_path(whole), flatten_with_path(back))),
            "state_round_trip": all(
                (a is None and b is None) or torch.equal(a, b)
                for (_, a), (_, b) in zip(flatten(state), flatten(state_back))),
            "local_shapes": all(tuple(x.shape) == s for x, s in zip(
                [x for _, x in flatten_with_path(shards)],
                [s for _, s in flatten_with_path(param_shapes(cfg, mesh),
                                                 is_leaf=lambda t: isinstance(t, tuple))])),
            "shard_shapes": {"/".join(str(k) for _, k in p): tuple(x.shape)
                             for p, x in flatten_with_path(shards)}}

    # FTTQ on shards vs the whole leaves (granite: wk/wv split mid-head)
    cfg = get_reduced("granite-20b")
    specs, sh = param_specs(cfg, mesh), param_shards(cfg, mesh)
    fcfg = fttq.FTTQConfig()
    whole = init_params(cfg, seed=3, device=dev)
    wq = fttq.init_wq_tree(whole, fcfg)
    gen = torch.Generator(dev).manual_seed(7)
    up = tree_map(lambda p: torch.randn(p.shape, generator=gen, device=dev), whole)
    up_sh = shard_tree(up, specs, mesh)

    def qat(params, w, upstream, **kw):
        ps = tree_map(lambda t: t.detach().requires_grad_(True), params)
        ws = tree_map(lambda t: t.detach().requires_grad_(True), w)
        q = fttq.quantize_tree(ps, ws, fcfg, **kw)
        loss = sum((a * b).sum() for a, b in zip(
            [t for _, t in flatten_with_path(q)], [t for _, t in flatten_with_path(upstream)]))
        loss.backward()
        return (tree_map(lambda t: t.detach(), q), tree_map(lambda t: t.grad, ps),
                tree_map(lambda t: t.grad, ws))

    q0, gp0, gw0 = qat(whole, wq, up)
    q1, gp1, gw1 = qat(shard_tree(whole, specs, mesh), wq, up_sh, shards=sh)
    q1, gp1 = gather_tree(q1, specs, mesh), gather_tree(gp1, specs, mesh)
    out["fttq"] = {"q": (_np(q0), _np(q1)), "g_theta": (_np(gp0), _np(gp1)),
                   "g_wq": (_np(gw0), _np(gw1)),
                   "init_wq": (_np(wq), _np(fttq.init_wq_tree(shard_tree(whole, specs, mesh),
                                                              fcfg, sh))),
                   "stats": (fttq.ternary_stats(whole, fcfg),
                             fttq.ternary_stats(shard_tree(whole, specs, mesh), fcfg, sh)),
                   "norm": (float(global_norm(up)),
                            float(global_norm(up_sh, shards=sh)))}

    # the vocab-parallel cross entropy against the plain one
    v = 128
    logits = torch.randn(3, 5, v, generator=gen, device=dev) * 3
    labels = torch.randint(0, v, (3, 5), generator=gen, device=dev)
    one = torch.ones((), device=dev)
    ce0, g0 = run(lambda t: -torch.gather(torch.log_softmax(t, -1), -1,
                                          labels[..., None]).mean(), logits, one)
    ce1, g1 = run(lambda t: vocab_parallel_ce(t, labels, tp).mean(),
                  logits.chunk(world, -1)[rank].contiguous(), one)
    out["ce"] = (float(ce0), float(ce1), g0,
                 gather_from_model(torch.from_numpy(g1).to(dev), tp, -1).cpu().numpy())

    # wk/wv left whole by the guard (2 kv-head dims of 15 do not split over
    # 2 ranks) while wq splits by heads: every rank selects its kv head
    from repro_torch.parallel.tensor import shard_state as _shard_state

    cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=32, vocab_size=64,
                      n_heads=2, n_kv_heads=1, head_dim=15, d_ff=64, use_rope=False)
    tcfg = TrainerConfig(pod_compression=False)
    state = init_train_state(cfg, tcfg, adam(1e-3), seed=0, device=dev)
    batch = {"tokens": torch.randint(0, 64, (2, 8), generator=gen, device=dev),
             "labels": torch.randint(0, 64, (2, 8), generator=gen, device=dev)}
    specs = param_specs(cfg, mesh)
    new1, m1 = make_train_step(cfg, tcfg, adam(1e-3), mesh=mesh)(
        _shard_state(state, specs, mesh), batch)
    new0, m0 = make_train_step(cfg, tcfg, adam(1e-3))(state, batch)
    out["whole_kv"] = {"spec_wk": tuple(specs["blocks"]["attn"]["wk"]),
                       "spec_wq": tuple(specs["blocks"]["attn"]["wq"]),
                       "loss": (float(m0["loss"]), float(m1["loss"])),
                       "params": (_np(new0.params), _np(gather_state(new1, specs, mesh).params)),
                       "m": _np(new0.opt_state["m"])}

    # the families that raised before their tensor parallelism was ported
    out["steps"] = {}
    for arch in ("qwen3-moe-30b-a3b", "mamba2-370m", "zamba2-1.2b"):
        cfg = get_reduced(arch)
        tcfg = TrainerConfig(pod_compression=False)
        batch = {"tokens": torch.randint(0, 128, (2, 8), generator=gen, device=dev),
                 "labels": torch.randint(0, 128, (2, 8), generator=gen, device=dev)}
        state = init_train_state(cfg, tcfg, adam(1e-3), seed=0, device=dev, mesh=mesh)
        _, m1 = make_train_step(cfg, tcfg, adam(1e-3), mesh=mesh)(state, batch)
        state = init_train_state(cfg, tcfg, adam(1e-3), seed=0, device=dev)
        _, m0 = make_train_step(cfg, tcfg, adam(1e-3))(state, batch)
        logits, _ = make_prefill_step(cfg, 8, mesh=mesh)(
            init_params(cfg, seed=0, device=dev, mesh=mesh), {"tokens": batch["tokens"]})
        out["steps"][arch] = {"loss": (float(m0["loss"]), float(m1["loss"])),
                              "logits_shape": tuple(logits.shape)}
    return out


def _state_np(state) -> dict:
    return {"params": _np(state.params), "wq": _np(state.wq) if state.wq is not None else None,
            "opt_state": _np(state.opt_state), "step": int(state.step),
            "residuals": _np(state.residuals) if state.residuals is not None else None}


def tp_steps(rank, world, *, runs, lr):
    """For each run (arch, (data, model) mesh shape, TrainerConfig kwargs,
    ModelConfig overrides, reference state and batch): one train step on
    that mesh from the state's shards, gathered into whole leaves, and the
    port's one-device step from the same state; every rank of the mesh
    reports whether its new leaves had their local shapes, rank 0 also both
    steps."""
    from repro_torch.models.transformer import param_shapes
    from repro_torch.parallel.sharding import param_specs
    from repro_torch.parallel.tensor import gather_state, shard_state
    from repro_torch.train import TrainerConfig, make_train_step
    from repro_torch.train.checkpoint import flatten
    from repro_torch.tree import flatten_with_path, path_str

    out = []
    for run in runs:
        shape = tuple(run["shape"])
        n = shape[0] * shape[1]
        mesh = make_mesh(shape, ("data", "model"), ranks=range(n), device="cpu")
        if not mesh.member:
            out.append(None)
            continue
        cfg = get_reduced(run["arch"], **run.get("overrides", {}))
        tcfg = TrainerConfig(pod_compression=False, **run.get("tcfg", {}))
        state = _state(run["state"], "cpu")
        batch = {k: torch.from_numpy(v) for k, v in run["batch"].items()}
        specs = param_specs(cfg, mesh)
        new, m = make_train_step(cfg, tcfg, adam(lr), mesh=mesh)(
            shard_state(state, specs, mesh), batch)
        local = {path_str(p): tuple(v) for p, v in flatten_with_path(
            param_shapes(cfg, mesh), is_leaf=lambda x: isinstance(x, tuple))}
        shapes_ok = all(tuple(x.shape) == local[name[len(prefix):]]
                        for name, x in flatten(new)
                        for prefix in (".params/", ".opt_state/m/", ".opt_state/v/")
                        if name.startswith(prefix))
        new = gather_state(new, specs, mesh)
        if rank != 0:
            out.append({"local_shapes": shapes_ok})
            continue
        new0, m0 = make_train_step(cfg, tcfg, adam(lr))(state, batch)
        out.append({"local_shapes": shapes_ok, "tp": _state_np(new),
                    "tp_metrics": {k: float(v) for k, v in m.items()},
                    "one": _state_np(new0), "one_metrics": {k: float(v) for k, v in m0.items()}})
    return out


def tp_pods(rank, world, *, cfg, state, batch, lr, steps, trees, residuals_in=None,
            mesh_shape=(2, 1, 2), tcfg=None):
    """On a pod x data x model mesh of ``mesh_shape`` ((2, 1, 2), or (2,
    2, 1) for pods x FSDP): (a) the compressed collective with error
    feedback over ``trees`` (per step, each pod's whole gradient tree) on
    this rank's shards, kernel path and plain version, gathered over
    "model" and "data"; each step takes the residuals the last one left, or
    with ``residuals_in`` (per step, a tree of (n_pods, *shape) leaves) this
    pod's of those; (b) ``steps`` compressed QAT steps (``tcfg``: more
    TrainerConfig kwargs) from the reference's state, gathered over "pod",
    "model" and "data"."""
    from repro_torch.parallel.collectives import ternary_allreduce_tree_plain
    from repro_torch.parallel.sharding import param_specs
    from repro_torch.parallel.tensor import (
        gather_state, gather_tree, param_shards, shard_state, shard_tree,
    )
    from repro_torch.train import TrainerConfig, init_train_state, make_train_step
    from repro_torch.train.trainer import gather_residuals

    cfg = ModelConfig(**cfg)
    mesh = make_mesh(tuple(mesh_shape), AXES, device="cpu")
    pod = mesh.index("pod")
    specs, sh = param_specs(cfg, mesh), param_shards(cfg, mesh)
    group = mesh.group("pod")
    out = {"collective": [], "plain": []}
    res = res_p = None
    for k, step in enumerate(trees):
        grads = shard_tree(_torch(step[pod], "cpu"), specs, mesh)
        if residuals_in is not None:
            res = res_p = shard_tree(tree_map(lambda a: a[pod], _torch(residuals_in[k], "cpu")),
                                     specs, mesh)
        reset_wire_bytes()
        synced, res = ternary_allreduce_tree(grads, group, residuals=res, shards=sh)
        wire = wire_bytes()
        synced_p, res_p = ternary_allreduce_tree_plain(grads, group, residuals=res_p,
                                                       shards=sh)
        out["collective"].append({"synced": _np(gather_tree(synced, specs, mesh)),
                                  "res": _np(gather_tree(res, specs, mesh)), "wire": wire})
        out["plain"].append({"synced": _np(gather_tree(synced_p, specs, mesh)),
                             "res": _np(gather_tree(res_p, specs, mesh))})
    tcfg, opt = TrainerConfig(qat=True, pod_compression=True, error_feedback=True,
                              **(tcfg or {})), adam(lr)
    s = _state(state, "cpu")
    fresh = init_train_state(cfg, tcfg, opt, params=s.params, device="cpu", n_pods=2, mesh=mesh)
    s = dataclasses.replace(shard_state(s, specs, mesh), residuals=fresh.residuals)
    # each step's compressed input (gradient plus residual) of this rank's
    # pod, gathered over "data" and "model": where a code sits at Δ
    import repro_torch.train.trainer as trainer_mod

    synced_inputs, sync = [], trainer_mod.ternary_allreduce_tree

    def recorded(g_p, grp, *, residuals=None, **kw):
        res = iter(tree_leaves(residuals))
        x = tree_map(lambda g: g.to(torch.float32) + next(res), g_p)
        synced_inputs.append(_np(gather_tree(x, specs, mesh)))
        return sync(g_p, grp, residuals=residuals, **kw)

    trainer_mod.ternary_allreduce_tree = recorded
    step_fn = make_train_step(cfg, tcfg, opt, mesh=mesh)
    b = {k: v.to(torch.int64) for k, v in _torch(batch, "cpu").items()}
    losses = []
    for _ in range(steps):
        s, m = step_fn(s, b)
        losses.append(float(m["loss"]))
    trainer_mod.ternary_allreduce_tree = sync
    s = gather_state(gather_residuals(s, mesh), specs, mesh)
    out["train"] = {"losses": losses, **_state_np(s), "synced_inputs": synced_inputs}
    return out


def tp_serve(rank, world, *, params, toks, emb, vis, max_seq, gen, ckpt, lr, batch):
    """On a (1, world) data x model mesh: (a) each arch's prefill and
    greedy decode steps (``launch/steps.py`` with the mesh) from the
    reference's whole ``params`` cut to this rank's shards, beside the
    one-device steps; (b) a TrainState of olmo-1b saved from its shards,
    raw and ternary, under ``ckpt``/tp-*, and on rank 0 the one-device
    saves under ``ckpt``/one-*, then restored to shards; (c) a TP step from
    the state re-placed as DTensors by ``elastic_reshard`` against the step
    from ``shard_state``, and the TP result re-placed onto a one-rank mesh
    against a one-device step."""
    from repro_torch.core.compression import CodecSpec
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.parallel.sharding import NamedSharding, P, param_shardings, param_specs
    from repro_torch.parallel.tensor import gather_state, shard_state
    from repro_torch.train import (
        TrainerConfig, init_train_state, make_train_step, restore_checkpoint, save_checkpoint,
    )
    from repro_torch.train.checkpoint import flatten
    from repro_torch.train.fault import elastic_reshard

    mesh = make_mesh((1, world), ("data", "model"), device="cpu")
    out = {"serve": {}}
    for arch, p_np in params.items():
        cfg = get_reduced(arch)
        specs = param_specs(cfg, mesh)
        whole = _torch(p_np, "cpu")
        shards = params_from_jax(p_np, "cpu", mesh=mesh, specs=specs)
        b = ({"embeds": torch.from_numpy(emb)} if cfg.family == "audio"
             else {"tokens": torch.from_numpy(toks).long()})
        if cfg.family == "vlm":
            b["vision_embeds"] = torch.from_numpy(vis)
        got = {}
        for name, p, m in (("tp", shards, mesh), ("one", whole, None)):
            logits, cache = make_prefill_step(cfg, max_seq, mesh=m)(p, b)
            steps, tokens = [logits.numpy()], []
            if cache is not None:
                tok = torch.argmax(logits, -1)
                decode = make_decode_step(cfg, mesh=m)
                for i in range(gen):
                    tokens.append(tok.numpy())
                    step_b = {"tokens": tok, "cache": cache, "pos": toks.shape[1] + i}
                    if "vision_embeds" in b:
                        step_b["vision_embeds"] = b["vision_embeds"]
                    logits, cache = decode(p, step_b)
                    steps.append(logits.numpy())
                    tok = torch.argmax(logits, -1)
            got[name] = {"logits": steps, "tokens": tokens,
                         "cache_k": tuple(cache["k"].shape) if cache is not None else None}
        out["serve"][arch] = got

    cfg = get_reduced("olmo-1b")
    specs = param_specs(cfg, mesh)
    tcfg, opt = TrainerConfig(pod_compression=False), adam(lr)
    state = init_train_state(cfg, tcfg, opt, seed=0, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    state, _ = make_train_step(cfg, tcfg, opt)(state, b)      # moments that are not zero
    tp_state = shard_state(state, specs, mesh)
    tern = CodecSpec(kind="ternary")
    save_checkpoint(f"{ckpt}/tp-raw", 1, tp_state, mesh=mesh, specs=specs)
    save_checkpoint(f"{ckpt}/tp-tern", 1, tp_state.params, compression=tern, mesh=mesh,
                    specs=specs)
    if rank == 0:
        save_checkpoint(f"{ckpt}/one-raw", 1, state)
        save_checkpoint(f"{ckpt}/one-tern", 1, state.params, compression=tern)
    dist.barrier()
    back, _ = restore_checkpoint(f"{ckpt}/tp-raw", example_state=tp_state, device="cpu",
                                 mesh=mesh, specs=specs)
    out["restored_equal"] = all(
        (x is None and y is None) or torch.equal(x, y)
        for (_, x), (_, y) in zip(flatten(back), flatten(tp_state)))
    out["state"] = {"params": _np(state.params), "opt_state": _np(state.opt_state)}

    step = make_train_step(cfg, tcfg, opt, mesh=mesh)
    new_tp, m_tp = step(tp_state, b)
    shard1, repl = param_shardings(cfg, mesh), NamedSharding(mesh, P())
    placed = dataclasses.replace(
        state, params=elastic_reshard(state.params, shard1), wq=elastic_reshard(state.wq, repl),
        opt_state={"step": elastic_reshard(state.opt_state["step"], repl),
                   "m": elastic_reshard(state.opt_state["m"], shard1),
                   "v": elastic_reshard(state.opt_state["v"], shard1)},
        step=elastic_reshard(state.step, repl))
    new_dt, m_dt = step(placed, b)
    same = lambda u, v: all((x is None and y is None) or torch.equal(x, y)
                            for (_, x), (_, y) in zip(flatten(u), flatten(v)))
    out["dtensor_step_identical"] = same(new_dt, new_tp) and float(m_dt["loss"]) == float(
        m_tp["loss"])
    host = gather_state(new_tp, specs, mesh)
    mesh1 = make_mesh((1, 1), ("data", "model"), ranks=[0], device="cpu")
    mesh1.device_mesh                       # every rank builds the DeviceMesh together
    if rank == 0:
        shard_1 = param_shardings(cfg, mesh1)
        repl_1 = NamedSharding(mesh1, P())
        on1 = dataclasses.replace(
            host, params=elastic_reshard(host.params, shard_1), wq=elastic_reshard(host.wq, repl_1),
            opt_state={"step": elastic_reshard(host.opt_state["step"], repl_1),
                       "m": elastic_reshard(host.opt_state["m"], shard_1),
                       "v": elastic_reshard(host.opt_state["v"], shard_1)},
            step=elastic_reshard(host.step, repl_1))
        n1, m1 = make_train_step(cfg, tcfg, opt, mesh=mesh1)(on1, b)
        n0, m0 = make_train_step(cfg, tcfg, opt)(host, b)
        out["one_rank_step_identical"] = same(n1, n0) and float(m1["loss"]) == float(m0["loss"])
    return out


def _grads(fn, leaves: list, upstream) -> tuple:
    """(fn(*leaves) detached, the gradient of <fn(...), upstream> for each
    leaf)."""
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    y = fn(*leaves)
    g = torch.autograd.grad((y * upstream).sum(), leaves)
    return y.detach(), list(g)


def _count_collectives():
    """A wrapper of torch.distributed's all_reduce and all_gather that counts
    the calls into the dict it returns with the restore function."""
    counts = {"all_reduce": 0, "all_gather": 0}
    saved = {name: getattr(dist, name) for name in counts}

    def counting(name):
        def call(*a, **kw):
            counts[name] += 1
            return saved[name](*a, **kw)
        return call

    for name in counts:
        setattr(dist, name, counting(name))

    def restore():
        for name, fn in saved.items():
            setattr(dist, name, fn)
    return counts, restore


def tp_families(rank, world, *, ckpt, lr, batch, gen_steps):
    """On a (1, world) data x model mesh, each against one device: (a) the
    MoE layer (qwen3-moe; deepseek-moe with shared experts; deepseek-moe
    with 5 experts, which the guard leaves whole) forward and backward, and
    the routing every rank computed; (b) the Mamba2 block (mamba2; with one
    SSM head, which leaves in_proj whole; with d_model 63 and expand 1, which
    leaves every leaf whole) forward and backward; (c) zamba2's loss forward
    and backward with its collectives counted, and its shared block on a
    cache; (d) FTTQ on expert, Mamba and shared-block shards; (e) prefill and
    greedy decode of mamba2, zamba2 and qwen3-moe on shards that
    ``params_from_jax`` cut from the whole params; (f) a deepseek-moe
    TrainState saved from shards, raw and ternary, beside the one-device
    saves on rank 0, and restored; (g) a TP step of it from the state
    re-placed by ``elastic_reshard``."""
    from repro_torch.core import fttq
    from repro_torch.core.compression import CodecSpec
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.models.mamba2 import mamba_block
    from repro_torch.parallel.sharding import NamedSharding, P, param_shardings, param_specs
    from repro_torch.parallel.sharding import model_dims
    from repro_torch.parallel.tensor import (
        gather_from_model, gather_state, gather_tree, model_axis, param_shards, shard_state,
    )
    from repro_torch.train import (
        TrainerConfig, init_train_state, make_train_step, restore_checkpoint, save_checkpoint,
    )
    from repro_torch.train.checkpoint import flatten
    from repro_torch.train.fault import elastic_reshard
    from repro_torch.tree import flatten_with_path

    mesh = make_mesh((1, world), ("data", "model"), device="cpu")
    tp = model_axis(mesh)
    gen = torch.Generator().manual_seed(11)
    out = {}

    def layer0(tree):
        return tree_map(lambda t: t[0], tree)

    def gathered(grads, dims):
        """The leaves' gradients made whole: gathered where ``dims`` shards
        them."""
        return [g if d is None else gather_from_model(g, tp, d) for g, d in zip(grads, dims)]

    # (a) the MoE layer
    out["moe"] = {}
    for name, cfg in (("qwen3", get_reduced("qwen3-moe-30b-a3b")),
                      ("deepseek", get_reduced("deepseek-moe-16b")),
                      ("deepseek_whole_experts", get_reduced("deepseek-moe-16b", n_experts=5))):
        whole = layer0(init_params(cfg, seed=1, device="cpu")["blocks"]["moe"])
        shards = layer0(init_params(cfg, seed=1, device="cpu", mesh=mesh)["blocks"]["moe"])
        dims = tfm._layer_dims(cfg, world)["moe"]
        x = torch.randn(2, 8, cfg.d_model, generator=gen)
        up = torch.randn(2, 8, cfg.d_model, generator=gen)
        kw = dict(top_k=cfg.top_k, capacity_factor=cfg.capacity_factor)
        paths = [p for p, _ in flatten_with_path(whole)]
        seen, route = [], moe_mod.route

        def recording(probs, k):
            gates, idx = route(probs, k)
            seen.append(idx.clone())
            return gates, idx

        def run(params, **extra):
            leaves = [t for _, t in flatten_with_path(params)]

            def fn(x, *ls):
                ps = dict(zip(paths, ls))
                rebuilt = tree_map_paths(params, ps)
                o, aux = moe_mod.moe(rebuilt, x, **kw, **extra)
                return o + aux
            return _grads(fn, [x] + leaves, up)

        moe_mod.route = recording
        try:
            y0, g0 = run(whole)
            y1, g1 = run(shards, tp=tp, dims=dims)
        finally:
            moe_mod.route = route
        dmap = dict(flatten_with_path(dims))
        leaf_dims = [None] + [dmap.get(p) for p in paths]
        out["moe"][name] = {
            "y": (y0.numpy(), y1.numpy()),
            "grads": ([g.numpy() for g in g0], [g.numpy() for g in gathered(g1, leaf_dims)]),
            "idx": seen[1].numpy(), "idx_one": seen[0].numpy(),
            "split": {k: v for k, v in (("experts", dims["w_in"]),
                                        ("shared", dims.get("shared", {}).get("w_in")))}}

    # (b) the Mamba2 block
    out["mamba"] = {}
    for name, cfg in (("mamba2", get_reduced("mamba2-370m")),
                      ("one_head", get_reduced("mamba2-370m", ssm_heads=1)),
                      ("odd", get_reduced("mamba2-370m", d_model=63, ssm_expand=1, ssm_heads=3))):
        whole = layer0(init_params(cfg, seed=1, device="cpu")["blocks"]["mamba"])
        shards = layer0(init_params(cfg, seed=1, device="cpu", mesh=mesh)["blocks"]["mamba"])
        dims = tfm._layer_dims(cfg, world)["mamba"]
        x = torch.randn(2, 8, cfg.d_model, generator=gen)
        up = torch.randn(2, 8, cfg.d_model, generator=gen)
        kw = dict(n_heads=cfg.ssm_heads, d_state=cfg.ssm_state, expand=cfg.ssm_expand,
                  conv_width=cfg.conv_width, chunk=cfg.ssm_chunk)
        names = sorted(whole)

        def run(params, **extra):
            def fn(x, *ls):
                return mamba_block(dict(zip(names, ls)), x, **kw, **extra)[0]
            return _grads(fn, [x] + [params[k] for k in names], up)

        y0, g0 = run(whole)
        y1, g1 = run(shards, tp=tp, dims=dims)
        out["mamba"][name] = {
            "y": (y0.numpy(), y1.numpy()),
            "grads": ([g.numpy() for g in g0],
                      [g.numpy() for g in gathered(g1, [None] + [dims[k] for k in names])]),
            "dims": {k: dims[k] for k in ("in_proj", "conv_w", "out_proj")}}

    # (c) zamba2: the loss with its collectives counted; the shared block on a cache
    cfg = get_reduced("zamba2-1.2b")
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen)
    b = {"tokens": tokens, "labels": torch.randint(0, cfg.vocab_size, (2, 8), generator=gen)}
    whole = init_params(cfg, seed=2, device="cpu")
    for leaf in (whole["blocks"]["norm"], whole["shared_attn"]["attn_norm"]):
        leaf.normal_(generator=gen)            # norms that are not all ones
    shards = shard_tree_(whole, cfg, mesh)

    def loss_grads(params, tp_):
        leaves = [t.detach().requires_grad_(True) for _, t in flatten_with_path(params)]
        rebuilt = tree_map_paths(params, dict(zip([p for p, _ in flatten_with_path(params)],
                                                  leaves)))
        loss, _ = tfm.loss_fn(cfg, rebuilt, b, tp_)
        return float(loss), torch.autograd.grad(loss, leaves)

    l0, g0 = loss_grads(whole, None)
    counts, restore = _count_collectives()
    try:
        l1, g1 = loss_grads(shards, tp)
    finally:
        restore()
    specs = param_specs(cfg, mesh)
    g1 = gather_tree(tree_map_paths(shards, dict(zip([p for p, _ in flatten_with_path(shards)],
                                                     g1))), specs, mesh)
    out["zamba2"] = {"loss": (l0, l1), "grads": ([g.numpy() for g in g0],
                                                 [t.numpy() for _, t in flatten_with_path(g1)]),
                     "counts": dict(counts), "apps": cfg.n_attn_apps}
    hd = cfg.resolved_head_dim
    kv0 = tuple(torch.zeros(2, 12, cfg.n_kv_heads, hd) for _ in range(2))
    kv1 = tuple(torch.zeros(2, 12, cfg.n_kv_heads // world, hd) for _ in range(2))
    x = torch.randn(2, 8, cfg.d_model, generator=gen)
    with torch.no_grad():
        y0 = tfm._shared_attn_layer(cfg, whole["shared_attn"], x, kv0, 0)
        y1 = tfm._shared_attn_layer(cfg, shards["shared_attn"], x, kv1, 0, tp)
    out["zamba2"]["shared"] = {"y": (y0.numpy(), y1.numpy()),
                               "k": (kv0[0].numpy(), gather_from_model(kv1[0], tp, 2).numpy())}

    # (d) FTTQ on the new shards against the whole leaves
    out["fttq"] = {}
    fcfg = fttq.FTTQConfig()
    for arch in ("deepseek-moe-16b", "zamba2-1.2b"):
        cfg = get_reduced(arch)
        specs, dims, sh = param_specs(cfg, mesh), model_dims(cfg, mesh), param_shards(cfg, mesh)
        whole = init_params(cfg, seed=3, device="cpu")
        wq = fttq.init_wq_tree(whole, fcfg)
        q0 = fttq.quantize_tree(whole, wq, fcfg)
        q1 = gather_tree(fttq.quantize_tree(shard_tree_(whole, cfg, mesh), wq, fcfg, sh),
                         specs, mesh)
        out["fttq"][arch] = {
            "q": (_np(q0), _np(q1)),
            "init_wq": (_np(wq), _np(fttq.init_wq_tree(shard_tree_(whole, cfg, mesh), fcfg,
                                                       sh))),
            "stats": (fttq.ternary_stats(whole, fcfg),
                      fttq.ternary_stats(shard_tree_(whole, cfg, mesh), fcfg, sh)),
            "sharded": sorted("/".join(str(k) for _, k in p)
                              for p, _ in flatten_with_path(dims))}

    # (e) prefill and greedy decode
    out["serve"] = {}
    for arch in ("mamba2-370m", "zamba2-1.2b", "qwen3-moe-30b-a3b"):
        cfg = get_reduced(arch)
        prompts = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen)
        whole = init_params(cfg, seed=4, device="cpu")
        shards = params_from_jax(_np(whole), "cpu", mesh=mesh, specs=param_specs(cfg, mesh))
        same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            flatten_with_path(shards),
            flatten_with_path(init_params(cfg, seed=4, device="cpu", mesh=mesh))))
        got = {"converted_shards_equal": same}
        for name, params, m in (("tp", shards, mesh), ("one", whole, None)):
            with torch.no_grad():
                logits, cache = make_prefill_step(cfg, 8 + gen_steps, mesh=m)(
                    params, {"tokens": prompts})
                decode = make_decode_step(cfg, mesh=m)
                steps, toks = [logits.numpy()], []
                for i in range(gen_steps):
                    tok = torch.argmax(logits, -1)
                    toks.append(tok.numpy())
                    logits, cache = decode(params, {"tokens": tok, "cache": cache, "pos": 8 + i})
                    steps.append(logits.numpy())
            got[name] = {"logits": steps, "tokens": toks,
                         "cache": {k: tuple(v.shape) for k, v in cache.items()}}
        out["serve"][arch] = got

    # (f) checkpoints of a deepseek-moe TrainState from its shards; (g) elastic_reshard
    cfg = get_reduced("deepseek-moe-16b")
    specs = param_specs(cfg, mesh)
    tcfg, opt = TrainerConfig(pod_compression=False), adam(lr)
    state = init_train_state(cfg, tcfg, opt, seed=0, device="cpu")
    bt = {k: torch.from_numpy(v) for k, v in batch.items()}
    state, _ = make_train_step(cfg, tcfg, opt)(state, bt)      # moments that are not zero
    tp_state = shard_state(state, specs, mesh)
    tern = CodecSpec(kind="ternary")
    save_checkpoint(f"{ckpt}/tp-raw", 1, tp_state, mesh=mesh, specs=specs)
    save_checkpoint(f"{ckpt}/tp-tern", 1, tp_state.params, compression=tern, mesh=mesh,
                    specs=specs)
    if rank == 0:
        save_checkpoint(f"{ckpt}/one-raw", 1, state)
        save_checkpoint(f"{ckpt}/one-tern", 1, state.params, compression=tern)
    dist.barrier()
    back, _ = restore_checkpoint(f"{ckpt}/tp-raw", example_state=tp_state, device="cpu",
                                 mesh=mesh, specs=specs)
    same = lambda u, v: all((x is None and y is None) or torch.equal(x, y)
                            for (_, x), (_, y) in zip(flatten(u), flatten(v)))
    out["restored_equal"] = same(back, tp_state)
    out["state"] = {"params": _np(state.params), "opt_state": _np(state.opt_state)}
    step = make_train_step(cfg, tcfg, opt, mesh=mesh)
    new_tp, m_tp = step(tp_state, bt)
    shard1, repl = param_shardings(cfg, mesh), NamedSharding(mesh, P())
    placed = dataclasses.replace(
        state, params=elastic_reshard(state.params, shard1), wq=elastic_reshard(state.wq, repl),
        opt_state={"step": elastic_reshard(state.opt_state["step"], repl),
                   "m": elastic_reshard(state.opt_state["m"], shard1),
                   "v": elastic_reshard(state.opt_state["v"], shard1)},
        step=elastic_reshard(state.step, repl))
    new_dt, m_dt = step(placed, bt)
    out["dtensor_step_identical"] = same(new_dt, new_tp) and float(m_dt["loss"]) == float(
        m_tp["loss"])
    new_one, m_one = make_train_step(cfg, tcfg, opt)(state, bt)
    out["step_vs_one"] = (float(m_one["loss"]), float(m_tp["loss"]),
                          _np(new_one.params), _np(gather_state(new_tp, specs, mesh).params))
    return out


def shard_tree_(whole, cfg, mesh):
    """This rank's shards of a whole params tree of ``cfg``."""
    from repro_torch.parallel.sharding import param_specs
    from repro_torch.parallel.tensor import shard_tree

    return shard_tree(whole, param_specs(cfg, mesh), mesh)


def tree_map_paths(tree, by_path: dict):
    """``tree`` with each leaf replaced by ``by_path[its path]``."""
    from repro_torch.tree import tree_map_with_path

    return tree_map_with_path(lambda p, _: by_path[p], tree)


def tp_family_steps(rank, world, *, device="cpu"):
    """On a (1, world) data x model mesh on ``device``: one TP train step of
    deepseek-moe (local experts, shared experts split) and zamba2 (gathered
    Mamba2 weights, the shared block split) from the seed-0 state's shards,
    gathered, beside the one-device step from the same state."""
    from repro_torch.parallel.sharding import param_specs
    from repro_torch.parallel.tensor import gather_state, shard_state
    from repro_torch.train import TrainerConfig, init_train_state, make_train_step

    mesh = make_mesh((1, world), ("data", "model"), device=device)
    dev = mesh.device
    gen = torch.Generator(dev).manual_seed(5)
    out = {}
    for arch in ("deepseek-moe-16b", "zamba2-1.2b"):
        cfg = get_reduced(arch)
        tcfg, opt = TrainerConfig(pod_compression=False), adam(3e-3)
        batch = {k: torch.randint(0, cfg.vocab_size, (2, 16), generator=gen, device=dev)
                 for k in ("tokens", "labels")}
        state = init_train_state(cfg, tcfg, opt, seed=0, device=dev)
        specs = param_specs(cfg, mesh)
        new, m = make_train_step(cfg, tcfg, opt, mesh=mesh)(shard_state(state, specs, mesh),
                                                              batch)
        new = gather_state(new, specs, mesh)
        new0, m0 = make_train_step(cfg, tcfg, opt)(state, batch)
        out[arch] = {"loss": (float(m0["loss"]), float(m["loss"])),
                     "params": (_np(new0.params), _np(new.params)),
                     "m": _np(new0.opt_state["m"])}
    return out


# --------------------------------------------------------------------------
# FSDP over the "data" axis.
# --------------------------------------------------------------------------


def _fttq_vs_whole(arch, mesh, dev, seed=3):
    """FTTQ on this rank's shards of ``arch``'s seed-``seed`` params on
    ``mesh`` against the whole leaves: {name: (whole result, shard result
    gathered or reduced)} for the QAT forward, its backward (θ and w_q),
    init_wq_tree, ternary_stats and the global norm."""
    from repro_torch.core import fttq
    from repro_torch.optim import global_norm
    from repro_torch.parallel.sharding import param_specs
    from repro_torch.parallel.tensor import gather_tree, param_shards, shard_tree
    from repro_torch.tree import flatten_with_path

    cfg = get_reduced(arch)
    specs, sh = param_specs(cfg, mesh), param_shards(cfg, mesh)
    fcfg = fttq.FTTQConfig()
    whole = init_params(cfg, seed=seed, device=dev)
    wq = fttq.init_wq_tree(whole, fcfg)
    gen = torch.Generator(dev).manual_seed(7)
    up = tree_map(lambda p: torch.randn(p.shape, generator=gen, device=dev), whole)
    up_sh = shard_tree(up, specs, mesh)

    def qat(params, w, upstream, **kw):
        ps = tree_map(lambda t: t.detach().requires_grad_(True), params)
        ws = tree_map(lambda t: t.detach().requires_grad_(True), w)
        q = fttq.quantize_tree(ps, ws, fcfg, **kw)
        loss = sum((a * b).sum() for a, b in zip(
            [t for _, t in flatten_with_path(q)], [t for _, t in flatten_with_path(upstream)]))
        loss.backward()
        return (tree_map(lambda t: t.detach(), q), tree_map(lambda t: t.grad, ps),
                tree_map(lambda t: t.grad, ws))

    q0, gp0, gw0 = qat(whole, wq, up)
    q1, gp1, gw1 = qat(shard_tree(whole, specs, mesh), wq, up_sh, shards=sh)
    q1, gp1 = gather_tree(q1, specs, mesh), gather_tree(gp1, specs, mesh)
    return {"q": (_np(q0), _np(q1)), "g_theta": (_np(gp0), _np(gp1)),
            "g_wq": (_np(gw0), _np(gw1)),
            "init_wq": (_np(wq), _np(fttq.init_wq_tree(shard_tree(whole, specs, mesh), fcfg,
                                                       sh))),
            "stats": (fttq.ternary_stats(whole, fcfg),
                      fttq.ternary_stats(shard_tree(whole, specs, mesh), fcfg, sh)),
            "norm": (float(global_norm(up)), float(global_norm(up_sh, shards=sh))),
            "cut": {p: tuple(a.name for a, _ in c) for p, c in sh.cuts.items()}}


def fsdp_basics(rank, world, *, ckpt, batch, lr, max_seq, gen):
    """On a (world, 1) data x model mesh: (a) the gather / reduce-scatter
    pair forward and backward; (b) ``reduce_scatter`` against an all-reduce
    then a slice, and its bytes; (c) FTTQ, ternary_stats and the global
    norm on data shards against the whole leaves, and on four ranks on
    (2, 2) data x model shards too; (d) one train step from the seed-0
    state's shards against one device (the clip's norm, the w_q step);
    (e) the step's ``ValueError`` for a whole state; with two ranks (f) a
    TrainState saved from its shards, raw and ternary, under ``ckpt``/fsdp-*
    and on rank 0 the one-device saves under ``ckpt``/one-*, restored to
    shards, and (g) prefill and greedy decode on the data shards against one
    device; with four ranks (h) ``elastic_reshard`` of a (2, 2) state onto
    (1, 2) and onto (2, 1)."""
    from repro_torch.core.compression import CodecSpec
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.parallel.collectives import all_reduce_, reduce_scatter
    from repro_torch.parallel.sharding import NamedSharding, P, param_shardings, param_specs
    from repro_torch.parallel.tensor import (
        data_axis, gather_from_data, gather_rows, gather_state, param_shards, shard_state,
    )
    from repro_torch.train import (
        TrainerConfig, init_train_state, make_train_step, restore_checkpoint, save_checkpoint,
    )
    from repro_torch.train.checkpoint import flatten
    from repro_torch.train.fault import elastic_reshard

    mesh = make_mesh((world, 1), ("data", "model"), device="cpu")
    ax, group = data_axis(mesh), mesh.group("data")
    out = {}
    x = torch.arange(6.0).reshape(2, 3) + 10 * rank
    up = torch.arange(6.0 * world).reshape(2, 3 * world) * (rank + 1)
    for dim, upstream in ((1, up), (0, up.reshape(2 * world, 3))):
        xg = x.clone().requires_grad_(True)
        y = gather_from_data(xg, ax, dim)
        y.backward(upstream)
        out[f"pair{dim}"] = (y.detach().numpy(), xg.grad.numpy())

    t = torch.arange(4.0 * world * 3).reshape(4 * world, 3) * (rank + 1) - 5
    reset_wire_bytes()
    rs0 = reduce_scatter(t, group, 0)
    wire = wire_bytes()
    rs1 = reduce_scatter(t.T.contiguous(), group, 1)
    want = all_reduce_(t.clone(), group).chunk(world, 0)[rank]
    out["reduce_scatter"] = {"dim0": (rs0.numpy(), want.numpy()),
                             "dim1": (rs1.numpy(), want.T.numpy()),
                             "again": torch.equal(reduce_scatter(t, group, 0), rs0),
                             "wire": wire, "bytes": t.numel() * 4}

    meshes = [mesh] + ([make_mesh((2, 2), ("data", "model"), device="cpu")] if world == 4 else [])
    out["fttq"] = {(m.size("data"), m.size("model")): {
        arch: _fttq_vs_whole(arch, m, "cpu") for arch in ("granite-20b", "qwen3-moe-30b-a3b")}
        for m in meshes}

    cfg = get_reduced("olmo-1b")
    specs = param_specs(cfg, mesh)
    tcfg, opt = TrainerConfig(pod_compression=False), adam(lr)
    b = {k: torch.from_numpy(v).to(torch.int64) for k, v in batch.items()}
    state = init_train_state(cfg, tcfg, opt, seed=0, device="cpu")
    step = make_train_step(cfg, tcfg, opt, mesh=mesh)
    new, m = step(init_train_state(cfg, tcfg, opt, seed=0, device="cpu", mesh=mesh), b)
    new0, m0 = make_train_step(cfg, tcfg, opt)(state, b)
    host = gather_state(new, specs, mesh)
    out["step"] = {"loss": (float(m0["loss"]), float(m["loss"])),
                   "grad_norm": (float(m0["grad_norm"]), float(m["grad_norm"])),
                   "wq": (_np(new0.wq), _np(host.wq)),
                   "params": (_np(new0.params), _np(host.params)),
                   "m": _np(new0.opt_state["m"]),
                   "shards": {p: c for p, c in ((p, tuple(a.name for a, _ in c)) for p, c in
                                                param_shards(cfg, mesh).cuts.items())}}
    try:
        step(state, b)
        out["layout_error"] = None
    except ValueError as e:
        out["layout_error"] = str(e)

    if world == 2:
        # (f) checkpoints of a state with moments that are not zero
        fsdp_state = shard_state(new0, specs, mesh)
        tern = CodecSpec(kind="ternary")
        save_checkpoint(f"{ckpt}/fsdp-raw", 1, fsdp_state, mesh=mesh, specs=specs)
        save_checkpoint(f"{ckpt}/fsdp-tern", 1, fsdp_state.params, compression=tern, mesh=mesh,
                        specs=specs)
        if rank == 0:
            save_checkpoint(f"{ckpt}/one-raw", 1, new0)
            save_checkpoint(f"{ckpt}/one-tern", 1, new0.params, compression=tern)
        dist.barrier()
        back, _ = restore_checkpoint(f"{ckpt}/fsdp-raw", example_state=fsdp_state,
                                     device="cpu", mesh=mesh, specs=specs)
        out["restored_equal"] = all(
            (u is None and v is None) or torch.equal(u, v)
            for (_, u), (_, v) in zip(flatten(back), flatten(fsdp_state)))
        out["state"] = {"params": _np(new0.params), "opt_state": _np(new0.opt_state)}

        # (g) prefill and decode
        out["serve"] = {}
        g = torch.Generator().manual_seed(3)
        for arch in ("olmo-1b", "qwen3-moe-30b-a3b", "zamba2-1.2b", "llama-3.2-vision-11b"):
            acfg = get_reduced(arch)
            whole = init_params(acfg, seed=4, device="cpu")
            shards = params_from_jax(_np(whole), "cpu", mesh=mesh,
                                     specs=param_specs(acfg, mesh))
            same = all(torch.equal(u, v) for (_, u), (_, v) in zip(
                flatten(shards), flatten(init_params(acfg, seed=4, device="cpu", mesh=mesh))))
            prompts = torch.randint(0, acfg.vocab_size, (2, 8), generator=g)
            vis = (torch.randn(2, acfg.n_patches, acfg.d_model, generator=g) * 0.02
                   if acfg.family == "vlm" else None)
            got = {"converted_shards_equal": same}
            for name, p, msh in (("fsdp", shards, mesh), ("one", whole, None)):
                bb = {"tokens": prompts}
                if vis is not None:
                    bb["vision_embeds"] = vis
                # each rank serves its row of the two; gathered for the check
                logits, cache = make_prefill_step(acfg, max_seq, mesh=msh)(p, bb)
                steps, toks = [gather_rows(logits, msh).numpy()], []
                decode = make_decode_step(acfg, mesh=msh)
                for i in range(gen):
                    tok = torch.argmax(logits, -1)
                    toks.append(gather_rows(tok, msh).numpy())
                    sb = {"tokens": tok, "cache": cache, "pos": 8 + i}
                    if vis is not None:
                        sb["vision_embeds"] = vis
                    logits, cache = decode(p, sb)
                    steps.append(gather_rows(logits, msh).numpy())
                got[name] = {"logits": steps, "tokens": toks,
                             "cache_rows": next(iter(cache.values())).shape[1]}
            out["serve"][arch] = got

    if world == 4:
        # (h) a (2, 2) FSDP x TP state re-placed onto (1, 2) and (2, 1)
        mesh22 = meshes[1]
        specs22 = param_specs(cfg, mesh22)
        s22, _ = make_train_step(cfg, tcfg, opt, mesh=mesh22)(shard_state(new0, specs22, mesh22), b)
        host = gather_state(s22, specs22, mesh22)
        same = lambda u, v: all((a is None and c is None) or torch.equal(a, c)
                                for (_, a), (_, c) in zip(flatten(u), flatten(v)))
        out["elastic"] = {}
        for shape in ((1, 2), (2, 1)):
            small = make_mesh(shape, ("data", "model"), ranks=[0, 1], device="cpu")
            small.device_mesh                 # every rank builds the DeviceMesh together
            if not small.member:
                continue
            sp, shard = param_specs(cfg, small), param_shardings(cfg, small)
            repl = NamedSharding(small, P())
            placed = dataclasses.replace(
                host, params=elastic_reshard(host.params, shard), wq=elastic_reshard(host.wq, repl),
                opt_state={"step": elastic_reshard(host.opt_state["step"], repl),
                           "m": elastic_reshard(host.opt_state["m"], shard),
                           "v": elastic_reshard(host.opt_state["v"], shard)},
                step=elastic_reshard(host.step, repl))
            small_step = make_train_step(cfg, tcfg, opt, mesh=small)
            n_dt, m_dt = small_step(placed, b)
            n_sh, m_sh = small_step(shard_state(host, sp, small), b)
            out["elastic"][shape] = same(n_dt, n_sh) and float(m_dt["loss"]) == float(m_sh["loss"])
    return out


def fsdp_step(rank, world, *, device="cpu"):
    """On a (world, 1) data x model mesh on ``device``: one FSDP train step
    of olmo-1b and qwen3-moe-30b-a3b (reduced) from the seed-0 state made on
    the mesh, gathered, beside the one-device step from the same state; the
    step's all-gather and reduce-scatter bytes."""
    from repro_torch.parallel.sharding import param_specs
    from repro_torch.parallel.tensor import gather_state, state_cuts
    from repro_torch.train import TrainerConfig, init_train_state, make_train_step
    from repro_torch.train.checkpoint import flatten

    mesh = make_mesh((world, 1), ("data", "model"), device=device)
    dev = mesh.device
    gen = torch.Generator(dev).manual_seed(5)
    out = {}
    for arch in ("olmo-1b", "qwen3-moe-30b-a3b"):
        cfg = get_reduced(arch)
        tcfg, opt = TrainerConfig(pod_compression=False), adam(3e-3)
        batch = {k: torch.randint(0, cfg.vocab_size, (2 * world, 16), generator=gen,
                                  device=dev) for k in ("tokens", "labels")}
        specs = param_specs(cfg, mesh)
        state = init_train_state(cfg, tcfg, opt, seed=0, device=dev, mesh=mesh)
        reset_wire_bytes()
        new, m = make_train_step(cfg, tcfg, opt, mesh=mesh)(state, batch)
        wire = wire_bytes()
        new = gather_state(new, specs, mesh)
        new0, m0 = make_train_step(cfg, tcfg, opt)(
            init_train_state(cfg, tcfg, opt, seed=0, device=dev), batch)
        data_cut = [x.numel() for (_, x), cut in zip(flatten(new0.params),
                                                      state_cuts(new0.params, specs, mesh))
                    if any(a.name == "data" for a, _ in cut)]
        out[arch] = {"loss": (float(m0["loss"]), float(m["loss"])),
                     "params": (_np(new0.params), _np(new.params)),
                     "m": _np(new0.opt_state["m"]), "wire": wire,
                     "data_cut_bytes": 4 * sum(data_cut)}
    return out


def serve_rows(rank, world, *, runs, params, prompts, max_seq, gen, chunks):
    """For each run (arch, (data, model) mesh shape, global batch): the
    prefill (in ``chunks`` chunks) and ``gen`` greedy decode steps on that
    mesh from the arch's whole params' shards, each rank feeding back its
    own rows' tokens; the logits gathered over the rows
    (``gather_rows``), the greedy tokens and this rank's cache leaf shapes.
    None on a rank off the mesh."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.parallel.sharding import param_specs
    from repro_torch.parallel.tensor import gather_rows

    out = []
    for run in runs:
        shape, b = tuple(run["shape"]), run["batch"]
        mesh = make_mesh(shape, ("data", "model"), ranks=range(shape[0] * shape[1]),
                         device="cpu")
        if not mesh.member:
            out.append(None)
            continue
        cfg = get_reduced(run["arch"])
        p = params_from_jax(params[run["arch"]], "cpu", mesh=mesh,
                            specs=param_specs(cfg, mesh))
        toks = torch.from_numpy(prompts[run["arch"]][:b]).long()
        with torch.no_grad():
            logits, cache = make_prefill_step(cfg, max_seq, chunks=chunks, mesh=mesh)(
                p, {"tokens": toks})
            decode = make_decode_step(cfg, mesh=mesh, batch=b)
            steps, tokens = [gather_rows(logits, mesh, b).numpy()], []
            for i in range(gen):
                tok = torch.argmax(logits, -1)
                tokens.append(gather_rows(tok, mesh, b).numpy())
                logits, cache = decode(p, {"tokens": tok, "cache": cache,
                                           "pos": toks.shape[1] + i})
                steps.append(gather_rows(logits, mesh, b).numpy())
        out.append({"logits": steps, "tokens": tokens,
                    "cache": {k: tuple(v.shape) for k, v in cache.items()}})
    return out


def combine(rank, world, *, q, k, v, k_len, window, device="cpu"):
    """``combine_softmax`` over a (2, 2) data x model mesh: this rank's
    quarter of the keys (rank-major slots, as a cache cut over ("data",
    "model") holds them) as a partial (``attention._partial``, masked by
    global position and by ``k_len``), combined over "data" then "model",
    against one softmax over every key on this rank."""
    from repro_torch.models.attention import GLOBAL_WINDOW, _mask_bias, _partial
    from repro_torch.parallel.tensor import combine_softmax, data_axis, model_axis

    mesh = make_mesh((2, 2), ("data", "model"), device=device)
    q, k, v = (torch.from_numpy(a).to(device) for a in (q, k, v))
    sq, sk = q.shape[1], k.shape[1]
    per = sk // 4
    q_pos = (k_len - sq) + torch.arange(sq, device=device)
    k_pos = torch.arange(sk, device=device)
    win = window or GLOBAL_WINDOW
    own = slice(rank * per, (rank + 1) * per)
    m, l, acc = _partial(q, k[:, own], v[:, own], q_pos, k_pos[own], causal=True, window=win,
                         k_len=k_len)
    got = combine_softmax(m, l, acc, (data_axis(mesh), model_axis(mesh)))
    bias = _mask_bias(q_pos, k_pos, causal=True, window=win) + torch.where(
        k_pos[None, :] < k_len, 0.0, -1e30)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q, k) * (q.shape[-1] ** -0.5) + bias
    want = torch.einsum("bhgqk,bkhd->bhgqd", torch.softmax(scores, -1), v)
    return {"got": got.cpu().numpy(), "want": want.cpu().numpy(),
            "empty": bool((l == 0).all())}


def seq_attention(rank, world, *, device):
    """Batch-1 prefill and greedy decode of granite-20b (MQA) and gemma3-4b
    (sliding window), reduced, from the seed-0 params, with the cache's
    sequence cut over two ranks: "model" on a (1, 2) mesh (granite) and
    "data" on a (2, 1) mesh (both); on ``device`` and on the CPU, the
    logits of each step, from the same seed-0 params drawn on the CPU."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.parallel.sharding import param_specs
    from repro_torch.parallel.tensor import shard_tree

    out = {}
    for arch, shape in (("granite-20b", (1, 2)), ("granite-20b", (2, 1)),
                        ("gemma3-4b", (2, 1))):
        cfg = get_reduced(arch)
        whole = init_params(cfg, seed=0, device="cpu")
        got = {}
        for dev in (device, "cpu"):
            mesh = make_mesh(shape, ("data", "model"), device=dev)
            p = tree_map(lambda t: t.to(dev), shard_tree(whole, param_specs(cfg, mesh), mesh))
            toks = torch.arange(6, device=dev)[None] % cfg.vocab_size
            with torch.no_grad():
                logits, cache = make_prefill_step(cfg, 16, chunks=2, mesh=mesh)(
                    p, {"tokens": toks})
                decode = make_decode_step(cfg, mesh=mesh, batch=1)
                steps = [logits.cpu().numpy()]
                for i in range(7):
                    logits, cache = decode(p, {"tokens": torch.argmax(logits, -1),
                                               "cache": cache, "pos": 6 + i})
                    steps.append(logits.cpu().numpy())
            got[dev] = {"logits": steps, "slots": cache["k"].shape[2]}
        out[f"{arch}-{shape}"] = got
    return out


CASES = {f.__name__: f for f in (collectives, fanin, trainer, elastic, moe_forward, moe_train,
                                  q8_a2a, tp_basics, tp_steps, tp_pods, tp_serve, tp_families,
                                  tp_family_steps, fsdp_basics, fsdp_step, serve_rows, combine,
                                  seq_attention)}


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
