"""The dry-run over the production mesh (port of ``repro.launch.dryrun``):
every (architecture × input shape × mesh) cell, per rank, without a card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --list
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k --mesh multi
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k \\
        --variant pod_compressed
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--only-missing]

The reference lowers and compiles each cell for 512 placeholder TPU
devices and reads XLA's memory and cost analyses. PyTorch has no compiler
that sees a whole step across ranks, so this runs **rank 0's program** in
one process instead:

- a ``"fake"`` process group of 256 (one pod) or 512 (two pods) ranks,
  torch's testing-internal one, whose collectives return at once
  (``_fake_world``), and the port's own ``make_mesh`` over it;
- the state (``init_train_state(..., mesh=)``) or the params
  (``init_params(..., mesh=)``), the batch and the cache made as this
  rank's shards under ``FakeTensorMode``: shapes and dtypes, no memory;
- the port's own train, prefill or decode step run once on them.

It counts, for that one rank:

- FLOPs with ``torch.utils.flop_counter.FlopCounterMode`` (matmuls,
  batched matmuls, convolutions, attention kernels);
- bytes moved: every aten op's tensor inputs and outputs, views aside
  (``_Traffic``). Nothing is fused, so this is an upper bound on HBM
  traffic, not a measurement;
- collective bytes and calls by kind, from ``parallel.collectives``'s
  counters (``wire_bytes``, ``wire_calls``): what this rank receives under
  the ring model those counters use;
- argument bytes exactly, from the local shards;
- a peak-live estimate: the storages the step makes, added as they appear
  and taken off when their last tensor is freed (weakref finalizers), on
  top of the arguments; a caching allocator's rounding and fragmentation
  are not in it.

The roofline's constants are the datasheet numbers of the NVIDIA H100
SXM5 80GB HBM3 at 700 W, not measurements: ``PEAK_FLOPS`` (dense bf16
tensor-core rate), ``HBM_BW`` (HBM3 bandwidth) and ``LINK_BW`` (one 400
Gb/s NDR InfiniBand link a GPU: the (16, 16) mesh leaves an 8-GPU NVLink
domain on every axis, so every collective crosses it). Cells whose step
fails record ``status: "error"`` with the traceback, as the reference
records its failures. The default variant runs the MoE cells through the
all-to-all dispatch with an int8 wire (EP over "model"); ``moe_gspmd``
runs the scatter dispatch instead. Records go to
``artifacts/dryrun_torch/`` in the reference's schema (keys with no torch
meaning, ``while_trip_counts`` and ``xla_cost_analysis_flops``, are
null).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCH_IDS, SHAPES, applicable, get_config
from repro_torch.launch.mesh import describe, make_mesh, make_production_mesh
from repro_torch.models.transformer import param_count

# NVIDIA H100 SXM5 80GB HBM3 (700 W) datasheet numbers, per GPU
PEAK_FLOPS = 989e12      # FLOP/s, bf16 dense (tensor cores, no sparsity)
HBM_BW = 3.35e12         # B/s, HBM3
LINK_BW = 50e9           # B/s, one 400 Gb/s NDR InfiniBand link

# gradient-accumulation chunks per arch for the train_4k cell (the
# reference's; batch 256 must stay divisible by microbatches × DP shards)
MICROBATCHES = {
    "granite-20b": 16, "yi-9b": 8, "llama-3.2-vision-11b": 8,
    "qwen3-moe-30b-a3b": 8, "deepseek-moe-16b": 8, "gemma3-4b": 4,
    "hubert-xlarge": 4, "olmo-1b": 2, "zamba2-1.2b": 4, "mamba2-370m": 8,
}

# chunked prefill (steps.make_prefill_step), the reference's
PREFILL_CHUNKS = {"qwen3-moe-30b-a3b": 4, "deepseek-moe-16b": 2}

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")


def active_param_count(cfg) -> int:
    """N_active: a MoE counts only its top-k routed experts (6·N_active·D)."""
    n = param_count(cfg)
    if cfg.n_experts:
        per_expert = 3 * cfg.d_model * cfg.moe_d_ff
        n -= cfg.n_layers * (cfg.n_experts - cfg.top_k) * per_expert
    return n


def model_flops(cfg, shape_name: str) -> float:
    spec = SHAPES[shape_name]
    n_act = active_param_count(cfg)
    d_tokens = spec.global_batch * spec.seq_len
    if spec.kind == "train":
        return 6.0 * n_act * d_tokens
    if spec.kind == "prefill":
        return 2.0 * n_act * d_tokens
    return 2.0 * n_act * spec.global_batch  # decode: one token per request


# --------------------------------------------------------------------------
# One rank of a mesh in one process.
# --------------------------------------------------------------------------


def _fake_world(n: int) -> None:
    """Make the default process group a one-process "fake" group of ``n``
    ranks, this process rank 0 (a group of another size is torn down)."""
    import torch.distributed as dist
    # torch's testing-internal fake backend
    # (torch/testing/_internal/distributed/fake_pg.py): importing it
    # registers "fake", whose collectives complete at once without data
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _tensors(tree) -> list:
    """The tensors under ``tree``: nested dicts, lists, tuples and
    dataclasses (a ``TrainState``)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return _tensors([getattr(tree, f.name) for f in dataclasses.fields(tree)])
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def held_bytes(tree) -> int:
    """Bytes of the distinct storages under ``tree`` (a tensor shared by two
    leaves counts once)."""
    seen = {}
    for t in _tensors(tree):
        seen.setdefault(_storage_key(t), t.untyped_storage().nbytes())
    return sum(seen.values())


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class _Traffic(TorchDispatchMode):
    """Per aten op, views aside, the bytes of its tensor inputs and outputs
    (an unfused upper bound on memory traffic); and the live bytes of the
    storages made while it is on, each added when it first appears and
    taken off when the last tensor over it is freed, above ``base`` (the
    bytes of the ``held`` storages: the step's arguments, which an in-place
    op may return)."""

    def __init__(self, base: int, held: set):
        super().__init__()
        self.moved = 0
        self.live = self.peak = base
        self._held = held
        self._storages: dict = {}
        self._tracked: set = set()

    def _drop(self, tid: int, key: int) -> None:
        self._tracked.discard(tid)
        entry = self._storages[key]
        entry[0] -= 1
        if entry[0] == 0:
            self.live -= entry[1]
            del self._storages[key]

    def _track(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if id(t) in self._tracked or key in self._held:
            return
        self._tracked.add(id(t))
        if key not in self._storages:
            self._storages[key] = [0, t.untyped_storage().nbytes()]
            self.live += self._storages[key][1]
            self.peak = max(self.peak, self.live)
        self._storages[key][0] += 1
        weakref.finalize(t, self._drop, id(t), key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = _tensors(out)
        if func.namespace == "aten" and not _is_view(func):
            self.moved += sum(_nbytes(t) for t in _tensors((args, kwargs)) + outs)
        for t in outs:
            self._track(t)
        return out


@dataclasses.dataclass(frozen=True)
class TrainKind:
    """A train cell's trainer settings (``estimate_step``)."""

    tcfg: object
    lr: float = 1e-4


def _batch(cfg, kind: str, b: int, s: int) -> dict:
    """The global batch a step takes (token ids int64), fake."""
    out: dict = {}
    if cfg.family == "audio":
        out["embeds"] = torch.zeros((b, s, cfg.d_model), dtype=cfg.cdtype())
    else:
        out["tokens"] = torch.zeros((b, s), dtype=torch.int64)
    if kind == "train":
        out["labels"] = torch.zeros((b, s), dtype=torch.int64)
    if cfg.family == "vlm":
        out["vision_embeds"] = torch.zeros((b, cfg.n_patches, cfg.d_model),
                                           dtype=cfg.cdtype())
    return out


def _rank0_mesh(mesh_shape: tuple, axes: tuple):
    """Rank 0 of a mesh of ``mesh_shape`` on a "fake" group of its ranks
    (None for one rank)."""
    n = math.prod(mesh_shape)
    if n == 1:
        return None
    _fake_world(n)
    return make_mesh(mesh_shape, axes, device="cpu")


def state_bytes(cfg, tcfg, mesh_shape: tuple, axes: tuple) -> int:
    """Rank 0's train-state bytes on a mesh of ``mesh_shape`` (params, w_q,
    Adam's moments and step, the pods' residuals): its shards made under
    ``FakeTensorMode`` on a "fake" group, as ``estimate_step`` makes them."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.optim import adam
    from repro_torch.train import init_train_state

    mesh = _rank0_mesh(mesh_shape, axes)
    with FakeTensorMode():
        state = init_train_state(cfg, tcfg, adam(1e-4), seed=0, device="cpu",
                                 n_pods=mesh.size("pod") if mesh is not None else 1,
                                 mesh=mesh)
        return held_bytes(state)


def _row_bytes(batch: dict, rows: int) -> int:
    """The bytes of ``rows`` of each leaf of a global batch."""
    return sum(_nbytes(v) // v.shape[0] * rows for v in batch.values())


def estimate_step(cfg, kind, batch_shape: tuple, mesh_shape: tuple, axes: tuple, *,
                  chunks: int = 1) -> dict:
    """Run rank 0's step of one cell once on fake shards and count it.

    ``kind``: a ``TrainKind`` (its ``TrainerConfig``), or "prefill" or
    "decode"; ``batch_shape``: (global batch, sequence) — for decode the
    cache's slots, the token at the last of them; ``mesh_shape``/``axes``:
    the mesh (a "fake" group of its ranks); ``chunks``: the prefill's.
    Returns {"memory", "hlo",
    "state_bytes", "state_parts" (by part: params, wq, m, v, residuals),
    "seconds"} for that rank."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.transformer import init_cache, init_params
    from repro_torch.optim import adam
    from repro_torch.parallel.collectives import reset_wire_bytes, wire_bytes, wire_calls
    from repro_torch.parallel.tensor import batch_ranks, serve_layout
    from repro_torch.train import init_train_state, make_train_step

    mesh = _rank0_mesh(mesh_shape, axes)
    b, s = batch_shape
    t0 = time.time()
    with FakeTensorMode():
        if isinstance(kind, TrainKind):
            opt = adam(kind.lr)
            n_pods = mesh.size("pod") if mesh is not None else 1
            state = init_train_state(cfg, kind.tcfg, opt, seed=0, device="cpu",
                                     n_pods=n_pods, mesh=mesh)
            batch = _batch(cfg, "train", b, s)
            step = make_train_step(cfg, kind.tcfg, opt, mesh=mesh)
            args = (state, batch)
            held = state
        else:
            params = init_params(cfg, seed=0, device="cpu", mesh=mesh)
            if kind == "prefill":
                batch = _batch(cfg, "prefill", b, s)
                step = make_prefill_step(cfg, s, chunks=chunks, mesh=mesh)
            else:
                lay = serve_layout(cfg, mesh, b)
                batch = {"tokens": torch.zeros((b // lay.n_rows, 1), dtype=torch.int64),
                         "cache": init_cache(cfg, b, s, cfg.cdtype(), device="cpu",
                                             mesh=mesh), "pos": s - 1}
                if cfg.family == "vlm":
                    batch["vision_embeds"] = torch.zeros(
                        (b // lay.n_rows, cfg.n_patches, cfg.d_model), dtype=cfg.cdtype())
                step = make_decode_step(cfg, mesh=mesh, batch=b)
            args = (params, batch)
            held = params
        state_bytes = held_bytes(held)
        parts = ({"params": held_bytes(held.params), "wq": held_bytes(held.wq),
                  "m": held_bytes(held.opt_state["m"]), "v": held_bytes(held.opt_state["v"]),
                  "residuals": held_bytes(held.residuals)}
                 if isinstance(kind, TrainKind) else {"params": state_bytes})
        if kind == "decode":
            arg_bytes = held_bytes(args)
        else:
            rows = b // (batch_ranks(mesh) if isinstance(kind, TrainKind)
                         else serve_layout(cfg, mesh, b).n_rows)
            arg_bytes = state_bytes + _row_bytes(batch, rows)
        base = held_bytes(args)
        in_keys = {_storage_key(t) for t in _tensors(args)}
        reset_wire_bytes()
        traffic = _Traffic(base, in_keys)
        grads = contextlib.nullcontext() if isinstance(kind, TrainKind) else torch.no_grad()
        with FlopCounterMode(display=False) as flops, traffic, grads:
            out = step(*args)
        alias = {}
        for t in _tensors(out):
            if _storage_key(t) in in_keys:
                alias.setdefault(_storage_key(t), t.untyped_storage().nbytes())
        out_bytes = held_bytes(out)
        del out
    coll, calls = wire_bytes(), wire_calls()
    return {
        "memory": {
            "argument_bytes_per_device": arg_bytes,
            "output_bytes_per_device": out_bytes,
            "temp_bytes_per_device": traffic.peak - base,
            "alias_bytes_per_device": sum(alias.values()),
            "peak_estimate_gb": round(traffic.peak / 1e9, 3),
            "peak_estimate_bytes": traffic.peak,
        },
        "hlo": {
            "flops_per_device": float(flops.get_total_flops()),
            "bytes_per_device": float(traffic.moved),
            "collective_bytes_per_device": float(sum(coll.values())),
            "collective_breakdown": coll,
            "collective_calls": calls,
            "n_collective_ops_executed": int(sum(calls.values())),
            "while_trip_counts": None,
            "xla_cost_analysis_flops": None,
        },
        "state_bytes": state_bytes,
        "state_parts": parts,
        "seconds": time.time() - t0,
    }


# --------------------------------------------------------------------------
# Cells.
# --------------------------------------------------------------------------


def build_cell(arch: str, shape_name: str, mesh, variant: str):
    """(cfg, kind, chunks) of a cell on ``mesh`` (a ``MeshSpec``), as the
    reference builds it: bf16 params and compute, remat "full" for train,
    the batch axes dropped where the batch does not divide over them, the
    all-to-all MoE with an int8 wire unless the variant says otherwise."""
    from repro_torch.train import TrainerConfig

    spec = SHAPES[shape_name]
    is_train = spec.kind == "train"
    flags = set(variant.split("+")) if variant else {"baseline"}
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    if "pod_compressed" in flags:
        bax = ("data",)
    else:
        bax = tuple(a for a in ("pod", "data") if a in sizes)
    n_batch_shards = math.prod(sizes[a] for a in bax) if bax else 1
    if spec.global_batch % max(n_batch_shards, 1) or spec.global_batch < n_batch_shards:
        bax = ()  # e.g. long_500k batch 1: a sequence-cut cache instead
    cfg = get_config(
        arch, param_dtype="bfloat16", compute_dtype="bfloat16",
        remat="full" if is_train else "none", mesh_batch_axes=bax, mesh_ep_axis="model",
        moe_impl="gspmd" if "moe_gspmd" in flags else "a2a",
        moe_wire="bf16" if "moe_bf16" in flags else "int8")
    if not is_train:
        return cfg, spec.kind, PREFILL_CHUNKS.get(arch, 1) if spec.kind == "prefill" else 1
    micro = MICROBATCHES.get(arch, 1)
    if bax:
        micro = min(micro, spec.global_batch // n_batch_shards)
    tcfg = TrainerConfig(qat=True, pod_compression="pod_compressed" in flags,
                         error_feedback="pod_compressed" in flags,
                         microbatches=max(micro, 1))
    return cfg, TrainKind(tcfg), 1


def run_cell(arch: str, shape_name: str, mesh_kind: str, variant: str = "baseline",
             out_dir: str = ARTIFACT_DIR) -> dict:
    """Estimate one cell and write its record (``{arch}__{shape}__{mesh}
    [__{variant}].json`` under ``out_dir``); a failure is recorded, not
    raised."""
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    n_dev = mesh.n_devices
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "variant": variant,
              "mesh_axes": describe(mesh)["axes"], "n_devices": n_dev,
              "device": "NVIDIA H100 SXM5 80GB HBM3 (datasheet constants)"}
    try:
        cfg, kind, chunks = build_cell(arch, shape_name, mesh, variant)
        spec = SHAPES[shape_name]
        est = estimate_step(cfg, kind, (spec.global_batch, spec.seq_len), mesh.shape,
                            mesh.axis_names, chunks=chunks)
        hlo = est["hlo"]
        terms = {"compute": hlo["flops_per_device"] / PEAK_FLOPS,
                 "memory": hlo["bytes_per_device"] / HBM_BW,
                 "collective": hlo["collective_bytes_per_device"] / LINK_BW}
        bound = max(terms.values())
        mflops = model_flops(cfg, shape_name)
        record.update({
            "status": "ok",
            "estimate_s": round(est["seconds"], 2),
            "param_count": param_count(cfg),
            "active_param_count": active_param_count(cfg),
            "state_bytes_per_device": est["state_bytes"],
            "memory": est["memory"],
            "hlo": hlo,
            "roofline": {
                "peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW, "link_bw": LINK_BW,
                "compute_term_s": terms["compute"],
                "memory_term_s": terms["memory"],
                "collective_term_s": terms["collective"],
                "bottleneck": max(terms, key=terms.get),
                "step_time_lower_bound_s": bound,
                "model_flops": mflops,
                "useful_flops_ratio": (mflops / (hlo["flops_per_device"] * n_dev)
                                       if hlo["flops_per_device"] else None),
                "mfu_upper_bound": (mflops / (bound * n_dev * PEAK_FLOPS)
                                    if bound > 0 else None),
            },
        })
    except Exception as e:  # recorded: each is a gap to close
        record.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]})
    os.makedirs(out_dir, exist_ok=True)
    tag = "" if variant == "baseline" else f"__{variant}"
    with open(os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_kind}{tag}.json"), "w") as f:
        json.dump(record, f, indent=1, default=float)
    return record


def cells(mesh_kinds=("single", "multi")):
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape_name in SHAPES:
            ok, _ = applicable(cfg, shape_name)
            if not ok:
                continue
            for mk in mesh_kinds:
                yield arch, shape_name, mk


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--only-missing", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    args = ap.parse_args(argv)

    if args.list:
        for c in cells():
            print(*c)
        return
    if args.all:
        todo = list(cells())
        if args.only_missing:
            def missing(c):
                p = os.path.join(args.out, f"{c[0]}__{c[1]}__{c[2]}.json")
                if not os.path.exists(p):
                    return True
                with open(p) as f:
                    return json.load(f).get("status") != "ok"
            todo = [c for c in todo if missing(c)]
        t0 = time.time()
        for arch, shape_name, mk in todo:
            r = run_cell(arch, shape_name, mk, out_dir=args.out)
            rf = r.get("roofline", {})
            print(f"[{r['status']:5s}] {arch} × {shape_name} × {mk} "
                  f"estimate={r.get('estimate_s', '-')}s "
                  f"bottleneck={rf.get('bottleneck', '-')} "
                  f"peak_gb={r.get('memory', {}).get('peak_estimate_gb', '-')}", flush=True)
            if r["status"] != "ok":
                print(r.get("error"), flush=True)
        print(f"{len(todo)} cells in {time.time() - t0:.1f} s", flush=True)
        return
    r = run_cell(args.arch, args.shape, args.mesh, args.variant, out_dir=args.out)
    print(json.dumps(r, indent=1, default=float))


if __name__ == "__main__":
    main()
