"""End-to-end training entry point: FTTQ quantization-aware LM pretraining
with checkpoint and restart, on a synthetic token stream (port of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --preset 10m --steps 300
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --preset 1m --steps 20
    torchrun --nproc-per-node 2 -m repro_torch.launch.train --pods 2 --preset 10m
    RANK=r WORLD_SIZE=2 python -m repro_torch.launch.train --pods 2 --backend gloo \
        --init-method file:///tmp/rdv --device cpu --preset 1m      # r = 0 and 1
    RANK=r WORLD_SIZE=2 python -m repro_torch.launch.train --model 2 --backend gloo \
        --init-method file:///tmp/rdv --device cpu --preset 1m      # r = 0 and 1
    RANK=r WORLD_SIZE=2 python -m repro_torch.launch.train --model 1 --backend gloo \
        --init-method file:///tmp/rdv --device cpu --preset 1m      # FSDP over 2 ranks

With ``--pods N`` (N > 1), ``--model M`` (M > 1) or ``WORLD_SIZE`` > 1 in
the environment, one process runs per rank under ``torch.distributed``:
the rendezvous is ``--init-method``
(``env://``, as ``torchrun`` sets MASTER_ADDR, MASTER_PORT, RANK and
WORLD_SIZE, or ``file://<path>`` with RANK and WORLD_SIZE in the
environment), the mesh is (N, WORLD_SIZE / (N · M), M) over ("pod",
"data", "model"), every rank reads the same token stream and trains on its
rows of each global batch, the pods sync their gradients
ternary-compressed with error feedback (``--no-pod-compression``: an exact
mean; ``--no-error-feedback``), the "model" axis is tensor parallelism
(every family; the all-to-all MoE raises) and the "data" axis is FSDP as
well as data parallelism: each rank holds its shards of the params and of
both Adam moments over both axes. Rank r runs on ``cuda:{r % device_count}`` (or the
CPU with ``--device cpu``); the backend is ``--backend`` (default nccl on
cuda, gloo on the CPU; gloo also lets several ranks share one GPU). Rank 0
prints and writes checkpoints (every pod's residuals and every shard
gathered: the one-device file).

With ``--ckpt-dir`` a checkpoint (state, data cursor) is written every
``--ckpt-every`` steps; ``--resume`` restarts from the newest one and repeats
the uninterrupted run's later steps. ``--arch`` trains a reduced zoo config
instead of a preset. The token stream is the reference CLI's: numpy seeded
with the int that ``jax.random`` draws from key 1. The weights come from a
``torch.Generator`` seeded with 0, not the reference's.
"""

from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_reduced
from repro_torch.data.synthetic import synthetic_tokens, token_batches
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import AXES, make_mesh
from repro_torch.models.transformer import ModelConfig, param_count
from repro_torch.optim import adam, warmup_cosine_schedule
from repro_torch.parallel.sharding import param_specs
from repro_torch.train import (
    TrainerConfig, init_train_state, latest_step, make_train_step, restore_checkpoint,
    save_checkpoint,
)
from repro_torch.train.trainer import gather_residuals

PRESETS = {
    # ~100M-param dense LM for the end-to-end example.
    "100m": dict(name="lm-100m", family="dense", n_layers=12, d_model=768,
                 vocab_size=32768, n_heads=12, n_kv_heads=12, d_ff=3072),
    "10m": dict(name="lm-10m", family="dense", n_layers=6, d_model=256,
                vocab_size=8192, n_heads=8, n_kv_heads=4, d_ff=1024),
    "1m": dict(name="lm-1m", family="dense", n_layers=4, d_model=128,
               vocab_size=1024, n_heads=4, n_kv_heads=2, d_ff=512),
}

# int(jax.random.randint(jax.random.PRNGKey(1), (), 0, 2**31 - 1)): the seed the
# reference CLI's synthetic_tokens hands numpy
DATA_SEED = 1733648124


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="1m", choices=list(PRESETS))
    ap.add_argument("--arch", default=None, help="use a reduced arch config instead")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--no-qat", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--pods", type=int, default=1,
                    help="pods on the mesh's 'pod' axis; > 1 runs one process per rank")
    ap.add_argument("--model", type=int, default=1,
                    help="ranks on the mesh's 'model' axis (tensor parallelism); > 1 runs one "
                         "process per rank")
    ap.add_argument("--pod-compression", action=argparse.BooleanOptionalAction, default=True,
                    help="ternary-compressed cross-pod gradient sync (else an exact mean)")
    ap.add_argument("--error-feedback", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--init-method", default="env://",
                    help="torch.distributed rendezvous for --pods > 1 (env:// or file://...)")
    ap.add_argument("--backend", default=None,
                    help="nccl or gloo (default: nccl on cuda, gloo on the CPU)")
    return ap


def _distributed(args):
    """(rank, mesh, device) of this process: one rank and no mesh for one
    pod, one model rank and no ``WORLD_SIZE`` > 1, else the process group
    and the (pods, data, model) mesh, whose "data" axis (FSDP and data
    parallelism) takes the ranks left over."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.pods <= 1 and args.model <= 1 and world <= 1:
        return 0, None, resolve_device(args.device)
    rank = int(os.environ["RANK"])
    if world % (args.pods * args.model):
        raise SystemExit(f"--pods {args.pods} x --model {args.model} does not divide "
                         f"WORLD_SIZE {world}")
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = resolve_device(f"cuda:{rank % torch.cuda.device_count()}")
    backend = args.backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=args.init_method, rank=rank,
                            world_size=world)
    mesh = make_mesh((args.pods, world // (args.pods * args.model), args.model), AXES,
                     device=dev)
    return rank, mesh, dev


def main(argv=None) -> float:
    """Train; returns the final loss (also printed as the last line)."""
    args = build_parser().parse_args(argv)
    rank, mesh, dev = _distributed(args)
    say = print if rank == 0 else (lambda *a, **k: None)

    if args.arch:
        cfg = get_reduced(args.arch)
    else:
        cfg = ModelConfig(**PRESETS[args.preset])
    say(f"model={cfg.name} params={param_count(cfg) / 1e6:.1f}M "
        f"qat={not args.no_qat}" + (f" pods={args.pods} ranks={mesh.n_devices} "
                                    f"model={args.model} "
                                    f"compression={args.pod_compression and args.pods > 1}"
                                    if mesh else ""))

    # one pod has no cross-pod sync to compress (the mesh's "pod" axis is 1)
    tcfg = TrainerConfig(qat=not args.no_qat,
                         pod_compression=args.pod_compression and args.pods > 1,
                         error_feedback=args.error_feedback, microbatches=args.microbatches)
    optimizer = adam(warmup_cosine_schedule(args.lr, 20, args.steps))
    state = init_train_state(cfg, tcfg, optimizer, seed=0, device=dev, n_pods=args.pods,
                             mesh=mesh)
    step_fn = make_train_step(cfg, tcfg, optimizer, mesh=mesh)
    specs = param_specs(cfg, mesh) if mesh else None

    toks = synthetic_tokens(DATA_SEED, max(args.batch * (args.seq + 1) * 64, 200_000),
                            vocab=cfg.vocab_size)
    cursor = 0
    start = 0
    if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        example = gather_residuals(state, mesh) if mesh else state
        state, meta = restore_checkpoint(args.ckpt_dir, example_state=example, device=dev,
                                         mesh=mesh, specs=specs)
        cursor = meta.get("data_cursor", 0)
        start = meta["step"]
        say(f"resumed from step {start} (cursor={cursor})")
    batches = token_batches(toks, args.batch, args.seq, start=cursor, device=dev)

    t0 = time.time()
    metrics = None
    for i in range(start, args.steps):
        batch, cursor = next(batches)
        state, metrics = step_fn(state, batch)
        if (i + 1) % args.log_every == 0:
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            dt = (time.time() - t0) / args.log_every
            tok_s = args.batch * args.seq / dt
            say(f"step {i + 1:5d}  loss={loss:.4f}  gnorm={gnorm:.2f}  "
                f"{dt * 1e3:.0f} ms/step  {tok_s:.0f} tok/s", flush=True)
            t0 = time.time()
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            snap = gather_residuals(state, mesh) if mesh else state
            save_checkpoint(args.ckpt_dir, i + 1, snap, metadata={"data_cursor": cursor},
                            mesh=mesh, specs=specs)
            if mesh:
                dist.barrier()
    final = float(metrics["loss"]) if metrics is not None else float("nan")
    say("done. final loss:", final)
    if mesh:
        dist.destroy_process_group()
    return final


if __name__ == "__main__":
    main()
