"""End-to-end training entry point: FTTQ quantization-aware LM pretraining on one
device with checkpoint and restart, on a synthetic token stream (port of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --preset 10m --steps 300
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --preset 1m --steps 20

With ``--ckpt-dir`` a checkpoint (state, data cursor) is written every
``--ckpt-every`` steps; ``--resume`` restarts from the newest one and repeats
the uninterrupted run's later steps. ``--arch`` trains a reduced zoo config
instead of a preset. The token stream is the reference CLI's: numpy seeded
with the int that ``jax.random`` draws from key 1. The weights come from a
``torch.Generator`` seeded with 0, not the reference's.
"""

from __future__ import annotations

import argparse
import time

from repro_torch.configs import get_reduced
from repro_torch.data.synthetic import synthetic_tokens, token_batches
from repro_torch.device import resolve_device
from repro_torch.models.transformer import ModelConfig, param_count
from repro_torch.optim import adam, warmup_cosine_schedule
from repro_torch.train import (
    TrainerConfig, init_train_state, latest_step, make_train_step, restore_checkpoint,
    save_checkpoint,
)

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
    return ap


def main(argv=None) -> float:
    """Train; returns the final loss (also printed as the last line)."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)

    if args.arch:
        cfg = get_reduced(args.arch)
    else:
        cfg = ModelConfig(**PRESETS[args.preset])
    print(f"model={cfg.name} params={param_count(cfg) / 1e6:.1f}M "
          f"qat={not args.no_qat}")

    tcfg = TrainerConfig(qat=not args.no_qat, pod_compression=False,
                         microbatches=args.microbatches)
    optimizer = adam(warmup_cosine_schedule(args.lr, 20, args.steps))
    state = init_train_state(cfg, tcfg, optimizer, seed=0, device=dev)
    step_fn = make_train_step(cfg, tcfg, optimizer)

    toks = synthetic_tokens(DATA_SEED, max(args.batch * (args.seq + 1) * 64, 200_000),
                            vocab=cfg.vocab_size)
    cursor = 0
    start = 0
    if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        state, meta = restore_checkpoint(args.ckpt_dir, example_state=state, device=dev)
        cursor = meta.get("data_cursor", 0)
        start = meta["step"]
        print(f"resumed from step {start} (cursor={cursor})")
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
            print(f"step {i + 1:5d}  loss={loss:.4f}  gnorm={gnorm:.2f}  "
                  f"{dt * 1e3:.0f} ms/step  {tok_s:.0f} tok/s", flush=True)
            t0 = time.time()
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, i + 1, state, metadata={"data_cursor": cursor})
    final = float(metrics["loss"]) if metrics is not None else float("nan")
    print("done. final loss:", final)
    return final


if __name__ == "__main__":
    main()
