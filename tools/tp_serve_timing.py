#!/usr/bin/env python3
"""Time zamba2-1.2b's tensor-parallel prefill and greedy decode on one GPU.

    python3 tools/tp_serve_timing.py [--src CHECKOUT] [--layers 7] [--gen 8]
                                     [--device cuda]

Two "model" ranks share the card over ``gloo`` (a (1, 2) data x model mesh,
two processes), as ``chip_smoke.py``'s (h) runs them: zamba2-1.2b at full
width cut to ``--layers`` of its 38 layers (two shared-block applications
at 7), the rank's shards of the seed-0 params (``init_params(..., mesh=)``),
``launch/steps.py``'s prefill of ``--prompts`` x ``--prompt`` tokens into a
cache with room for the decode, then ``--gen`` greedy decode steps. Prints
the card and one JSON line: per rank, the prefill's and each decode step's
synchronized wall ms, the rank's cache bytes by leaf and a sha256 of the
greedy tokens (equal on both ranks and across trees where the logits are).

``--src`` times the port of another checkout (its ``src/repro_torch``), so
that two trees can be timed in turns on one card; the timing code is this
checkout's. ``--device cpu`` runs the same on the CPU (a check of the
script at a few layers, not a measurement).
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rank_main(rank: int, args) -> dict:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(os.path.abspath(args.src), "src"))
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.transformer import init_params

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{args.rdv}", rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=600))
    dev = torch.device("cuda:0" if args.device == "cuda" else args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    mesh = make_mesh((1, 2), ("data", "model"), device=args.device)
    cfg = get_config("zamba2-1.2b", n_layers=args.layers)
    toks = torch.randint(0, cfg.vocab_size, (args.prompts, args.prompt),
                         generator=torch.Generator(dev).manual_seed(1), device=dev)
    params = init_params(cfg, seed=0, device=dev, mesh=mesh)
    prefill = make_prefill_step(cfg, args.prompt + args.gen, mesh=mesh)
    decode = make_decode_step(cfg, mesh=mesh, batch=args.prompts)
    with torch.no_grad():
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": toks})
        sync()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        step_ms, tokens = [], []
        for i in range(args.gen):
            tok = torch.argmax(logits, dim=-1)
            tokens.append(tok.cpu())
            sync()
            t0 = time.perf_counter()
            logits, cache = decode(params, {"tokens": tok, "cache": cache,
                                            "pos": args.prompt + i})
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    dist.destroy_process_group()
    return {"rank": rank, "prefill_ms": prefill_ms, "step_ms": step_ms,
            "cache_bytes": {k: v.numel() * v.element_size() for k, v in cache.items()},
            "tokens_sha256": hashlib.sha256(torch.cat(tokens, 1).numpy().tobytes()).hexdigest()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=ROOT, help="the checkout whose port is timed")
    ap.add_argument("--layers", type=int, default=7)
    ap.add_argument("--prompts", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rdv", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        print(json.dumps(rank_main(args.rank, args)))
        return 0

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("tp_serve_timing: no CUDA device is present", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        rdv = os.path.join(tmp, "rdv")
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r),
                                   "--rdv", rdv, "--src", args.src, "--layers", str(args.layers),
                                   "--prompts", str(args.prompts), "--prompt", str(args.prompt),
                                   "--gen", str(args.gen), "--device", args.device],
                                  stdout=subprocess.PIPE, text=True)
                 for r in range(2)]
        try:
            outs = [p.communicate(timeout=900)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    if any(p.returncode for p in procs):
        print("tp_serve_timing: a rank failed", file=sys.stderr)
        return 1
    if args.device == "cuda":
        sys.path.insert(0, ROOT)
        import chip_smoke

        print(chip_smoke.card_line())
    print(json.dumps({"src": os.path.abspath(args.src), "layers": args.layers,
                      "prompts": args.prompts, "prompt": args.prompt, "gen": args.gen,
                      "ranks": [json.loads(o.strip().splitlines()[-1]) for o in outs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
