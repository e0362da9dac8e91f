#!/usr/bin/env python3
"""Time olmo-1b's train step and its QAT quantizer on one NVIDIA GPU.

    python3 tools/train_step_timing.py [--src CHECKOUT] [--steps 8] [--batch 8] [--seq 512]

Builds olmo-1b at full width from seed 0 on the card with ``init_train_state``
and ``make_train_step`` at ``TrainerConfig()`` defaults (QAT, grad clip 1,
w_q lr 0.05) and adam(3e-4), as ``chip_smoke.py``'s train phase does, and
takes ``--steps`` steps at ``--batch`` × ``--seq`` of the CLI's synthetic
token stream: each step's synchronized wall ms. Then, on the seed-0 state,
the QAT quantizer alone (``core.fttq.FTTQQuantize`` on each quantized leaf,
2^30 weights) by CUDA events: its forward, and its forward and backward with a
fixed cotangent. Last, sha256 digests of bits: the losses and the params
and w_q after the steps, and the port's FTTQ statistics, ``fttq_apply``,
``compress_pytree`` with error feedback and ``ternary_allreduce_tree`` on
seeded normal olmo-1b-shaped leaves on the card, so that two trees timed
side by side can be held to the same bits.

``--src`` times the port of another checkout (its ``src/repro_torch``), so
that two trees can be timed in turns on one card; the timing
code is this checkout's. Prints the card and one JSON line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bits(h, t) -> None:
    import torch

    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    h.update(str((t.dtype, tuple(t.shape))).encode())
    h.update(t.numpy().tobytes())


def _events_ms(fn, reps: int) -> list:
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out


def kernel_path_digest(dev) -> str:
    """sha256 of the port's outputs on seeded normal leaves of olmo-1b's
    shapes on ``dev``: the one-leaf and row statistics, the QAT forward and
    backward, ``fttq_apply``, every codec with error feedback over three
    encodes and two steps of the one-pod compressed sync."""
    import torch

    from repro_torch.core import fttq
    from repro_torch.core.compression import CodecSpec, compress_pytree, decompress_pytree
    from repro_torch.kernels import ops
    from repro_torch.parallel.collectives import ternary_allreduce_tree
    from repro_torch.tree import tree_leaves

    gen = torch.Generator(dev).manual_seed(30)
    h = hashlib.sha256()
    tree = {"attn": {"wq": 0.02 * torch.randn(2048, 2048, generator=gen, device=dev)},
            "mlp": {"w_in": 0.02 * torch.randn(2, 2048, 8192, generator=gen, device=dev)},
            "norm": {"scale": torch.ones(2048, device=dev)}}
    cfg = fttq.FTTQConfig()
    for dtype in (torch.float32, torch.bfloat16):
        x = tree["attn"]["wq"].to(dtype)
        ts = fttq.scale_layer(x)
        for rule in ("mean", "max"):
            d = fttq.fttq_threshold(ts, cfg.t_k, rule)
            wq = fttq.init_wq(x, fttq.FTTQConfig(threshold_rule=rule))
            for t in (d, fttq.ternarize(ts, d), wq):
                _bits(h, t)
        rows = tree["mlp"]["w_in"].to(dtype).reshape(2, -1)
        _bits(h, fttq.row_codes(rows, cfg.t_k))
        for t in fttq.leaf_row_stats([rows], cfg.t_k, [()])[0]:
            _bits(h, t)
        for t in ops.fttq_apply(x, cfg.t_k):
            _bits(h, t)
    wq = fttq.init_wq_tree(tree, cfg)
    params = {k: {n: a.clone().requires_grad_() for n, a in v.items()} for k, v in tree.items()}
    wqg = {k: {n: (a.clone().requires_grad_() if a is not None else None) for n, a in v.items()}
           for k, v in wq.items()}
    q = fttq.quantize_tree(params, wqg, cfg)
    loss = sum((a * torch.cos(a * 50.0)).sum() for a in tree_leaves(q))
    loss.backward()
    for t in tree_leaves(q) + [a.grad for a in tree_leaves(params)] + \
            [a.grad for a in tree_leaves(wqg) if a is not None]:
        _bits(h, t)
    h.update(json.dumps(fttq.ternary_stats(tree, cfg), sort_keys=True).encode())
    for kind in ("ternary", "fp16", "bf16", "topk", "topk16", "none"):
        for residual in ("none", "bf16", "topk"):
            if (kind, residual) == ("none", "none"):
                continue
            spec = CodecSpec(kind=kind, residual=residual, topk_fraction=0.05,
                             error_feedback=True)
            res = None
            for _ in range(3):
                wire, res = compress_pytree(tree, spec, residual=res)
                for t in tree_leaves(decompress_pytree(wire, dev)) + tree_leaves(res):
                    _bits(h, t)
    res = None
    for _ in range(2):
        synced, res = ternary_allreduce_tree(tree, None, residuals=res)
        for t in tree_leaves(synced) + tree_leaves(res):
            _bits(h, t)
    return h.hexdigest()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=ROOT, help="the checkout whose port is timed")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--reps", type=int, default=5, help="quantizer timings")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("train_step_timing: no CUDA device is present", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.abspath(args.src), "src"))
    sys.path.insert(1, ROOT)
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.core import fttq
    from repro_torch.data.synthetic import synthetic_tokens, token_batches
    from repro_torch.launch.train import DATA_SEED
    from repro_torch.optim import adam
    from repro_torch.train import TrainerConfig, init_train_state, make_train_step
    from repro_torch.tree import flatten_with_path, tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config("olmo-1b")
    tcfg = TrainerConfig()
    opt = adam(chip_smoke.TRAIN_LR)
    state = init_train_state(cfg, tcfg, opt, seed=0, device=dev)

    # the QAT quantizer alone on the seed-0 state
    params = {p: x for p, x in flatten_with_path(state.params)}
    wqs = dict(flatten_with_path(state.wq))
    paths = [p for p in params if wqs.get(p) is not None]
    leaves = [params[p].detach().requires_grad_() for p in paths]
    factors = [wqs[p].detach().requires_grad_() for p in paths]
    gen = torch.Generator(dev).manual_seed(1)
    cot = [1e-3 * torch.randn(x.shape, generator=gen, device=dev) for x in leaves]

    def forward():
        with torch.no_grad():
            for x, w in zip(leaves, factors):
                fttq.FTTQQuantize.apply(x, w, tcfg.fttq.t_k)

    def forward_backward():
        outs = [fttq.FTTQQuantize.apply(x, w, tcfg.fttq.t_k) for x, w in zip(leaves, factors)]
        torch.autograd.backward(outs, cot)
        for x, w in zip(leaves, factors):
            x.grad = w.grad = None

    qat_fwd = _events_ms(forward, args.reps)
    qat_fwd_bwd = _events_ms(forward_backward, args.reps)
    del leaves, factors, cot, params

    tokens = synthetic_tokens(DATA_SEED, args.batch * (args.seq + 1) * args.steps, cfg.vocab_size)
    batches = token_batches(tokens, args.batch, args.seq, device=dev)
    step = make_train_step(cfg, tcfg, opt)
    steps, losses = [], []
    for _ in range(args.steps):
        batch, _ = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    h = hashlib.sha256(json.dumps(losses).encode())
    for t in tree_leaves(state.params) + [w for w in tree_leaves(state.wq) if w is not None]:
        _bits(h, t)
    train_digest = h.hexdigest()
    del state, step, batches
    torch.cuda.empty_cache()
    digest = kernel_path_digest(dev)

    warm = sorted(steps[1:])
    print(chip_smoke.card_line())
    print(json.dumps({"src": os.path.abspath(args.src), "batch": args.batch, "seq": args.seq,
                      "steps_ms": steps, "median_step_ms": warm[len(warm) // 2],
                      "min_step_ms": warm[0], "losses": losses,
                      "qat_forward_ms": qat_fwd, "qat_forward_backward_ms": qat_fwd_bwd,
                      "train_bits_sha256": train_digest, "kernel_path_bits_sha256": digest}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
