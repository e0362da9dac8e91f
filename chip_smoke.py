#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is skipped):
  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — nvcc builds every kernel of the serving path from src/;
  3. checks  — each kernel against its plain PyTorch version at the serving
               path's shapes (quantize_pack on full-width olmo-1b leaves,
               ternary_matmul at decode and prefill shapes, fp32, TF32 off);
  4. serve   — olmo-1b at full width (16 layers, d_model 2048, 2^30 quantized
               weights, random weights from a seed) deployed through the TFW1
               wire and served 2-bit: packed-vs-dequantized logits check,
               prefill of 4 × 32 tokens, 15 greedy decode steps; the kernels'
               launch counters are zeroed just before and read just after;
  5. timings — each kernel, its plain version and the PyTorch library call
               that computes the same function, with CUDA events, beside the
               least time the card could take (bytes over 3.35 TB/s or fp32
               operations over 67 TFLOP/s, whichever is larger).

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FP32_S = 67e12         # H100 SXM fp32 outside the tensor cores
MATMUL_SHAPES = [(4, 2048, 2048), (4, 2048, 8192), (4, 8192, 2048),
                 (128, 2048, 2048), (128, 2048, 8192), (128, 8192, 2048)]
BATCH, PROMPT, GEN = 4, 32, 16
LAYER_MATMULS = 7


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, graph: bool = True) -> float:
    """Mean milliseconds of ``fn`` on the card, by CUDA events. With
    ``graph`` the launches ``fn`` makes are captured into a CUDA graph and
    replayed, so the time is the device's, without the host's launch cost;
    without it, ``fn`` runs eagerly as a caller would run it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm-up, off the capture
    torch.cuda.current_stream().wait_stream(side)
    run = fn
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        run = g.replay
    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_FP32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is present", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)

    from repro_torch.comm.wire import update_nbytes
    from repro_torch.configs import get_config
    from repro_torch.core.encode import leaf_scalars
    from repro_torch.core.fttq import FTTQConfig, is_quantizable
    from repro_torch.kernels import _build
    from repro_torch.kernels.quantize_pack import quantize_pack, quantize_pack_plain
    from repro_torch.kernels.repack import PackedTernary
    from repro_torch.kernels.ternary_matmul import (
        ternary_matmul, ternary_matmul_plain, unpack_kernel_layout,
    )
    from repro_torch.launch.serve import generate, packed_logits_check, ternary_deploy
    from repro_torch.models.transformer import init_params, param_count
    from repro_torch.tree import flatten_with_path

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    phase("device")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")

    phase("build")
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"nvcc sm_90a build of {list(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    cfg = get_config("olmo-1b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    fcfg = FTTQConfig()
    quantizable = [(p, leaf) for p, leaf in flatten_with_path(params)
                   if is_quantizable(p, leaf, fcfg)]
    n_quant = sum(leaf.numel() for _, leaf in quantizable)
    print(f"olmo-1b full width: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{param_count(cfg)} params, {n_quant} quantized "
          f"(init {time.perf_counter() - t0:.1f} s)")
    check(n_quant == 2 ** 30, f"expected 2^30 quantized weights, got {n_quant}")

    phase("checks: quantize_pack vs plain (codes and counts exact, sums rtol 1e-5)")
    qp_err = 0.0
    for leaf in (params["blocks"]["mlp"]["w_out"], params["blocks"]["attn"]["wq"]):
        scal, _ = leaf_scalars(leaf, fcfg)
        packed, moments = quantize_pack(leaf, scal)
        ref_packed, ref_moments = quantize_pack_plain(leaf, scal)
        torch.cuda.synchronize()
        bad_codes = int((packed != ref_packed).sum())
        bad_counts = int((moments[:, 1] != ref_moments[:, 1]).sum())
        err = float((moments[:, 0] - ref_moments[:, 0]).abs().max())
        rel = float(((moments[:, 0] - ref_moments[:, 0]).abs()
                     / ref_moments[:, 0].abs().clamp_min(1e-30)).max())
        qp_err = max(qp_err, err)
        print(f"  {tuple(leaf.shape)}: {packed.numel()} wire bytes, {bad_codes} differ; "
              f"{moments.shape[0]} tiles, {bad_counts} counts differ; "
              f"sum max abs err {err:.3e}, max rel err {rel:.3e}")
        check(bad_codes == 0 and bad_counts == 0 and rel <= 1e-5,
              f"quantize_pack disagrees with its plain version at {tuple(leaf.shape)}")
        del packed, moments, ref_packed, ref_moments

    phase("checks: ternary_matmul vs plain (fp32, TF32 off, rtol 1e-4, atol 1e-4)")
    gen = torch.Generator(dev).manual_seed(5)
    tm_err = 0.0
    per_shape = []
    for m, k, n in MATMUL_SHAPES:
        x = torch.randn(m, k, generator=gen, device=dev)
        c = torch.randint(0, 3, (k // 4, 4, n), generator=gen, device=dev, dtype=torch.uint8)
        packed = c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)
        wq = torch.tensor(0.02, device=dev)
        y = ternary_matmul(x, packed, wq)
        y_ref = ternary_matmul_plain(x, packed, wq)
        torch.cuda.synchronize()
        err = float((y - y_ref).abs().max())
        ok = bool(torch.allclose(y, y_ref, rtol=1e-4, atol=1e-4))
        tm_err = max(tm_err, err)
        dense = unpack_kernel_layout(packed, torch.float32) * wq
        box = {}

        def kernel_call():
            box["y"] = ternary_matmul(x, packed, wq)

        t_k = time_ms(kernel_call, 20)
        # the output the graph replays write proves the capture holds the kernel
        check(bool(torch.allclose(box["y"], y_ref, rtol=1e-4, atol=1e-4)),
              f"graph replay of ternary_matmul disagrees at {(m, k, n)}")
        t_e = time_ms(kernel_call, 20, graph=False)
        t_p = time_ms(lambda: ternary_matmul_plain(x, packed, wq), 5)
        t_l = time_ms(lambda: torch.matmul(x, dense), 20)
        b_ms, b_by = bound(packed.numel() + 4 * (m * k + m * n) + 4, 2 * m * k * n)
        per_shape.append({"m": m, "k": k, "n": n, "ms": t_k, "eager_ms": t_e, "plain_ms": t_p,
                          "library_ms": t_l, "bound_ms": b_ms, "bound_by": b_by,
                          "max_abs_err": err})
        print(f"  M={m} K={k} N={n}: max abs err {err:.3e}; kernel {t_k:.4f} ms "
              f"(eager {t_e:.4f} ms), "
              f"plain {t_p:.4f} ms, torch.matmul(dense) {t_l:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by})")
        check(ok, f"ternary_matmul disagrees with its plain version at {(m, k, n)}")
        del x, c, packed, dense, y, y_ref

    phase("serve: olmo-1b --ternary --packed at full width")
    quantize_pack.launches = 0
    ternary_matmul.launches = 0
    t0 = time.perf_counter()
    fp_bytes = update_nbytes(params)
    served, wire_bytes, dl_s, link = ternary_deploy(params, fcfg, packed=True, device=dev)
    torch.cuda.synchronize()
    t_deploy = time.perf_counter() - t0
    print(f"edge checkpoint: {wire_bytes} B on the wire (fp32 {fp_bytes} B, "
          f"{fp_bytes / wire_bytes:.2f}x smaller), est. download {dl_s:.1f} s "
          f"@ {link.bandwidth_bytes_s / 1e6:.1f} MB/s; deploy {t_deploy:.2f} s")
    ref_params, ref_bytes, _, _ = ternary_deploy(params, fcfg, packed=False, device=dev)
    check(ref_bytes == wire_bytes, "the two deploys saw different wire artifacts")
    probe = torch.randint(0, cfg.vocab_size, (2, 8),
                          generator=torch.Generator(dev).manual_seed(9), device=dev)
    diff, ref_max = packed_logits_check(cfg, served, ref_params, probe)
    print(f"packed-vs-dequant logits: max |d| = {diff:.3e}, max |logits_ref| = "
          f"{ref_max:.3e}, ratio {diff / ref_max:.3e} (limit 1e-4)")
    check(diff / ref_max <= 1e-4, "packed logits disagree with the dequantized path")
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=torch.Generator(dev).manual_seed(1), device=dev)
    tokens, t_prefill, t_decode = generate(cfg, served, prompts, GEN)
    qp_launches = quantize_pack.launches
    tm_launches = ternary_matmul.launches
    print(f"prefill: {BATCH}x{PROMPT} tokens in {t_prefill * 1e3:.2f} ms")
    print(f"decode: {GEN - 1} steps x batch {BATCH} in {t_decode * 1e3:.2f} ms "
          f"({BATCH * (GEN - 1) / t_decode:.1f} tok/s)")
    print("sample tokens:", tokens[0, :12].tolist())
    check(tuple(tokens.shape) == (BATCH, GEN), f"tokens shape {tuple(tokens.shape)}")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()), "token out of vocab")
    ref_tokens, _, _ = generate(cfg, ref_params, prompts, GEN)
    agree = float((ref_tokens == tokens).float().mean())
    print(f"greedy tokens equal to the dequantized path's: {agree:.4f}")
    forwards = 1 + 1 + (GEN - 1)    # logits check, prefill, decode steps
    per_forward = cfg.n_layers * LAYER_MATMULS
    print(f"launches on the serving path: quantize_pack {qp_launches}, "
          f"ternary_matmul {tm_launches} = {per_forward} x {forwards} forwards")
    check(qp_launches >= 1, "quantize_pack was not launched by the deploy")
    check(tm_launches == per_forward * forwards,
          f"ternary_matmul launched {tm_launches} times, want {per_forward * forwards}")

    phase("timings")
    leaves = [leaf for _, leaf in quantizable]
    scals = [leaf_scalars(leaf, fcfg)[0] for leaf in leaves]

    def encode_all(fn):
        return lambda: [fn(leaf, s) for leaf, s in zip(leaves, scals)]

    qp_ms = time_ms(encode_all(quantize_pack), 5)
    qp_plain_ms = time_ms(encode_all(quantize_pack_plain), 2)
    qp_bytes = sum(4 * n.numel() + (n.numel() + 3) // 4 + 8 * -(-n.numel() // 32768) + 8
                   for n in leaves)
    qp_bound, qp_by = bound(qp_bytes, 4 * n_quant)
    print(f"quantize_pack, all {len(leaves)} quantized leaves ({n_quant} weights): "
          f"kernel {qp_ms:.4f} ms, plain {qp_plain_ms:.4f} ms, bound {qp_bound:.4f} ms "
          f"({qp_by}, {qp_bytes} B)")

    blocks = served["blocks"]
    dense_blocks = ref_params["blocks"]
    names = [("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
             ("mlp", "w_in"), ("mlp", "w_gate"), ("mlp", "w_out")]
    step = []
    for i in range(cfg.n_layers):
        for a, b in names:
            w: PackedTernary = blocks[a][b].layer(i)
            x = torch.randn(BATCH, w.k, generator=gen, device=dev)
            step.append((x, w.packed, w.w_q.reshape(()), dense_blocks[a][b][i]))
    check(len(step) == per_forward, "decode step does not hold 112 matmuls")
    tm_ms = time_ms(lambda: [ternary_matmul(x, p, s) for x, p, s, _ in step], 10)
    tm_eager_ms = time_ms(lambda: [ternary_matmul(x, p, s) for x, p, s, _ in step], 10,
                          graph=False)
    tm_plain_ms = time_ms(lambda: [ternary_matmul_plain(x, p, s) for x, p, s, _ in step], 3)
    tm_lib_ms = time_ms(lambda: [torch.matmul(x, d) for x, _, _, d in step], 10)
    tm_bytes = sum(p.numel() + 4 * (x.numel() + x.shape[0] * p.shape[1]) + 4
                   for x, p, _, _ in step)
    tm_flops = sum(2 * x.shape[0] * x.shape[1] * p.shape[1] for x, p, _, _ in step)
    tm_bound, tm_by = bound(tm_bytes, tm_flops)
    print(f"ternary_matmul, one decode step's {len(step)} matmuls at M={BATCH}: "
          f"kernel {tm_ms:.4f} ms (eager, with launch cost: {tm_eager_ms:.4f} ms), "
          f"plain {tm_plain_ms:.4f} ms, torch.matmul on the "
          f"dequantized weights {tm_lib_ms:.4f} ms, bound {tm_bound:.4f} ms "
          f"({tm_by}; {tm_bytes} B, {tm_flops} FLOP)")

    phase("trace: three decode steps under torch.profiler")
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.transformer import decode_step, forward, init_cache

    cache = init_cache(cfg, BATCH, PROMPT + GEN, device=dev)
    logits, cache, _ = forward(cfg, served, prompts, cache=cache, pos=0)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(3):
            logits, cache = decode_step(cfg, served, tok, cache, PROMPT + i)
            tok = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    busy_ms = sum(device_us(e) for e in events) / 1e3
    ranked = sorted(events, key=device_us, reverse=True)
    print(f"3 decode steps: {wall_ms:.2f} ms wall, {busy_ms:.3f} ms of device time "
          f"(device idle {100 * (1 - busy_ms / wall_ms):.1f}% of the window)")
    for e in ranked[:10]:
        print(f"  {device_us(e) / 1e3:9.3f} ms device  {e.count:6d} calls  {e.key[:70]}")
    cpu_ranked = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)
    for e in cpu_ranked[:8]:
        print(f"  {e.self_cpu_time_total / 1e3:9.3f} ms host    {e.count:6d} calls  {e.key[:70]}")

    table = {"kernels": [
        {"name": "quantize_pack", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/quantize_pack.cu",
         "replaces": "src/repro/kernels/quantize_pack.py:83",
         "launches": qp_launches, "max_abs_err": qp_err, "ms": qp_ms,
         "plain_ms": qp_plain_ms, "bound_ms": qp_bound, "bound_by": qp_by,
         "library_ms": None},
        {"name": "ternary_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ternary_matmul.cu",
         "replaces": "src/repro/kernels/ternary_matmul.py:34",
         "launches": tm_launches, "max_abs_err": tm_err, "ms": tm_ms,
         "plain_ms": tm_plain_ms, "bound_ms": tm_bound, "bound_by": tm_by,
         "library_ms": tm_lib_ms, "eager_ms": tm_eager_ms, "per_shape": per_shape},
    ]}
    print(card)
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
