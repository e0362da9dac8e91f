#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is skipped):
  1. device    — the card's name and power limit (nvidia-smi);
  2. build     — nvcc builds every kernel from src/, one process per source;
  3. checks    — each kernel against its plain PyTorch version:
                 quantize_pack_segments on the deploy's segments (olmo-1b's
                 7 quantized leaves, up to 8,192 tiles each, in one launch,
                 scales formed on the card) and on one ResNet18* encode's 52
                 segments in one launch (bytes, guard bytes, counts, sums and
                 scales), quantize_pack on ResNet18*'s segments written at
                 their offsets of one buffer (payload and server mode);
                 ternary_matmul at ragged, decode and prefill shapes (fp32,
                 TF32 off) against the plain version and against its exact
                 bf16 split in plain PyTorch, and bit for bit on one-hot
                 weights, where every output is one exact product;
                 aggregate and vote bit for bit, one launch per segment table:
                 ResNet18*'s 52 segments with 10 clients, segments of 1, 3, 37
                 and 144 bytes at C = 1, 3, 17, and 16 clients × 2^26 elements
                 (a one-row table); ternary_quantize bit for bit
                 on all 112 2-D layers of olmo-1b (and one in bf16);
  4. serve     — olmo-1b at full width (16 layers, d_model 2048, 2^30 quantized
                 weights, random weights from a seed) deployed through the TFW1
                 wire and served 2-bit: packed-vs-dequantized logits check,
                 prefill of 4 × 32 tokens, 15 greedy decode steps, one
                 quantize_pack launch per deploy; then unpack2bit and pack2bit
                 against their plain versions on the served 2-bit bytes (bit
                 for bit);
  5. timings   — quantize_pack, eagerly as core.encode calls it (the
                 deploy's one call over olmo-1b's 7 leaves beside 7
                 one-segment calls; one ResNet18* encode as 52 one-segment
                 calls and as one call, per encode and per round),
                 ternary_matmul (one decode step's and one prefill forward's
                 112 matmuls beside torch.matmul on the dequantized weights),
                 ternary_quantize, pack2bit and unpack2bit, their plain
                 versions and the PyTorch library call where one exists, with
                 CUDA events, beside the least time the card could take (bytes
                 over 3.35 TB/s, or operations over 67 TFLOP/s of fp32 or, for
                 the tensor-core ternary_matmul, 3 · 2MKN over 989 TFLOP/s of
                 bf16, whichever is larger);
  6. trace     — three decode steps under torch.profiler;
  7. federated — two T-FedAvg sync rounds (paper Algorithm 2) on ResNet18* at
                 full width with the paper's CIFAR setting (FedConfig
                 defaults: 100 clients, λ = 0.1, E = 5, B = 64, adam(1e-3), 500
                 synthetic 32×32×3 samples per client); per round the bytes,
                 simulated time, wall seconds per phase, accuracy and loss and
                 the kernels' launches (exactly one quantize_pack launch per
                 upload and per broadcast, one aggregate launch per flush of
                 agg_chunk_c uploads); the round's kernel fold against the
                 list reference ``server_aggregate``; the card's fused
                 encode of the last broadcast and of one client's upload
                 against the reference chain;
  8. robust    — one defended sync round of ResNet18* at full width (rule
                 majority on the vote kernel, 30 seeded sign-flip attackers of
                 100 clients): bytes, phase wall times, the gate's telemetry and
                 ledger, launches (one vote launch per flush); then, on the
                 last federated round's 10
                 uploads, the majority, median and trimmed_mean folds on the
                 card against the CPU plain folds, the sign-flip guarantee, and
                 the gate against 3 nan_poison uploads;
  9. async     — the buffered-async T-FedAvg server (``mode="async"``) on
                 ResNet18* at full width, FedConfig defaults (10 clients in
                 flight), buffer_k 4, staleness exponent 0.5, η 1, staleness
                 cap 1 with the drop policy, 3 mixes: per mix the simulated
                 time, wall seconds per phase, bytes, dispatches, staleness,
                 drops and accuracy; launches (one quantize_pack per dispatch
                 and per broadcast version, one aggregate per mix on the run's
                 one long-lived aggregator); the last mix's fold on its
                 buffered uploads and staleness weights against
                 ``server_aggregate``;
 10. hierarchy — one sync T-FedAvg round on ResNet18* at full width through
                 3 requantizing edges (``mod``): the tier's telemetry and
                 ledger, upload = client→edge + edge→root bytes, launches (one
                 quantize_pack per broadcast, upload and active edge; one
                 aggregate per active edge and at the root); then a lossless
                 tier on the card over the same uploads against a flat card
                 Aggregator;
 11. controller — two sync T-FedAvg rounds on ResNet18* at full width with
                 the adaptive compression controller (20 clients of 500
                 samples, λ 0.5, E 5, B 64; ControllerConfig(warmup_encodes=1,
                 divergence_high=1e9): each client's first upload ternary,
                 every later one topk16 at 5% with error feedback): rungs and
                 bytes per rung per round (round 0 all ternary, round 1
                 mixed), bytes by rung summing to the upload bytes, every
                 topk16 blob under every ternary one, launches (quantize_pack
                 = ternary uploads + 1 broadcast, aggregate = 1 a round),
                 each round's card fold against the CPU Aggregator's on the
                 same blobs bit for bit, each rung's card encode of one
                 trained tree against the CPU's (wire bytes, residual bits),
                 and one eager upload encode's ms per rung;
 12. fleet     — ``repro_torch.fed.run_fleet`` on ResNet18* at full width at
                 bench_hierarchy.py's top cell (10^6 clients, λ 0.1,
                 DiurnalChurn, FleetConfig defaults: a pool of 8 payloads):
                 (a) sync flat, 2 rounds; (b) sync through 64 requantizing
                 edges, 2 rounds; (c) async at FedConfig's defaults, 3
                 folds; (d) one round with 300,000 sign-flip attackers
                 against rule majority. Per run the participants, drops,
                 simulated times, bytes, the tier ledger or the defense
                 telemetry, wall seconds of the pool encode and of the run,
                 the run's peak device memory and launches; checks the byte
                 ledger, root ingress under 64 edge records a round, the
                 launches the code fixes (quantize_pack 1 + 8 + one per
                 active edge a round; aggregate one per flat round or fold,
                 or per edge and per root flush; vote 1 in (d)), and the
                 final update against the port's CPU path fed the same
                 cohorts (bit for bit; under the tier the edge codes bit for
                 bit, scales within 1e-6, and the root fold bit for bit);
 13. socket    — ``repro_torch.fed.run_socket_round`` on ResNet18* at full
                 width, the server's aggregator and every client process on
                 the card: (a) sync, 8 clients; (b) buffered, 8 clients,
                 buffer_k 3, η 0.5; (c) sync through the chaos proxy at fault
                 seed 19 with 6 clients, quorum 0.5, the preset's chunk
                 scaled to the ResNet18* frame; (d) sync, 8 clients, 2
                 nan_poison attackers against rule majority. Per run the
                 wall seconds, the clients' start-up to HELLO, bytes up and
                 down, framing overhead, the server's launches (aggregate 1
                 in (a), ⌈8/3⌉ in (b), vote 1 in (d)) and each client's
                 (quantize_pack 1 each in (a), reported through its exit
                 report); checks outcomes, the ledger, the hash against the
                 port's in-process card reference over the same survivors,
                 and (a)'s fold against a CPU Aggregator on the received
                 blobs, bit for bit;
 14. quickstart — repro_torch.launch.quickstart on the card, then its own
                 ternary_quantize, pack2bit and unpack2bit outputs against
                 the plain versions on the same inputs, bit for bit;
 15. fan-in timings — aggregate and vote over one round's fold (52 segments,
                 10 clients) in one launch, as a CUDA-graph replay and as an
                 eager Aggregator flush (staging fill, pinned copy, launch),
                 beside the per-segment pattern of 52 launches of 32-row tiles
                 at C = 16, and at 16 clients × 2^26 elements; bytes bounds and
                 plain versions;
 16. fan-in trace — the aggregate phase of one mean and one majority round
                 on the last round's uploads under torch.profiler, with the
                 Aggregator's host ranges (add, stage, copy, launch, finalize);
 17. fed trace — one round of one client at E = 5, B = 64, timed untraced
                 and then run under torch.profiler.
Before each driven path (serve, federated, robust, async, hierarchy,
controller, each fleet run, each socket run, quickstart) every kernel's
launch counter is set to 0, and read just after; a socket run's client
processes count their own launches and report them as they exit.

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
PEAK_BF16_S = 989e12        # H100 SXM dense bf16 on the tensor cores
MATMUL_SHAPES = [(4, 2048, 2048), (4, 2048, 8192), (4, 8192, 2048),
                 (128, 2048, 2048), (128, 2048, 8192), (128, 8192, 2048)]
RAGGED_MATMUL_SHAPES = [(3, 36, 130), (1, 8, 4), (1, 2048, 2048), (8, 2048, 2048),
                        (16, 2048, 2048), (33, 64, 70), (40, 1024, 260), (17, 4, 1)]
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


def bound(nbytes: float, flops: float, peak_ops: float = PEAK_FP32_S) -> tuple[float, str]:
    """The least time (ms) the card could take: bytes over the memory rate
    or operations over ``peak_ops``, whichever is larger."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def matmul_bound(m: int, k: int, n: int) -> tuple[float, str, int, int]:
    """The tensor-core ternary matmul's bound: x, the packed weights, w_q in
    and out once; 3 · 2MKN bf16 operations (three exact bf16 parts of x).
    Returns (ms, by, bytes, operations)."""
    nbytes = k // 4 * n + 4 * (m * k + m * n) + 4
    flops = 3 * 2 * m * k * n
    return (*bound(nbytes, flops, PEAK_BF16_S), nbytes, flops)


FED_ROUNDS = 2
FED_SAMPLES = 500         # per client: the paper's CIFAR-10 split over 100 clients
FED_TEST = 1000
FANIN_C = 16              # FedConfig.agg_chunk_c: one flush per round at λN = 10
FED_UPLOADS = 10          # λN = 10 clients encode an upload each round
STRESS_ELEMENTS = 2 ** 26  # per client: 16 MB of wire codes
ROBUST_ATTACKERS = 30      # sign-flip attackers of the 100 clients
ASYNC_MIXES = 3            # buffered mixes of the async server
HIER_EDGES = 3             # edge aggregators of the hierarchical round
CTRL_CLIENTS = 20          # the controller rounds' fleet (the paper's 100, cut)
CTRL_LAMBDA = 0.5          # 10 uploads a round, as the federated phase
CTRL_ROUNDS = 2
FLEET_CLIENTS = 1_000_000  # benchmarks/bench_hierarchy.py's top cell
FLEET_LAMBDA = 0.1
FLEET_EDGES = 64           # bench_hierarchy.py's N_EDGES
FLEET_ATTACKERS = 300_000  # sign-flip attackers of the defended fleet run
FLEET_POOL = 8             # FleetConfig().update_pool
SOCKET_CLIENTS = 8         # client processes of the socket rounds
SOCKET_CHAOS_CLIENTS = 6   # the chaos round's (the reference CLI's chaos demo)
SOCKET_SEED = 7
SOCKET_BUFFER_K = 3
SOCKET_ETA = 0.5
SOCKET_CHAOS_SEED = 19     # refused connects, mid-frame kills and resumes
SOCKET_ATTACKERS = 2       # nan_poison attackers of the defended socket round
SOCKET_TIMEOUT_S = 300.0


def kernel_counters() -> dict:
    """Every kernel wrapper of the port, by kernel name."""
    from repro_torch.kernels.aggregate import packed_weighted_sum
    from repro_torch.kernels.pack2bit import pack2bit, unpack2bit
    from repro_torch.kernels.quantize_pack import quantize_pack
    from repro_torch.kernels.ternary_matmul import ternary_matmul
    from repro_torch.kernels.ternary_quantize import ternary_quantize
    from repro_torch.kernels.vote import packed_vote_counts

    return {"quantize_pack": quantize_pack, "ternary_matmul": ternary_matmul,
            "aggregate": packed_weighted_sum, "vote": packed_vote_counts,
            "ternary_quantize": ternary_quantize, "pack2bit": pack2bit,
            "unpack2bit": unpack2bit}


def zero_counters() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counters() -> dict:
    return {name: fn.launches for name, fn in kernel_counters().items()}


def _tile_stack(nbytes: int, c: int, n_real: int, gen, dev):
    """A (c, R, 128) stack as a TPU-shaped staging fills it, one segment at
    a time: ``n_real`` clients' random wire codes in the first ``nbytes``
    of each row, R padded to whole 32-row tiles, zero tails and padding rows
    at coefficient 0."""
    import torch

    rows = -(-nbytes // 128)
    rows = -(-rows // 32) * 32
    codes = torch.randint(0, 3, (c, nbytes, 4), generator=gen, device=dev, dtype=torch.uint8)
    packed = codes[..., 0] | (codes[..., 1] << 2) | (codes[..., 2] << 4) | (codes[..., 3] << 6)
    stacked = torch.zeros(c, rows * 128, dtype=torch.uint8, device=dev)
    stacked[:n_real, :nbytes] = packed[:n_real]
    coeffs = torch.zeros(c, device=dev)
    coeffs[:n_real] = torch.rand(n_real, generator=gen, device=dev) * 0.02 + 0.005
    return stacked.reshape(c, rows, 128), coeffs


RAGGED_SEGMENTS = [(1, 3), (3, 9), (37, 147), (144, 576)]   # (bytes, elements)


def fanin_case(layout, c: int, gen, dev):
    """One flush as the Aggregator stages it: a segment table of ``layout``
    ((bytes, elements) per segment) on the card, a (c, row_bytes) buffer of
    random bytes (every code, garbage in the aligned gaps), (c, S)
    coefficients and (c,) weights."""
    import torch

    from repro_torch.kernels.aggregate import fanin_table

    table = fanin_table([b for b, _ in layout], [n for _, n in layout], dev)
    staged = torch.randint(0, 256, (c, table.row_bytes), generator=gen, device=dev,
                           dtype=torch.uint8)
    coeffs = torch.rand(c, table.n_segments, generator=gen, device=dev) * 0.02 + 0.005
    weights = torch.randint(40, 600, (c,), generator=gen, device=dev) / 7.0
    return table, staged, coeffs, weights


def fanin_bytes(table, c: int, planes: int) -> int:
    """What one segment launch must move: each client's real bytes and its
    coefficients (one per segment for aggregate, one for vote), the table,
    and ``planes`` fp32 outputs per element."""
    coeffs = table.n_segments if planes == 1 else 1
    return (c * (sum(table.nbytes) + 4 * coeffs) + 40 * table.n_segments
            + planes * 4 * sum(table.n_out))


def resnet_segment_bytes() -> list[int]:
    """Packed bytes of each ResNet18* aggregation segment: the stem's 3
    kernel rows (576 elements), 16 convs × 3 kernel rows (12,288) and the
    head (640) — 52 groups."""
    return [576 // 4] * 3 + [12288 // 4] * 48 + [640 // 4]


def quantize_pack_segment_checks(dev) -> float:
    """quantize_pack as the federated encode launches it: ResNet18*'s
    segments (the stem's 3 kernel rows of 576 elements, a conv's 3 of
    12,288, the head's 640), each written through ``out=`` at its byte
    offset of one leaf buffer, in payload mode (Δ by the threshold rule) and
    server mode (Δ = server_delta). Codes, counts and the bytes around the
    segments exact; tile sums within 1e-6 relative. Returns the largest
    absolute sum error."""
    import torch

    from repro_torch.core.encode import segment_scalars
    from repro_torch.core.fttq import FTTQConfig
    from repro_torch.core.ternary import packed_nbytes
    from repro_torch.kernels.quantize_pack import quantize_pack, quantize_pack_plain

    fcfg = FTTQConfig()
    gen = torch.Generator(dev).manual_seed(14)
    guard = 16
    worst = 0.0
    for shape in ((3, 3, 3, 64), (3, 3, 64, 64), (64, 10)):
        leaf = torch.randn(shape, generator=gen, device=dev) * 0.05
        rows = leaf.reshape(shape[0] if len(shape) >= 3 else 1, -1)
        seg_bytes = packed_nbytes(rows.shape[1])
        for mode in ("payload", "server"):
            denom, delta = segment_scalars(rows, mode, fcfg)
            scal = torch.cat([denom, delta], dim=1).to(torch.float32)
            buf = torch.full((guard + rows.shape[0] * seg_bytes + guard,), 0xA5,
                             dtype=torch.uint8, device=dev)
            want = buf.clone()
            bad_counts, rel, err = 0, 0.0, 0.0
            for i in range(rows.shape[0]):
                at = guard + i * seg_bytes
                _, moments = quantize_pack(rows[i], scal[i], out=buf[at:at + seg_bytes])
                ref_packed, ref_moments = quantize_pack_plain(rows[i], scal[i])
                want[at:at + seg_bytes] = ref_packed
                bad_counts += int((moments[:, 1] != ref_moments[:, 1]).sum())
                err = max(err, float((moments[:, 0] - ref_moments[:, 0]).abs().max()))
                rel = max(rel, float(((moments[:, 0] - ref_moments[:, 0]).abs()
                                      / ref_moments[:, 0].abs().clamp_min(1e-30)).max()))
            torch.cuda.synchronize()
            bad_bytes = int((buf != want).sum())
            worst = max(worst, err)
            print(f"  {mode} {shape}: {rows.shape[0]} segment(s) of {rows.shape[1]} elements "
                  f"into one buffer: {bad_bytes} bytes differ (guards included), "
                  f"{bad_counts} counts differ, sum max rel err {rel:.3e}")
            check(bad_bytes == 0 and bad_counts == 0 and rel <= 1e-6,
                  f"quantize_pack segment write disagrees ({mode}, {shape})")
    return worst


def resnet_upload_segments(dev, mode: str):
    """One ResNet18* (full width, seed 1, perturbed) encode's 52 segments as
    ``core.encode`` stages them: flat fp32 rows read in place and their
    (denom, Δ) rows, in payload (client upload) or server (broadcast)
    mode."""
    import torch

    from repro_torch.core import encode, fttq
    from repro_torch.core.fttq import FTTQConfig, init_wq_tree
    from repro_torch.models.paper_models import init_resnet_cifar
    from repro_torch.tree import flatten_with_path

    cfg = FTTQConfig()
    params = init_resnet_cifar(seed=1, device=dev)
    gen = torch.Generator(dev).manual_seed(21)
    leaves = {p: leaf + 0.01 * torch.randn(leaf.shape, generator=gen, device=dev)
              for p, leaf in flatten_with_path(params)}
    rows, scals = [], []
    for path, wq in flatten_with_path(init_wq_tree(params, cfg)):
        item = encode._Item(leaf=leaves[path], mode=mode, cfg=cfg, wq=wq,
                            stacked=fttq._is_stacked(leaves[path], wq))
        seg_rows, scal, n_seg = encode._segments(item)
        rows += [seg_rows[i] for i in range(n_seg)]
        scals.append(scal)
    return rows, torch.cat(scals)


def quantize_pack_fed_checks(dev) -> float:
    """quantize_pack_segments as the federated encode launches it: one
    ResNet18* encode's 52 segments in ONE launch into a guarded buffer, in
    payload and server mode (with the scales formed on the card), against
    the plain per-segment versions: bytes and guard bytes identical, counts
    exact, tile sums and scales within 1e-6 relative. Returns the largest
    absolute sum error."""
    import torch

    from repro_torch.kernels.quantize_pack import (
        quantize_pack, quantize_pack_segments, quantize_pack_segments_plain, segment_layout,
    )

    guard = 16
    worst = 0.0
    for mode in ("payload", "server"):
        rows, scal = resnet_upload_segments(dev, mode)
        lay = segment_layout([r.numel() for r in rows])
        buf = torch.full((guard + lay.n_bytes + guard,), 0xA5, dtype=torch.uint8, device=dev)
        before = quantize_pack.launches
        _, moments, scales = quantize_pack_segments(rows, scal, out=buf[guard:guard + lay.n_bytes],
                                                    with_scales=mode == "server")
        launched = quantize_pack.launches - before
        ref_packed, ref_moments, ref_scales = quantize_pack_segments_plain(
            rows, scal, with_scales=mode == "server")
        torch.cuda.synchronize()
        want = torch.full_like(buf, 0xA5)
        want[guard:guard + lay.n_bytes] = ref_packed
        bad_bytes = int((buf != want).sum())
        bad_counts = int((moments[:, 1] != ref_moments[:, 1]).sum())
        err = float((moments[:, 0] - ref_moments[:, 0]).abs().max())
        rel = float(((moments[:, 0] - ref_moments[:, 0]).abs()
                     / ref_moments[:, 0].abs().clamp_min(1e-30)).max())
        srel = 0.0
        if scales is not None:
            srel = float(((scales - ref_scales).abs() / ref_scales.abs().clamp_min(1e-30)).max())
        worst = max(worst, err)
        print(f"  {mode}: {len(rows)} segments ({lay.n_tiles} tiles, {lay.n_bytes} wire bytes) "
              f"in {launched} launch(es): {bad_bytes} bytes differ (guards included), {bad_counts} "
              f"counts differ, sum max rel err {rel:.3e}, scale max rel err {srel:.3e}")
        check(launched == 1 and bad_bytes == 0 and bad_counts == 0 and rel <= 1e-6
              and srel <= 1e-6, f"quantize_pack_segments disagrees ({mode})")
    return worst


def quantize_pack_fed_timings(dev, n_uploads: int) -> dict:
    """One ResNet18* encode's 52 segments: first as 52 one-segment calls
    through ``out=`` (the old encode's launch count), then in one call
    (payload mode, and server mode with the scales), the plain version, and
    the bound; per encode and per round (``n_uploads`` client uploads and
    one broadcast). Every call runs eagerly, as ``core.encode`` makes it:
    the segment table's host build and copy are inside the time."""
    import torch

    from repro_torch.core.ternary import packed_nbytes
    from repro_torch.kernels.quantize_pack import (
        quantize_pack, quantize_pack_segments, quantize_pack_segments_plain, segment_layout,
    )

    out = {}
    for mode in ("payload", "server"):
        rows, scal = resnet_upload_segments(dev, mode)
        lay = segment_layout([r.numel() for r in rows])
        buf = torch.empty(lay.n_bytes, dtype=torch.uint8, device=dev)
        views = [buf[b:b + packed_nbytes(r.numel())] for b, r in zip(lay.byte_offsets, rows)]
        scales = mode == "server"
        if mode == "payload":
            out["segments"] = len(rows)
            out["old_ms"] = time_ms(lambda: [quantize_pack(r, scal[i], out=views[i])
                                             for i, r in enumerate(rows)], 50, graph=False)
        out[f"{mode}_ms"] = time_ms(
            lambda: quantize_pack_segments(rows, scal, out=buf, with_scales=scales), 50,
            graph=False)
        out[f"{mode}_plain_ms"] = time_ms(
            lambda: quantize_pack_segments_plain(rows, scal, with_scales=scales), 5, graph=False)
        nbytes = (sum(4 * r.numel() for r in rows) + lay.n_bytes + 8 * lay.n_tiles
                  + 8 * len(rows) + (4 * len(rows) if scales else 0))
        out[f"{mode}_bound_ms"], out[f"{mode}_bound_by"] = bound(nbytes, 4 * sum(r.numel() for r in rows))
        out[f"{mode}_bytes"] = nbytes
    out["round_old_ms"] = (n_uploads + 1) * out["old_ms"]
    out["round_ms"] = n_uploads * out["payload_ms"] + out["server_ms"]
    out["round_bound_ms"] = n_uploads * out["payload_bound_ms"] + out["server_bound_ms"]
    print(f"quantize_pack, one ResNet18* encode ({out['segments']} segments), eager: "
          f"{out['segments']} one-segment calls {out['old_ms']:.4f} ms; one call "
          f"{out['payload_ms']:.4f} ms "
          f"(payload), {out['server_ms']:.4f} ms (server, scales on the card); plain "
          f"{out['payload_plain_ms']:.4f} / {out['server_plain_ms']:.4f} ms; bound "
          f"{out['payload_bound_ms']:.5f} / {out['server_bound_ms']:.5f} ms "
          f"({out['payload_bound_by']}, {out['payload_bytes']} / {out['server_bytes']} B)")
    print(f"quantize_pack per federated round ({n_uploads} uploads + 1 broadcast), eager: "
          f"{(n_uploads + 1) * out['segments']} one-segment calls {out['round_old_ms']:.4f} ms, "
          f"{n_uploads + 1} calls {out['round_ms']:.4f} ms, bound {out['round_bound_ms']:.5f} ms")
    return out


def deploy_segments(leaves, fcfg):
    """The serving deploy's encode staging (``core.encode`` in codec mode,
    as ``ternary_deploy`` reaches it): every quantized leaf one flat segment
    read in place, its (denom, Δ) row by the threshold rule."""
    import torch

    from repro_torch.core import encode

    segs = [encode._segments(encode._Item(leaf=leaf, mode="codec", cfg=fcfg))
            for leaf in leaves]
    return [rows[0] for rows, _, _ in segs], torch.cat([scal for _, scal, _ in segs])


def quantize_pack_deploy_checks(rows, scal):
    """quantize_pack_segments as the serving deploy launches it: olmo-1b's
    quantized leaves as one segment each (2^26 to 2^28 elements, 2,048 to
    8,192 moment tiles), in one launch with the scales formed on the card,
    into a guarded buffer, against the plain version: bytes and guard bytes
    identical, counts exact, tile sums and scales within 1e-6 relative.
    Returns (largest absolute sum error, the kernel's bytes, its scales)."""
    import torch

    from repro_torch.kernels.quantize_pack import (
        quantize_pack, quantize_pack_segments, quantize_pack_segments_plain, segment_layout,
    )

    guard = 16
    lay = segment_layout([r.numel() for r in rows])
    buf = torch.full((guard + lay.n_bytes + guard,), 0xA5, dtype=torch.uint8, device=scal.device)
    before = quantize_pack.launches
    packed, moments, scales = quantize_pack_segments(
        rows, scal, out=buf[guard:guard + lay.n_bytes], with_scales=True)
    launched = quantize_pack.launches - before
    ref_packed, ref_moments, ref_scales = quantize_pack_segments_plain(rows, scal, True)
    torch.cuda.synchronize()
    bad_bytes = (int((packed != ref_packed).sum()) + int((buf[:guard] != 0xA5).sum())
                 + int((buf[guard + lay.n_bytes:] != 0xA5).sum()))
    bad_counts = int((moments[:, 1] != ref_moments[:, 1]).sum())
    err = float((moments[:, 0] - ref_moments[:, 0]).abs().max())
    rel = float(((moments[:, 0] - ref_moments[:, 0]).abs()
                 / ref_moments[:, 0].abs().clamp_min(1e-30)).max())
    srel = float(((scales - ref_scales).abs() / ref_scales.abs().clamp_min(1e-30)).max())
    print(f"  {len(rows)} segments of {min(lay.sizes)}..{max(lay.sizes)} elements "
          f"({lay.n_tiles} tiles, {lay.n_bytes} wire bytes) in {launched} launch(es): "
          f"{bad_bytes} bytes differ (guards included), {bad_counts} counts differ, sum max "
          f"rel err {rel:.3e}, scale max rel err {srel:.3e}")
    check(launched == 1 and bad_bytes == 0 and bad_counts == 0 and rel <= 1e-6
          and srel <= 1e-6, "quantize_pack_segments disagrees on the deploy's segments")
    return err, packed, scales


def onehot_matmul_mismatches(m: int, k: int, n: int, gen, dev) -> int:
    """ternary_matmul on weights with one nonzero code per column (±1 at a
    random k, every other code 0): each output is ±x[i, k_n] · w_q, a single
    exact product, so every summation order gives it exactly and the kernel
    must equal its plain version and its bf16 split bit for bit. A kernel
    that lost a part of the split (lo is about 2^-17 of x) or misplaced a k
    differs. Returns the number of output elements that differ."""
    import torch

    from repro_torch.kernels.ternary_matmul import (
        ternary_matmul, ternary_matmul_plain, ternary_matmul_split,
    )

    x = torch.randn(m, k, generator=gen, device=dev)
    codes = torch.ones(k, n, dtype=torch.uint8, device=dev)
    at = torch.randint(0, k, (n,), generator=gen, device=dev)
    codes[at, torch.arange(n, device=dev)] = 2 * torch.randint(
        0, 2, (n,), generator=gen, device=dev, dtype=torch.uint8)
    c = codes.reshape(k // 4, 4, n)
    packed = c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)
    wq = torch.tensor(0.37, device=dev)
    y = ternary_matmul(x, packed, wq)
    y_ref = ternary_matmul_plain(x, packed, wq)
    y_split = ternary_matmul_split(x, packed, wq)
    torch.cuda.synchronize()
    return int(((y != y_ref) | (y != y_split)).sum())


def encode_checks(fold, trained, fcfg) -> None:
    """The card's fused encode against the reference chain (``fused=False``)
    on the same card: the broadcast of the last round's fold
    (``server_requantize``) and one client's upload (``client_update_payload``)
    from its trained params and factors. Upload wire bytes byte-identical;
    broadcast codes, shapes and dtypes identical and scales within 1e-6
    relative (the tile sums run in another order)."""
    import torch

    from repro_torch.comm.wire import encode_update
    from repro_torch.core.ternary import TernaryTensor
    from repro_torch.core.tfedavg import client_update_payload, server_requantize
    from repro_torch.tree import flatten_with_path

    def host(x):
        return torch.as_tensor(x).cpu()

    params_k, wq = trained
    up = [encode_update(client_update_payload(params_k, wq, fcfg, fused=f)) for f in (True, False)]
    print(f"client upload, fused vs reference chain on the card: {len(up[0])} and "
          f"{len(up[1])} wire bytes, byte-identical: {up[0] == up[1]}")
    check(up[0] == up[1], "client upload: the fused encode differs from the reference chain")

    fused, ref = (dict(flatten_with_path(server_requantize(fold, fcfg, fused=f),
                                         is_leaf=lambda x: isinstance(x, TernaryTensor)))
                  for f in (True, False))
    check(fused.keys() == ref.keys(), "broadcast: the two encodes hold different leaves")
    n_ternary, bad_codes, rel = 0, 0, 0.0
    for path, a in fused.items():
        b = ref[path]
        if not isinstance(b, TernaryTensor):
            check(not isinstance(a, TernaryTensor) and torch.equal(a, b),
                  f"broadcast: raw leaf {path} differs")
            continue
        n_ternary += 1
        check(isinstance(a, TernaryTensor) and a.shape == b.shape and a.dtype == b.dtype
              and a.w_q.shape == b.w_q.shape, f"broadcast: leaf {path} differs in framing")
        bad_codes += int((host(a.packed) != host(b.packed)).sum())
        wa, wb = host(a.w_q), host(b.w_q)
        rel = max(rel, float(((wa - wb).abs() / wb.abs().clamp_min(1e-30)).max()))
    print(f"broadcast of the last fold, fused vs reference chain on the card: {n_ternary} "
          f"ternary leaves, {bad_codes} code bytes differ, scales max rel err {rel:.3e} "
          f"(limit 1e-6)")
    check(bad_codes == 0 and rel <= 1e-6,
          "broadcast: the fused requantize differs from the reference chain")


def _fanin_kernels(kind: str):
    """(segment wrapper, its plain version, stacked wrapper, its plain
    version) of the aggregate or vote kernel; the stacked wrapper carries
    the launch count."""
    from repro_torch.kernels import aggregate, vote

    if kind == "aggregate":
        return (aggregate.packed_weighted_sum_segments,
                aggregate.packed_weighted_sum_segments_plain,
                aggregate.packed_weighted_sum, aggregate.packed_weighted_sum_plain)
    return (vote.packed_vote_counts_segments, vote.packed_vote_counts_segments_plain,
            vote.packed_vote_counts, vote.packed_vote_counts_plain)


def fanin_checks(dev, kind: str) -> float:
    """aggregate or vote against its plain version, bit for bit: ResNet18*'s
    52 segments with 10 clients in one launch, segments of 1, 3, 37 and 144
    bytes (ragged element counts) at C = 1, 3 and 17 in one launch each, and
    16 clients x 2^26 elements through the stacked entry point (a one-row
    table)."""
    import torch

    seg, seg_plain, stack, stack_plain = _fanin_kernels(kind)
    gen = torch.Generator(dev).manual_seed(12 if kind == "aggregate" else 15)
    resnet = [(b, 4 * b) for b in resnet_segment_bytes()]
    worst = 0.0
    cases = [("ResNet18*", resnet, FED_UPLOADS)] + [("ragged", RAGGED_SEGMENTS, c)
                                                    for c in (1, 3, 17)]
    for name, layout, c in cases:
        table, staged, coeffs, weights = fanin_case(layout, c, gen, dev)
        co = coeffs if kind == "aggregate" else weights
        before = stack.launches
        out = seg(staged, co, table)
        launched = stack.launches - before
        ref = seg_plain(staged, co, table)
        torch.cuda.synchronize()
        differ = int((out.view(torch.int32) != ref.view(torch.int32)).sum())
        worst = max(worst, _max_abs_diff(out, ref))
        print(f"  {name}: {table.n_segments} segments, C={c}, {table.row_bytes} staged bytes a "
              f"client, {launched} launch: {differ} of {out.numel()} outputs differ")
        check(launched == 1, f"{kind}: {launched} launches for one segment table")
        check(differ == 0, f"{kind} differs from its plain version ({name}, C={c})")
    stacked, coeffs = _tile_stack(STRESS_ELEMENTS // 4, FANIN_C, FANIN_C, gen, dev)
    if kind == "vote":
        coeffs = torch.randint(40, 600, (FANIN_C,), generator=gen, device=dev) / 7.0
    out = stack(stacked, coeffs)
    ref = stack_plain(stacked, coeffs)
    torch.cuda.synchronize()
    differ = int((out.view(torch.int32) != ref.view(torch.int32)).sum())
    worst = max(worst, _max_abs_diff(out, ref))
    print(f"  C={FANIN_C} x {STRESS_ELEMENTS} elements ({tuple(stacked.shape)} bytes, one-row "
          f"table): {differ} of {out.numel()} outputs differ")
    check(differ == 0, f"{kind} differs from its plain version at C={FANIN_C} x "
                       f"{STRESS_ELEMENTS} elements")
    del stacked, out, ref
    torch.cuda.empty_cache()
    return worst


def federated_setup(dev, samples: int = FED_SAMPLES, n_test: int = FED_TEST,
                    n_clients: int = 100):
    """Synthetic CIFAR-shaped data split IID over the clients, ResNet18* at
    full width from seed 1, and the test-set scorer."""
    from repro_torch.data import partition_iid, synthetic_classification
    from repro_torch.launch.federated import make_eval_fn
    from repro_torch.models.paper_models import init_resnet_cifar, resnet_cifar

    x, y, xt, yt = synthetic_classification(0, n_clients * samples, 10, 3072,
                                            image_hw=(32, 32, 3), noise=3.0, n_test=n_test)
    return (partition_iid(x, y, n_clients), init_resnet_cifar(seed=1, device=dev),
            make_eval_fn(resnet_cifar, xt, yt, dev))


def federated_phase(dev, setup, *, rounds: int = FED_ROUNDS, **cfg_kw) -> dict:
    """T-FedAvg sync rounds on ResNet18* at full width through
    ``run_federated``; returns what the kernel table and PERF.md need."""
    import numpy as np
    import torch

    from repro_torch.comm.wire import decode_update
    from repro_torch.core.tfedavg import TernaryUpdate, server_aggregate
    from repro_torch.fed import simulation as sim
    from repro_torch.fed.aggregator import Aggregator
    from repro_torch.kernels.aggregate import packed_weighted_sum
    from repro_torch.kernels.quantize_pack import quantize_pack
    from repro_torch.kernels.ternary_matmul import ternary_matmul
    from repro_torch.models.paper_models import param_count, resnet_cifar
    from repro_torch.optim import adam
    from repro_torch.tree import flatten_with_path

    clients, params, eval_fn = setup
    samples = len(clients[0])
    cfg = sim.FedConfig(rounds=rounds, n_clients=len(clients), **cfg_kw)
    print(f"ResNet18* full width: {param_count(params)} params; {cfg.n_clients} clients x "
          f"{samples} samples, lambda {cfg.participation}, E {cfg.local_epochs}, "
          f"B {cfg.batch_size}, adam(1e-3), {rounds} rounds")

    kernels = (quantize_pack, packed_weighted_sum, ternary_matmul)
    encodes = [0]             # client uploads encoded so far

    class Timer(sim.PhaseTimer):
        def start_round(self, r):
            super().start_round(r)
            self.launches.append([k.launches for k in kernels] + [encodes[0]])

    class Recorder(Aggregator):
        """Keeps the last round's uploads and fold for the reference check."""

        def add(self, blob, weight):
            if self.n_clients == 0:
                self.seen = []
            self.seen.append((blob, weight))
            super().add(blob, weight)

        def finalize(self, *, reset=False):
            adds.append(len(self.seen))
            self.last = (list(self.seen), super().finalize(reset=False))
            if reset:
                self.reset()
            return self.last[1]

    timer = Timer(dev)
    timer.launches = []
    recorders = []
    adds = []                 # uploads folded in each round

    def make_recorder(*a, **kw):
        recorders.append(Recorder(*a, **kw))
        return recorders[-1]

    trained = []
    plain_payload = sim.client_update_payload

    def recording_payload(params_k, wq, fcfg, **kw):
        trained[:] = [(params_k, wq)]           # the last client trained
        encodes[0] += 1
        return plain_payload(params_k, wq, fcfg, **kw)

    plain_aggregator = sim.Aggregator
    sim.Aggregator = make_recorder
    sim.client_update_payload = recording_payload
    try:
        zero_counters()
        t0 = time.perf_counter()
        res = sim.run_federated(resnet_cifar, params, clients, cfg, adam(1e-3), eval_fn,
                                eval_every=1, device=dev, timer=timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = [k.launches for k in kernels]
        others = read_counters()
    finally:
        sim.Aggregator = plain_aggregator
        sim.client_update_payload = plain_payload
    marks = timer.launches + [launches + [encodes[0]]]
    per_round = []
    for r in range(rounds):
        ph = timer.rounds[r]
        lq, la, lt, uploads = (marks[r + 1][i] - marks[r][i] for i in range(4))
        row = {"round": r, "upload_bytes": res.telemetry["upload_bytes_per_round"][r],
               "download_bytes": res.telemetry["download_bytes_per_round"][r],
               "sim_s": res.round_times[r], "accuracy": res.accuracy[r], "loss": res.loss[r],
               "participants": res.participants_per_round[r],
               "wall_s": {k: ph.get(k, 0.0) for k in ("train", "encode", "wire", "aggregate",
                                                      "requantize")},
               "uploads_encoded": uploads,
               "launches": {"quantize_pack": lq, "aggregate": la, "ternary_matmul": lt}}
        per_round.append(row)
        w = row["wall_s"]
        print(f"  round {r}: up {row['upload_bytes']} B, down {row['download_bytes']} B, "
              f"{row['participants']} clients, simulated {row['sim_s']:.3f} s; wall: train "
              f"{w['train']:.2f} s, encode {w['encode']:.3f} s, wire {w['wire']:.3f} s, "
              f"aggregate {w['aggregate']:.3f} s, requantize {w['requantize']:.3f} s; "
              f"acc {row['accuracy']:.4f}, loss {row['loss']:.4f}; launches quantize_pack "
              f"{lq} ({uploads} uploads + 1 broadcast encoded), aggregate {la} "
              f"({adds[r]} uploads folded)")
        check(lq == uploads + 1, f"round {r}: quantize_pack launched {lq} times for {uploads} "
                                 "uploads and 1 broadcast: want one launch per tree encode")
        flushes = -(-adds[r] // cfg.agg_chunk_c)
        check(la == flushes, f"round {r}: aggregate launched {la} times for {adds[r]} uploads at "
                             f"agg_chunk_c {cfg.agg_chunk_c}: want one launch per flush "
                             f"({flushes})")
        check(np.isfinite(row["loss"]) and 0.0 <= row["accuracy"] <= 1.0,
              f"round {r}: accuracy/loss not finite")
        check(row["upload_bytes"] > 0 and row["download_bytes"] > 0, f"round {r}: no bytes")
    print(f"{rounds} rounds in {wall:.2f} s of wall time; fp32 model "
          f"{4 * param_count(params)} B, T-FedAvg upload per client "
          f"{res.upload_bytes // sum(res.participants_per_round)} B")
    check(others["vote"] == 0, "the mean rounds launched vote")

    blobs, fold = recorders[-1].last
    updates = [TernaryUpdate(payload=decode_update(b), n_samples=int(w)) for b, w in blobs]
    listed = dict(flatten_with_path(server_aggregate(updates, dev)))
    cpu_agg = Aggregator(chunk_c=cfg.agg_chunk_c, device="cpu")
    for b, w in blobs:
        cpu_agg.add(b, w)
    cpu_fold = dict(flatten_with_path(cpu_agg.finalize()))
    worst, worst_cpu = 0.0, 0
    for path, leaf in flatten_with_path(fold):
        ref = listed[path]
        err = (leaf - ref).abs()
        check(bool((err <= 1e-6 + 1e-5 * ref.abs()).all()),
              f"kernel fold disagrees with server_aggregate at {path}")
        worst = max(worst, float(err.max()))
        worst_cpu += int((leaf.cpu() != cpu_fold[path]).sum())
    print(f"last round's fold ({len(blobs)} uploads): max |d| vs server_aggregate "
          f"{worst:.3e} (limit 1e-6 + 1e-5|ref|); {worst_cpu} elements differ from the "
          f"CPU plain fold")
    check(worst_cpu == 0, "the kernel fold differs from the plain fold")
    encode_checks(fold, trained[0], cfg.fttq)
    return {"per_round": per_round, "launches": launches, "wall_s": wall,
            "fold_vs_list_max_abs": worst, "last_uploads": blobs}


def fanin_timings(dev, kind: str, uploads) -> dict:
    """One round's fold in one launch (ResNet18*'s 52 segments, 10 clients):
    the kernel as a CUDA-graph replay, and eagerly as ``Aggregator``'s flush
    runs it on the last federated round's uploads (staging fill, pinned
    copy, launch); beside it the per-segment staging and launch pattern on
    this kernel (52 one-row launches of 32-row tiles at C = 16), and 16
    clients x 2^26 elements; plain versions and bytes bounds."""
    import torch

    from repro_torch.fed.aggregator import Aggregator
    from repro_torch.kernels.aggregate import stack_table

    seg, seg_plain, _, _ = _fanin_kernels(kind)
    planes = 1 if kind == "aggregate" else 2
    gen = torch.Generator(dev).manual_seed(13 if kind == "aggregate" else 16)
    resnet = [(b, 4 * b) for b in resnet_segment_bytes()]
    table, staged, coeffs, weights = fanin_case(resnet, FED_UPLOADS, gen, dev)
    co = coeffs if kind == "aggregate" else weights
    out = {"round_ms": time_ms(lambda: seg(staged, co, table), 50),
           "round_plain_ms": time_ms(lambda: seg_plain(staged, co, table), 5, graph=False)}
    round_bytes = fanin_bytes(table, FED_UPLOADS, planes)
    out["round_bound_ms"], out["round_bound_by"] = bound(round_bytes, 0)

    agg = Aggregator(chunk_c=FANIN_C, device=dev, rule="mean" if planes == 1 else "majority")
    for blob, weight in uploads:
        agg.add(blob, weight)                  # fewer than chunk_c: all pending
    check(len(agg._pending) == len(uploads), "the eager flush's clients were flushed early")
    pending = list(agg._pending)

    def flush():
        agg._pending[:] = pending
        agg._partial = agg._counts = None
        agg._flush()

    out["eager_ms"] = time_ms(flush, 20, graph=False)

    def one_row(stacked, c):
        flat = stacked.reshape(stacked.shape[0], -1)
        return flat, (c.reshape(-1, 1) if planes == 1 else c), stack_table(stacked)

    groups = [one_row(*_tile_stack(nb, FANIN_C, FED_UPLOADS, gen, dev))
              for nb in resnet_segment_bytes()]
    out["old_path_ms"] = time_ms(lambda: [seg(*g) for g in groups], 50)
    stress = one_row(*_tile_stack(STRESS_ELEMENTS // 4, FANIN_C, FANIN_C, gen, dev))
    out["stress_ms"] = time_ms(lambda: seg(*stress), 20)
    out["stress_plain_ms"] = time_ms(lambda: seg_plain(*stress), 3, graph=False)
    stress_bytes = fanin_bytes(stress[2], FANIN_C, planes)
    out["stress_bound_ms"], out["stress_bound_by"] = bound(stress_bytes, 0)
    print(f"{kind}, one round's fold (52 segments, {FED_UPLOADS} clients, one launch): kernel "
          f"{out['round_ms']:.4f} ms (graph replay), eager flush {out['eager_ms']:.4f} ms "
          f"(staging fill, pinned copy, launch), plain {out['round_plain_ms']:.4f} ms, bound "
          f"{out['round_bound_ms']:.5f} ms ({out['round_bound_by']}, {round_bytes} B); "
          f"per segment, 52 launches of 32-row tiles at C={FANIN_C}: "
          f"{out['old_path_ms']:.4f} ms; library: none")
    print(f"{kind}, C={FANIN_C} x {STRESS_ELEMENTS} elements: kernel {out['stress_ms']:.4f} ms, "
          f"plain {out['stress_plain_ms']:.4f} ms, bound {out['stress_bound_ms']:.4f} ms "
          f"({out['stress_bound_by']}, {stress_bytes} B); library: none")
    del groups, stress
    torch.cuda.empty_cache()
    return out


def _max_abs_diff(a, b) -> float:
    import torch

    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def ternary_quantize_checks(layers) -> float:
    """ternary_quantize against its plain version on every given fp32 layer
    and on the first in bf16, with the layer's own statistics
    (``ops.fttq_scalars``): codes and θ_t bit for bit. Returns the largest
    |Δ| of the codes and of θ_t."""
    import torch

    from repro_torch.kernels.ops import fttq_scalars
    from repro_torch.kernels.ternary_quantize import ternary_quantize, ternary_quantize_plain

    bad_codes = bad_theta = n = 0
    worst = 0.0
    for theta in layers + [layers[0].to(torch.bfloat16)]:
        scal = fttq_scalars(theta, 0.7)
        it, tt = ternary_quantize(theta, *scal)
        it_ref, tt_ref = ternary_quantize_plain(theta, *scal)
        bad_codes += int((it != it_ref).sum())
        bad_theta += int((tt.view(torch.uint8) != tt_ref.view(torch.uint8)).sum())
        worst = max(worst, _max_abs_diff(it, it_ref), _max_abs_diff(tt, tt_ref))
        n += theta.numel()
    torch.cuda.synchronize()
    print(f"  {len(layers)} fp32 layers and 1 bf16 layer, {n} weights: {bad_codes} codes and "
          f"{bad_theta} bytes of theta_t differ; max |diff| {worst}")
    check(bad_codes == 0 and bad_theta == 0, "ternary_quantize differs from its plain version")
    return worst


def pack_checks(served) -> tuple[float, float]:
    """unpack2bit on the served 2-bit weights of olmo-1b against the plain
    unpack, and pack2bit of the plain unpack against pack2bit_plain and the
    served bytes. Returns the largest |Δ| of (pack2bit, unpack2bit)."""
    import torch

    from repro_torch.kernels.pack2bit import pack2bit, pack2bit_plain, unpack2bit, unpack2bit_plain

    n_codes = bad_unpack = bad_pack = 0
    pack_err = unpack_err = 0.0
    for group in ("attn", "mlp"):
        for name, w in served["blocks"][group].items():
            packed = w.packed.reshape(-1, w.packed.shape[-1])   # layers stacked along K
            codes, codes_ref = unpack2bit(packed), unpack2bit_plain(packed)
            bad_unpack += int((codes != codes_ref).sum())
            unpack_err = max(unpack_err, _max_abs_diff(codes, codes_ref))
            repacked, repacked_ref = pack2bit(codes_ref), pack2bit_plain(codes_ref)
            bad_pack += int((repacked != repacked_ref).sum()) + int((repacked != packed).sum())
            pack_err = max(pack_err, _max_abs_diff(repacked, repacked_ref),
                           _max_abs_diff(repacked, packed))
            n_codes += codes.numel()
            del codes, codes_ref, repacked, repacked_ref
    torch.cuda.synchronize()
    print(f"  {n_codes} served codes: {bad_unpack} unpacked codes differ from the plain "
          f"unpack, {bad_pack} packed bytes differ from pack2bit_plain or the served bytes; "
          f"max |diff| pack {pack_err}, unpack {unpack_err}")
    check(n_codes == 2 ** 30, f"expected 2^30 served codes, got {n_codes}")
    check(bad_unpack == 0 and bad_pack == 0, "pack2bit / unpack2bit differ from their plain "
          "versions on the served bytes")
    return pack_err, unpack_err


def quickstart_checks(qs: dict, t_k: float) -> dict:
    """The quickstart's own kernel outputs on the card against the plain
    versions on the same inputs, bit for bit: ternary_quantize (codes and
    θ_t) on its layer with the statistics ``ops.fttq_apply`` used,
    pack2bit on its codes, unpack2bit on its packed bytes. Returns the
    largest |Δ| per kernel."""
    import torch

    from repro_torch.kernels.ops import fttq_scalars
    from repro_torch.kernels.pack2bit import pack2bit_plain, unpack2bit_plain
    from repro_torch.kernels.ternary_quantize import ternary_quantize_plain

    t = qs["tensors"]
    scal = fttq_scalars(t["theta"], t_k)
    check(torch.equal(scal[2].view(torch.int32), t["w_q"].view(torch.int32)),
          "fttq_scalars does not give the w_q that fttq_apply used")
    it_ref, tt_ref = ternary_quantize_plain(t["theta"], *scal)
    packed_ref = pack2bit_plain(t["i_t"])
    unpacked_ref = unpack2bit_plain(t["packed"])
    differ = {
        "ternary_quantize": int((t["i_t"] != it_ref).sum())
        + int((t["theta_t"].view(torch.int32) != tt_ref.view(torch.int32)).sum()),
        "pack2bit": int((t["packed"] != packed_ref).sum()),
        "unpack2bit": int((t["unpacked"] != unpacked_ref).sum()),
    }
    err = {
        "ternary_quantize": max(_max_abs_diff(t["i_t"], it_ref),
                                _max_abs_diff(t["theta_t"], tt_ref)),
        "pack2bit": _max_abs_diff(t["packed"], packed_ref),
        "unpack2bit": _max_abs_diff(t["unpacked"], unpacked_ref),
    }
    print(f"  quickstart layer {tuple(t['theta'].shape)} {t['theta'].dtype}, packed "
          f"{tuple(t['packed'].shape)}: elements that differ from the plain versions "
          f"{json.dumps(differ)}; max |diff| {json.dumps(err)}")
    for name, n in differ.items():
        check(n == 0, f"the quickstart's {name} output differs from its plain version")
    return err


def _fold(uploads, dev, rule: str) -> dict:
    from repro_torch.fed.aggregator import Aggregator
    from repro_torch.tree import flatten_with_path

    agg = Aggregator(chunk_c=FANIN_C, device=dev, rule=rule)
    for blob, weight in uploads:
        agg.add(blob, weight)
    return dict(flatten_with_path(agg.finalize()))


def _bits_differ(a: dict, b: dict) -> int:
    import torch

    check(a.keys() == b.keys(), "two folds hold different leaves")
    return sum(int((a[k].cpu().view(torch.int32) != b[k].cpu().view(torch.int32)).sum())
               for k in a)


def robust_phase(dev, setup, uploads) -> dict:
    """One defended T-FedAvg round on ResNet18* at full width: rule majority,
    30 seeded sign-flip attackers of 100 clients, its aggregate phase traced
    in place (the process's first majority fold). Then the robust folds of
    the last federated round's honest uploads on the card against the CPU
    plain folds, the sign-flip guarantee, and the gate on nan_poison."""
    import contextlib

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fed import simulation as sim
    from repro_torch.fed.attackers import AttackConfig, attacker_ids, poison_blob
    from repro_torch.fed.defense import DefenseConfig, UpdateGate
    from repro_torch.models.paper_models import resnet_cifar
    from repro_torch.optim import adam

    clients, params, eval_fn = setup
    attack = AttackConfig(kind="sign_flip", n_attackers=ROBUST_ATTACKERS, seed=0)
    cfg = sim.FedConfig(rounds=1, n_clients=len(clients), attack=attack,
                        defense=DefenseConfig(enabled=True, rule="majority"))
    print(f"ResNet18* full width, {cfg.n_clients} clients, lambda {cfg.participation}, "
          f"E {cfg.local_epochs}, B {cfg.batch_size}; defense rule majority; "
          f"{len(attacker_ids(attack, cfg.n_clients))} sign_flip attackers (seed 0)")
    class Timer(sim.PhaseTimer):
        """Traces the round's aggregate phase under torch.profiler (the
        phase's wall is taken inside the trace); the rest runs untraced."""

        @contextlib.contextmanager
        def phase(self, name):
            if name != "aggregate":
                with super().phase(name):
                    yield
                return
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                with super().phase(name):
                    yield
            self.prof = prof

    timer = Timer(dev)
    zero_counters()
    t0 = time.perf_counter()
    res = sim.run_federated(resnet_cifar, params, clients, cfg, adam(1e-3), eval_fn,
                            eval_every=1, device=dev, timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    d = res.telemetry["defense"]
    w = {k: timer.rounds[0].get(k, 0.0)
         for k in ("train", "attack", "encode", "wire", "gate", "aggregate", "requantize")}
    print(f"  round 0: up {res.upload_bytes} B, down {res.download_bytes} B, "
          f"{res.participants_per_round[0]} clients, simulated {res.round_times[0]:.3f} s; "
          f"wall {wall:.2f} s: " + ", ".join(f"{k} {v:.3f} s" for k, v in w.items())
          + f"; acc {res.accuracy[0]:.4f}, loss {res.loss[0]:.4f}")
    print(f"  defense telemetry: {json.dumps(d)}")
    print(f"  launches: {json.dumps(launches)}")
    traced = aggregator_ranges(timer.prof)
    print("  the round's aggregate phase, traced (the first majority fold of the process): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in traced.items()) + " of host time")
    report_trace(timer.prof, w["aggregate"] * 1e3, "  defended round, aggregate phase (traced)")
    check(d["ledger_balanced"], "the gate's ledger does not balance")
    check(d["passed_updates"] + d["quarantined_updates"] == res.participants_per_round[0],
          "the gate did not see every survivor")
    flushes = -(-d["passed_updates"] // cfg.agg_chunk_c)
    check(launches["vote"] == flushes, f"vote launched {launches['vote']} times for "
                                       f"{d['passed_updates']} uploads: want one launch per "
                                       f"flush ({flushes})")
    check(launches["aggregate"] == 0, "the majority round launched aggregate")
    check(np.isfinite(res.loss[0]) and 0.0 <= res.accuracy[0] <= 1.0, "robust round not finite")

    differ = {}
    for rule in ("majority", "median", "trimmed_mean"):
        differ[rule] = _bits_differ(_fold(uploads, dev, rule), _fold(uploads, "cpu", rule))
    print(f"  robust folds of the last federated round's {len(uploads)} uploads, card vs CPU "
          f"plain: elements that differ {json.dumps(differ)}")
    check(not any(differ.values()), "a robust fold on the card differs from the plain fold")

    honest = uploads[0][0]
    flipped = poison_blob(honest, AttackConfig(kind="sign_flip", n_attackers=4), client_id=0)
    defended = _fold([(honest, 2.0)] * 5 + [(flipped, 1.0)] * 4, dev, "majority")
    honest_only = _fold([(honest, 2.0)] * 5, dev, "majority")
    moved = _bits_differ(defended, honest_only)
    print(f"  5 honest copies at weight 2 + 4 sign-flipped at weight 1 vs the honest-only "
          f"majority: {moved} elements differ")
    check(moved == 0, "the sign-flip minority moved the majority fold")

    poisoned = {1, 4, 7}
    nan = AttackConfig(kind="nan_poison", n_attackers=len(poisoned))
    blobs = [poison_blob(b, nan, i) if i in poisoned else b for i, (b, _) in enumerate(uploads)]
    gate = UpdateGate(DefenseConfig(enabled=True), params)
    caught = {i for i, b in enumerate(blobs) if not gate.check(b).ok}
    balanced = gate.passed_bytes + gate.quarantined_bytes == sum(len(b) for b in blobs)
    print(f"  nan_poison on uploads {sorted(poisoned)}: quarantined {sorted(caught)} "
          f"({dict(gate.reasons)}), ledger balanced {balanced}")
    check(caught == poisoned and balanced, "the gate missed or over-caught nan_poison")
    return {"launches": launches, "wall_s": wall, "phase_wall_s": w, "defense": d,
            "aggregate_traced": True, "aggregate_host_ms": traced,
            "upload_bytes": res.upload_bytes, "download_bytes": res.download_bytes}


def _fold_gap(fold, ref) -> float:
    """Largest |fold - ref| over the leaves of two trees, checked against
    the sync round's limit 1e-6 + 1e-5·|ref| per element."""
    from repro_torch.tree import flatten_with_path

    want = dict(flatten_with_path(ref))
    worst = 0.0
    for path, leaf in flatten_with_path(fold):
        err = (leaf.to(want[path].device) - want[path]).abs()
        check(bool((err <= 1e-6 + 1e-5 * want[path].abs()).all()),
              f"fold disagrees with its reference at {path}")
        worst = max(worst, float(err.max()))
    return worst


def async_phase(dev, setup, *, rounds: int = ASYNC_MIXES, **cfg_kw) -> dict:
    """The buffered-async T-FedAvg server on ResNet18* at full width
    (``FedConfig`` defaults, so 10 clients in flight at λ 0.1; buffer_k 4,
    staleness exponent 0.5, η 1, staleness cap 1 with the drop policy):
    per mix the simulated time, wall seconds per phase, bytes, staleness,
    drops and accuracy; launches (one quantize_pack per dispatch and per
    broadcast version, one aggregate per mix on the run's one aggregator);
    the last mix's fold on its buffered blobs and staleness weights against
    ``server_aggregate``."""
    import numpy as np
    import torch

    from repro_torch.comm.wire import decode_update
    from repro_torch.core.tfedavg import TernaryUpdate, server_aggregate
    from repro_torch.fed import async_server
    from repro_torch.fed import simulation as sim
    from repro_torch.fed.aggregator import Aggregator
    from repro_torch.kernels.aggregate import packed_weighted_sum
    from repro_torch.kernels.quantize_pack import quantize_pack
    from repro_torch.models.paper_models import resnet_cifar
    from repro_torch.optim import adam

    clients, params, eval_fn = setup
    cfg = sim.FedConfig(mode="async", rounds=rounds, n_clients=len(clients), buffer_k=4,
                        staleness_exponent=0.5, mixing_rate=1.0, max_staleness=1,
                        staleness_policy="drop", **cfg_kw)
    print(f"ResNet18* full width, {cfg.n_clients} clients, lambda {cfg.participation} "
          f"(in flight {int(np.ceil(cfg.participation * cfg.n_clients))}), E {cfg.local_epochs}, "
          f"B {cfg.batch_size}; buffer_k {cfg.buffer_k}, alpha {cfg.staleness_exponent}, "
          f"eta {cfg.mixing_rate}, max_staleness {cfg.max_staleness} "
          f"({cfg.staleness_policy}), {rounds} mixes")
    tally = {"dispatches": 0, "versions": 0, "blob": 0, "down": 0, "up": 0, "adds": 0}

    def marks():
        return {"quantize_pack": quantize_pack.launches,
                "aggregate": packed_weighted_sum.launches, **tally}

    class Timer(sim.PhaseTimer):
        def start_round(self, r):
            super().start_round(r)
            self.marks.append(marks())

    class Recorder(Aggregator):
        """The run's one aggregator, keeping each mix's adds for the check."""

        def add(self, blob, weight):
            if self.n_clients == 0:
                self.seen = []
            self.seen.append((blob, weight))
            tally["up"] += len(blob)
            tally["adds"] += 1
            super().add(blob, weight)

        def note_dropped(self, nbytes):
            tally["up"] += nbytes
            super().note_dropped(nbytes)

        def finalize(self, *, reset=False):
            self.last = (list(self.seen), super().finalize(reset=False))
            if reset:
                self.reset()
            return self.last[1]

    recorders = []

    def make_recorder(*a, **kw):
        recorders.append(Recorder(*a, **kw))
        return recorders[-1]

    plain = (async_server.Aggregator, async_server.broadcast_blob, async_server.train_client)

    def counting_broadcast(*a, **kw):
        blob = plain[1](*a, **kw)
        tally["versions"] += 1
        tally["blob"] = len(blob)
        return blob

    def counting_train(*a, **kw):
        tally["dispatches"] += 1
        tally["down"] += tally["blob"]
        return plain[2](*a, **kw)

    timer = Timer(dev)
    timer.marks = []
    async_server.Aggregator = make_recorder
    async_server.broadcast_blob = counting_broadcast
    async_server.train_client = counting_train
    try:
        zero_counters()
        t0 = time.perf_counter()
        res = sim.run_federated(resnet_cifar, params, clients, cfg, adam(1e-3), eval_fn,
                                eval_every=1, device=dev, timer=timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counters()
    finally:
        (async_server.Aggregator, async_server.broadcast_blob,
         async_server.train_client) = plain
    tel = res.telemetry
    check(len(recorders) == 1, f"the async run made {len(recorders)} aggregators, want one")
    check(res.rounds_run == rounds and len(timer.rounds) == rounds, "the run did not mix "
          f"{rounds} times")
    ends = timer.marks[1:] + [marks()]
    per_mix = []
    for r in range(rounds):
        d = {k: ends[r][k] - timer.marks[r][k] for k in ends[r]}
        ph = timer.rounds[r]
        row = {"mix": r, "sim_s": res.round_times[r], "upload_bytes": d["up"],
               "download_bytes": d["down"], "dispatches": d["dispatches"],
               "broadcast_versions": d["versions"], "folded": d["adds"],
               "buffer_k": tel["buffer_k_per_agg"][r], "accuracy": res.accuracy[r],
               "loss": res.loss[r],
               "wall_s": {k: ph.get(k, 0.0) for k in ("train", "encode", "wire",
                                                      "requantize", "aggregate")},
               "launches": {"quantize_pack": d["quantize_pack"], "aggregate": d["aggregate"]}}
        per_mix.append(row)
        w = row["wall_s"]
        print(f"  mix {r}: simulated {row['sim_s']:.3f} s since the last mix; up "
              f"{row['upload_bytes']} B, down {row['download_bytes']} B; {row['dispatches']} "
              f"dispatches, {row['broadcast_versions']} broadcast versions, "
              f"{row['folded']} uploads folded (buffer_k {row['buffer_k']}); wall: "
              + ", ".join(f"{k} {v:.3f} s" for k, v in w.items())
              + f"; acc {row['accuracy']:.4f}, loss {row['loss']:.4f}; launches "
              f"quantize_pack {d['quantize_pack']}, aggregate {d['aggregate']}")
        check(d["quantize_pack"] == d["dispatches"] + d["versions"],
              f"mix {r}: quantize_pack launched {d['quantize_pack']} times for "
              f"{d['dispatches']} dispatches and {d['versions']} broadcast versions")
        check(d["aggregate"] == 1 and d["adds"] == row["buffer_k"],
              f"mix {r}: aggregate launched {d['aggregate']} times for {d['adds']} uploads "
              "(want one launch per mix)")
        check(np.isfinite(row["loss"]) and 0.0 <= row["accuracy"] <= 1.0,
              f"mix {r}: accuracy/loss not finite")
    print(f"{rounds} mixes in {wall:.2f} s of wall time: {tally['dispatches']} dispatches, "
          f"{tally['versions']} broadcast versions; up {res.upload_bytes} B, down "
          f"{res.download_bytes} B; staleness histogram {tel['staleness_hist']}, "
          f"buffer_k per mix {tel['buffer_k_per_agg']}, dropped {tel['dropped_updates']} "
          f"updates ({tel['dropped_update_bytes']} B)")
    check(launches["quantize_pack"] == tally["dispatches"] + tally["versions"],
          "quantize_pack launches differ from dispatches + broadcast versions")
    check(launches["aggregate"] == rounds, f"aggregate launched {launches['aggregate']} "
                                           f"times in {rounds} mixes")
    check(launches["vote"] == 0, "the mean mixes launched vote")
    check(tally["versions"] == rounds, "a broadcast version was encoded twice")
    check(res.upload_bytes == tally["up"] and res.download_bytes == tally["down"],
          "the per-mix bytes do not add up to the run's")
    check(sum(tel["staleness_hist"]) == len(res.staleness_per_agg)
          and tel["dropped_updates"] == sum(1 for s in res.staleness_per_agg if s > 1),
          "the staleness ledger does not add up")

    blobs, fold = recorders[0].last
    updates = [TernaryUpdate(payload=decode_update(b), n_samples=w) for b, w in blobs]
    worst = _fold_gap(fold, server_aggregate(updates, dev))
    print(f"last mix's fold ({len(blobs)} uploads at staleness weights "
          f"{[round(w, 3) for _, w in blobs]}): max |d| vs server_aggregate {worst:.3e} "
          "(limit 1e-6 + 1e-5|ref|)")
    agg_s = [m["wall_s"]["aggregate"] for m in per_mix]
    return {"per_mix": per_mix, "launches": launches, "wall_s": wall,
            "fold_vs_list_max_abs": worst, "dispatches": tally["dispatches"],
            "broadcast_versions": tally["versions"], "staleness_hist": tel["staleness_hist"],
            "dropped_updates": tel["dropped_updates"],
            "dropped_update_bytes": tel["dropped_update_bytes"],
            "aggregate_s_first_mix": agg_s[0], "aggregate_s_later_mixes": agg_s[1:]}


def hierarchy_phase(dev, setup, **cfg_kw) -> dict:
    """One sync T-FedAvg round on ResNet18* at full width with three
    requantizing edges (``mod`` assignment): the tier's telemetry, its
    ledger, and launches (one quantize_pack per broadcast, upload and
    active edge; one aggregate per active edge and at the root). Then the
    same round's uploads through a lossless tier on the card against a flat
    card Aggregator (its root folds raw records: no kernel)."""
    import numpy as np
    import torch

    from repro_torch.fed import simulation as sim
    from repro_torch.fed.aggregator import Aggregator
    from repro_torch.fed.hierarchy import EdgeTier, HierarchyConfig
    from repro_torch.models.paper_models import resnet_cifar
    from repro_torch.optim import adam

    clients, params, eval_fn = setup
    cfg = sim.FedConfig(rounds=1, n_clients=len(clients),
                        hierarchy=HierarchyConfig(n_edges=HIER_EDGES), **cfg_kw)
    print(f"ResNet18* full width, {cfg.n_clients} clients, lambda {cfg.participation}, "
          f"E {cfg.local_epochs}, B {cfg.batch_size}; {cfg.hierarchy.n_edges} edges "
          f"({cfg.hierarchy.assignment}, requantize at the edge)")
    seen = []

    class Recorder(EdgeTier):
        def add(self, client_id, blob, weight, staleness=0.0):
            seen.append((client_id, blob, weight))
            super().add(client_id, blob, weight, staleness)

    plain = sim.EdgeTier
    sim.EdgeTier = Recorder
    timer = sim.PhaseTimer(dev)
    try:
        zero_counters()
        t0 = time.perf_counter()
        res = sim.run_federated(resnet_cifar, params, clients, cfg, adam(1e-3), eval_fn,
                                eval_every=1, device=dev, timer=timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counters()
    finally:
        sim.EdgeTier = plain
    tier = res.telemetry["hierarchy"]
    active = sum(1 for c in tier["clients_per_edge"] if c)
    w = {k: timer.rounds[0].get(k, 0.0) for k in ("train", "encode", "wire", "requantize",
                                                   "aggregate")}
    print(f"  round 0: up {res.upload_bytes} B, down {res.download_bytes} B, "
          f"{res.participants_per_round[0]} clients, simulated {res.round_times[0]:.3f} s, "
          f"wall {wall:.2f} s: " + ", ".join(f"{k} {v:.3f} s" for k, v in w.items())
          + f" (the edge folds, requantizes and root fold are in aggregate); "
          f"acc {res.accuracy[0]:.4f}, loss {res.loss[0]:.4f}")
    print(f"  tier telemetry: {json.dumps(tier)}")
    print(f"  launches: {json.dumps(launches)} ({len(seen)} uploads, {active} active edges)")
    check(tier["ledger_balanced"], "the tier's ledger does not balance")
    check(res.upload_bytes == tier["client_to_edge_bytes"] + tier["edge_to_root_bytes"],
          "upload bytes are not client→edge + edge→root")
    check(launches["quantize_pack"] == 1 + len(seen) + active,
          f"quantize_pack launched {launches['quantize_pack']} times: want 1 broadcast + "
          f"{len(seen)} uploads + {active} edges")
    check(launches["aggregate"] == active + 1,
          f"aggregate launched {launches['aggregate']} times: want {active} edges + the root")
    check(np.isfinite(res.loss[0]) and 0.0 <= res.accuracy[0] <= 1.0, "tier round not finite")

    lossless = EdgeTier(HierarchyConfig(n_edges=HIER_EDGES, requantize_at_edge=False),
                        cfg.fttq, cfg.n_clients, device=dev)
    flat = Aggregator(chunk_c=cfg.agg_chunk_c, device=dev)
    for k, blob, weight in seen:
        lossless.add(k, blob, weight)
        flat.add(blob, weight)
    zero_counters()
    mean, info = lossless.fold()
    torch.cuda.synchronize()
    lossless_launches = read_counters()
    worst = _fold_gap(mean, flat.finalize())
    print(f"  lossless tier on the same {len(seen)} uploads: max |d| vs a flat card "
          f"Aggregator {worst:.3e} (limit 1e-6 + 1e-5|ref|); {info['edge_to_root_bytes']} B "
          f"edge→root; launches {json.dumps(lossless_launches)}")
    check(lossless_launches["aggregate"] == info["edges_active"]
          and lossless_launches["quantize_pack"] == 0,
          "the lossless tier launched other than one aggregate per edge")
    return {"launches": launches, "wall_s": wall, "phase_wall_s": w, "telemetry": tier,
            "uploads": len(seen),
            "edges_active": active, "upload_bytes": res.upload_bytes,
            "download_bytes": res.download_bytes, "lossless_vs_flat_max_abs": worst}


def controller_phase(dev, *, n_clients: int = CTRL_CLIENTS, rounds: int = CTRL_ROUNDS,
                     samples: int = FED_SAMPLES, n_test: int = FED_TEST, **cfg_kw) -> dict:
    """Sync T-FedAvg rounds on ResNet18* at full width with the adaptive
    compression controller: 20 clients of 500 samples, λ 0.5, E 5, B 64,
    ``ControllerConfig(warmup_encodes=1, divergence_high=1e9)`` — each
    client's first upload ships ternary, every later one topk16 at 5% with
    error feedback, so a client drawn in both rounds makes round 1 mix
    codecs. Checks the rungs, the bytes by rung against the run's upload
    bytes, every topk16 blob under every ternary one, the launches per
    round (quantize_pack = ternary uploads + 1 broadcast, aggregate = 1),
    each round's card fold against the CPU Aggregator fold of the same
    blobs bit for bit, and each rung's card encode of one trained tree
    against the CPU's (wire sha256 and residual bits)."""
    import hashlib

    import numpy as np
    import torch

    from repro_torch.comm.wire import encode_update
    from repro_torch.core.compression import CodecSpec, compress_pytree
    from repro_torch.core.fttq import init_wq_tree
    from repro_torch.core.tfedavg import client_update_payload
    from repro_torch.fed import controller as controller_mod
    from repro_torch.fed import simulation as sim
    from repro_torch.fed.aggregator import Aggregator
    from repro_torch.fed.controller import ControllerConfig
    from repro_torch.kernels.aggregate import packed_weighted_sum
    from repro_torch.kernels.quantize_pack import quantize_pack
    from repro_torch.models.paper_models import resnet_cifar
    from repro_torch.optim import adam
    from repro_torch.tree import flatten_with_path, tree_map

    clients, params, eval_fn = federated_setup(dev, samples, n_test, n_clients)
    ctrl_cfg = ControllerConfig(warmup_encodes=1, divergence_high=1e9)
    cfg = sim.FedConfig(rounds=rounds, n_clients=n_clients, participation=CTRL_LAMBDA,
                        controller=ctrl_cfg, **cfg_kw)
    print(f"ResNet18* full width, {n_clients} clients x {len(clients[0])} samples, lambda "
          f"{cfg.participation}, E {cfg.local_epochs}, B {cfg.batch_size}, adam(1e-3), "
          f"{rounds} rounds; controller warmup {ctrl_cfg.warmup_encodes}, aggressive rung "
          f"{ctrl_cfg.aggressive_rung} at {ctrl_cfg.topk_fraction}, error feedback "
          f"{ctrl_cfg.error_feedback}")

    uploads = []              # (round, client, rung, blob)
    last = {}                 # the last upload's trained tree and controller
    plain_payload = controller_mod.CompressionController.client_payload

    def recording_payload(self, client_id, params_k, wq_tree, start_params, **kw):
        before = dict(self._bytes_by_kind)
        blob = plain_payload(self, client_id, params_k, wq_tree, start_params, **kw)
        rung = next(r for r, n in self._bytes_by_kind.items() if n != before.get(r, 0))
        uploads.append((self._round, int(client_id), rung, blob))
        last.update(params=params_k, ctrl=self, client=int(client_id))
        return blob

    class Timer(sim.PhaseTimer):
        def start_round(self, r):
            super().start_round(r)
            self.marks.append((quantize_pack.launches, packed_weighted_sum.launches))

    class Recorder(Aggregator):
        """The run's one aggregator, keeping each round's adds and fold."""

        def add(self, blob, weight):
            if self.n_clients == 0:
                self.seen = []
            self.seen.append((blob, weight))
            super().add(blob, weight)

        def finalize(self, *, reset=False):
            folds.append((list(self.seen), super().finalize(reset=False)))
            if reset:
                self.reset()
            return folds[-1][1]

    folds, recorders = [], []

    def make_recorder(*a, **kw):
        recorders.append(Recorder(*a, **kw))
        return recorders[-1]

    timer = Timer(dev)
    timer.marks = []
    plain_aggregator = sim.Aggregator
    sim.Aggregator = make_recorder
    controller_mod.CompressionController.client_payload = recording_payload
    try:
        zero_counters()
        t0 = time.perf_counter()
        res = sim.run_federated(resnet_cifar, params, clients, cfg, adam(1e-3), eval_fn,
                                eval_every=1, device=dev, timer=timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counters()
    finally:
        sim.Aggregator = plain_aggregator
        controller_mod.CompressionController.client_payload = plain_payload
    tel = res.telemetry["controller"]
    marks = timer.marks + [(launches["quantize_pack"], launches["aggregate"])]
    check(len(recorders) == 1 and len(folds) == rounds, "the run did not fold once a round "
                                                        "on one aggregator")
    per_round = []
    for r in range(rounds):
        mine = [u for u in uploads if u[0] == r]
        rungs = {}
        for _, _, rung, blob in mine:
            n, b = rungs.get(rung, (0, 0))
            rungs[rung] = (n + 1, b + len(blob))
        lq, la = (marks[r + 1][i] - marks[r][i] for i in range(2))
        w = {k: timer.rounds[r].get(k, 0.0) for k in ("train", "encode", "wire", "aggregate",
                                                       "requantize")}
        row = {"round": r, "rungs": {k: v[0] for k, v in rungs.items()},
               "bytes_by_rung": {k: v[1] for k, v in rungs.items()},
               "upload_bytes": res.telemetry["upload_bytes_per_round"][r],
               "download_bytes": res.telemetry["download_bytes_per_round"][r],
               "sim_s": res.round_times[r], "accuracy": res.accuracy[r], "loss": res.loss[r],
               "residual_l2": tel["residual_l2_per_round"][r], "wall_s": w,
               "launches": {"quantize_pack": lq, "aggregate": la}}
        per_round.append(row)
        print(f"  round {r}: rungs {row['rungs']}, bytes by rung {row['bytes_by_rung']}, up "
              f"{row['upload_bytes']} B, down {row['download_bytes']} B, simulated "
              f"{row['sim_s']:.3f} s; wall: " + ", ".join(f"{k} {v:.3f} s" for k, v in w.items())
              + f"; residual L2 {row['residual_l2']:.2f}; acc {row['accuracy']:.4f}, loss "
              f"{row['loss']:.4f}; launches quantize_pack {lq}, aggregate {la}")
        check(row["rungs"] == tel["rung_counts_per_round"][r],
              f"round {r}: the recorded rungs differ from the telemetry")
        check(sum(row["rungs"].values()) == round(cfg.participation * n_clients),
              f"round {r}: {sum(row['rungs'].values())} uploads")
        check(lq == row["rungs"].get("ternary", 0) + 1,
              f"round {r}: quantize_pack launched {lq} times for "
              f"{row['rungs'].get('ternary', 0)} ternary uploads and 1 broadcast")
        check(la == 1, f"round {r}: aggregate launched {la} times (want one per round)")
        check(np.isfinite(row["loss"]) and 0.0 <= row["accuracy"] <= 1.0,
              f"round {r}: accuracy/loss not finite")
    check(set(per_round[0]["rungs"]) == {"ternary"}, "round 0 shipped a rung other than ternary")
    check(set(per_round[-1]["rungs"]) == {"ternary", "topk16"}, "round 1 did not mix codecs")
    check(sum(tel["bytes_by_kind"].values()) == res.upload_bytes,
          f"bytes by rung {tel['bytes_by_kind']} do not sum to the upload bytes "
          f"{res.upload_bytes}")
    sizes = {rung: sorted(len(b) for _, _, r, b in uploads if r == rung)
             for rung in ("ternary", "topk16")}
    print(f"blob sizes: ternary {sizes['ternary'][0]}–{sizes['ternary'][-1]} B, topk16 "
          f"{sizes['topk16'][0]}–{sizes['topk16'][-1]} B; bytes by rung "
          f"{tel['bytes_by_kind']}; {rounds} rounds in {wall:.2f} s of wall time")
    check(sizes["topk16"][-1] < sizes["ternary"][0], "a topk16 blob is not under every ternary "
                                                     "blob")
    check(launches["vote"] == 0, "the controller rounds launched vote")

    # each round's card fold against the CPU Aggregator, kept across rounds
    # as the server keeps its own (the table planned from round 0's first)
    cpu_agg = Aggregator(chunk_c=cfg.agg_chunk_c, device="cpu")
    fold_diff = []
    for r, (blobs, fold) in enumerate(folds):
        for b, w in blobs:
            cpu_agg.add(b, w)
        cpu_fold = dict(flatten_with_path(cpu_agg.finalize(reset=True)))
        fold_diff.append(sum(int((leaf.cpu() != cpu_fold[p]).sum())
                             for p, leaf in flatten_with_path(fold)))
    print(f"card folds vs the CPU Aggregator's on the same blobs: {fold_diff} elements differ")
    check(fold_diff == [0] * rounds, "a card fold differs from the CPU fold")

    # each rung's encode of one trained tree, card vs CPU, from the
    # residual the controller keeps for that client
    trained, ctrl = last["params"], last["ctrl"]
    residual = ctrl._residual[last["client"]]
    encode_ms, sha = {}, {}
    for rung in ("fp16", "bf16", "topk", "topk16"):
        spec = CodecSpec(kind=rung, topk_fraction=ctrl_cfg.topk_fraction, error_feedback=True)
        out = {}
        for where, tree, r0 in (("card", trained, residual),
                                ("cpu", tree_map(lambda t: t.cpu(), trained),
                                 tree_map(lambda t: t.cpu(), residual))):
            wire, new_res = compress_pytree(tree, spec, residual=r0)
            out[where] = (encode_update(wire), new_res)
        same_res = all(torch.equal(a.cpu(), b) for (_, a), (_, b) in zip(
            flatten_with_path(out["card"][1]), flatten_with_path(out["cpu"][1])))
        sha[rung] = [hashlib.sha256(out[w][0]).hexdigest()[:16] for w in ("card", "cpu")]
        print(f"  {rung} encode of one trained tree: {len(out['card'][0])} B, sha256 card "
              f"{sha[rung][0]} cpu {sha[rung][1]}, residual bit-identical: {same_res}")
        check(out["card"][0] == out["cpu"][0], f"{rung}: the card's wire bytes differ")
        check(same_res, f"{rung}: the card's residual differs from the CPU's")

    wq = init_wq_tree(trained, cfg.fttq)

    def upload(rung):
        if rung == "ternary":
            return encode_update(client_update_payload(trained, wq, cfg.fttq))
        wire, _ = compress_pytree(trained, CodecSpec(kind=rung, topk_fraction=0.05,
                                                     error_feedback=True), residual=residual)
        return encode_update(wire)

    for rung in ("ternary", "fp16", "bf16", "topk", "topk16"):
        upload(rung)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            upload(rung)
        torch.cuda.synchronize()
        encode_ms[rung] = (time.perf_counter() - t0) / 5 * 1e3
    print("one eager upload encode (codec + wire), ms: "
          + ", ".join(f"{k} {v:.2f}" for k, v in encode_ms.items()))
    return {"per_round": per_round, "launches": launches, "wall_s": wall,
            "bytes_by_kind": tel["bytes_by_kind"], "blob_sizes": {
                k: [v[0], v[-1]] for k, v in sizes.items()},
            "fold_vs_cpu_elements": fold_diff, "encode_ms": encode_ms}


def _blob_gap(got: bytes, want: bytes) -> tuple[int, float, int]:
    """(ternary codes that differ, largest relative scale gap, raw or other
    record bytes that differ) between two wire blobs of one structure."""
    import torch

    from repro_torch.comm.wire import decode_update_leaves
    from repro_torch.core.ternary import TernaryTensor

    got_pairs, want_pairs = decode_update_leaves(got), decode_update_leaves(want)
    check([p for p, _ in got_pairs] == [p for p, _ in want_pairs],
          "two edge records hold different leaves")
    codes = other = 0
    scale = 0.0
    for (path, a), (_, b) in zip(got_pairs, want_pairs):
        if isinstance(b, TernaryTensor):
            check(isinstance(a, TernaryTensor), f"{path}: a ternary record on one side only")
            codes += int((a.packed != b.packed).sum())
            scale = max(scale, float(((a.w_q.double() - b.w_q.double()).abs()
                                      / b.w_q.double().abs()).max()))
        else:
            other += int((a.reshape(-1).view(torch.uint8)
                          != b.reshape(-1).view(torch.uint8)).sum())
    return codes, scale, other


def fleet_run(dev, params, label: str, cfg) -> dict:
    """One ``run_fleet`` on the card with its aggregators recorded: per
    round or fold the participants, drops and simulated times, bytes, the
    tier ledger or the defense telemetry, wall seconds of the pool encode
    and of the run, peak device memory and launches; then the byte ledger,
    the launch counts the code fixes, and the final update against the
    port's CPU path fed the same cohorts (the same blobs, float64 cohort
    weights and add order)."""
    import torch

    from repro_torch.fed import fleet as fleet_mod
    from repro_torch.fed.aggregator import Aggregator
    from repro_torch.fed.hierarchy import EdgeTier
    from repro_torch.fed.simulation import resolve_rule
    from repro_torch.tree import flatten_with_path

    class FleetAggregator(Aggregator):
        """The run's one aggregator, keeping the adds of its last fold."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.adds, self.last, self.fold_sizes = [], [], []

        def add(self, blob, weight):
            if self.n_clients == 0:
                self.adds = []
            self.adds.append((blob, weight))
            super().add(blob, weight)

        def finalize(self, *, reset=False):
            self.last = list(self.adds)
            self.fold_sizes.append(len(self.last))
            return super().finalize(reset=reset)

    class FleetTier(EdgeTier):
        """The run's tier, keeping each fold's cohorts and edge records."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.cohorts, self.folded = [], []

        def add_cohort(self, edge, blob, weight, n_clients, staleness_sum=0.0):
            self.cohorts.append((edge, blob, weight, n_clients, staleness_sum))
            super().add_cohort(edge, blob, weight, n_clients, staleness_sum)

        def collect(self):
            records = super().collect()
            self.folded.append((self.cohorts, records))
            self.cohorts = []
            return records

    made, pool_s = [], []
    plain_pool = fleet_mod._payload_pool

    def timed_pool(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain_pool(*a, **kw)
        torch.cuda.synchronize()
        pool_s.append(time.perf_counter() - t0)
        return out

    def making(cls):
        def make(*a, **kw):
            made.append(cls(*a, **kw))
            return made[-1]
        return make

    plain = (fleet_mod.Aggregator, fleet_mod.EdgeTier)
    fleet_mod.Aggregator, fleet_mod.EdgeTier = making(FleetAggregator), making(FleetTier)
    fleet_mod._payload_pool = timed_pool
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        zero_counters()
        t0 = time.perf_counter()
        res = fleet_mod.run_fleet(params, cfg, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counters()
        peak = torch.cuda.max_memory_allocated() - base
    finally:
        fleet_mod.Aggregator, fleet_mod.EdgeTier = plain
        fleet_mod._payload_pool = plain_pool
    check(len(made) == 1, f"{label}: the run made {len(made)} aggregators or tiers, want one")
    sink = made[0]
    tel = res.telemetry
    summary = tel["transfer_summary"]
    out = {"participants": res.participants_per_round, "dropped": res.dropped_per_round,
           "round_times_s": res.round_times, "upload_bytes": res.upload_bytes,
           "download_bytes": res.download_bytes, "pool_encode_s": sum(pool_s), "wall_s": wall,
           "peak_bytes_over_start": peak, "allocated_at_start": base, "launches": launches}
    print(f"  {label}: {res.rounds_run} {'folds' if cfg.mode == 'async' else 'rounds'}, "
          f"participants {res.participants_per_round}, dropped {res.dropped_per_round}, "
          f"simulated {[round(t, 4) for t in res.round_times]} s; up {res.upload_bytes} B, "
          f"down {res.download_bytes} B; wall: pool encode {sum(pool_s):.3f} s, run {wall:.3f} s "
          f"({wall - sum(pool_s):.3f} s after the pool); peak {peak / 2**20:.1f} MiB over the "
          f"{base / 2**20:.1f} MiB allocated before; "
          f"launches {json.dumps(launches)}")

    # the byte ledger: what the channel metered against what the run booked
    # every honest pool slot encodes the same tree structure: one blob size
    honest = (len(sink.last[0][0]) if isinstance(sink, Aggregator)
              else len(sink.folded[-1][0][0][1]))
    if cfg.mode == "async":
        arrivals = sum(tel["staleness_hist"])
        dispatched = summary["n_transfers"] // 2
        bcast = res.download_bytes // dispatched
        check(arrivals == sum(res.participants_per_round) + tel["dropped_updates"],
              f"{label}: {arrivals} arrivals against the folds' participants and drops")
        check(res.upload_bytes == arrivals * honest
              and res.download_bytes == dispatched * bcast
              and summary["total_bytes"] == res.download_bytes + dispatched * honest,
              f"{label}: the byte ledger does not balance")
        out.update(arrivals=arrivals, dispatched=dispatched,
                   staleness_hist=tel["staleness_hist"])
    else:
        client_up = (tel["hierarchy"]["client_to_edge_bytes"] if "hierarchy" in tel
                     else res.upload_bytes)
        check(summary["total_bytes"] == client_up + res.download_bytes,
              f"{label}: the channel carried {summary['total_bytes']} B, the run booked "
              f"{client_up} + {res.download_bytes} B")
        if "defense" not in tel:
            check(client_up == sum(res.participants_per_round) * honest,
                  f"{label}: upload bytes are not participants x blob size")
    if "hierarchy" in tel:
        hier = tel["hierarchy"]
        per_fold = [len(records) for _, records in sink.folded]
        check(hier["ledger_balanced"]
              and res.upload_bytes == hier["client_to_edge_bytes"] + hier["edge_to_root_bytes"],
              f"{label}: the tier's ledger does not balance")
        # root ingress: one record per active edge, so at most n_edges a round
        check(all(0 < n <= cfg.hierarchy.n_edges for n in per_fold)
              and hier["root_ingest_bytes"] == sum(len(b) for _, records in sink.folded
                                                   for _, b, _ in records),
              f"{label}: root ingress is not one record per active edge")
        print(f"    tier: {json.dumps({k: v for k, v in hier.items() if 'per_edge' not in k})}; "
              f"active edges per round {per_fold}")
        out.update(tier={k: v for k, v in hier.items() if "per_edge" not in k},
                   edges_per_round=per_fold)
    if "defense" in tel:
        d = tel["defense"]
        print(f"    defense: {json.dumps(d)}")
        check(d["ledger_balanced"], f"{label}: the defense ledger does not balance")
        out["defense"] = d

    # the launches the code fixes
    want = {name: 0 for name in launches}
    rule, _ = resolve_rule(cfg)
    if "hierarchy" in tel:
        want["quantize_pack"] = 1 + FLEET_POOL + sum(out["edges_per_round"])
        want["aggregate"] = sum(e + -(-e // cfg.hierarchy.root_chunk_c)
                                for e in out["edges_per_round"])
    else:
        want["quantize_pack"] = 1 + FLEET_POOL
        flushes = sum(-(-n // cfg.agg_chunk_c) for n in sink.fold_sizes)
        want["vote" if rule == "majority" else "aggregate"] = flushes
    check(launches == want, f"{label}: launches {launches}, want {want}")

    # the final update against the port's CPU path fed the same cohorts
    final = dict(flatten_with_path(res.final_update))
    shapes = {p: tuple(t.shape) for p, t in flatten_with_path(params)}
    check({p: tuple(t.shape) for p, t in final.items()} == shapes
          and all(bool(torch.isfinite(t).all()) for t in final.values()),
          f"{label}: the final update is not finite or not the model's shape")
    if isinstance(sink, Aggregator):
        cpu = Aggregator(chunk_c=cfg.agg_chunk_c, device="cpu", rule=rule)
        for blob, weight in sink.last:
            cpu.add(blob, weight)
        differ = _bits_differ(final, dict(flatten_with_path(cpu.finalize())))
        print(f"    final update vs the CPU Aggregator over the last fold's {len(sink.last)} "
              f"cohorts: {differ} elements differ (want 0)")
        check(differ == 0, f"{label}: the card's fold differs from the CPU's")
        out.update(cohorts_last_fold=len(sink.last), fold_vs_cpu_elements=differ)
    else:
        cohorts, records = sink.folded[-1]
        cpu_tier = EdgeTier(cfg.hierarchy, cfg.fttq, cfg.n_clients, device="cpu", rule=rule)
        for edge, blob, weight, n, stale in cohorts:
            cpu_tier.add_cohort(edge, blob, weight, n, stale)
        cpu_records = cpu_tier.collect()
        check([(e, w) for e, _, w in records] == [(e, w) for e, _, w in cpu_records],
              f"{label}: the card's edges or weights differ from the CPU's")
        gaps = [_blob_gap(a, b) for (_, a, _), (_, b, _) in zip(records, cpu_records)]
        codes, scale, other = (sum(g[0] for g in gaps), max(g[1] for g in gaps),
                               sum(g[2] for g in gaps))
        root = Aggregator(chunk_c=cfg.hierarchy.root_chunk_c, device="cpu", rule=rule)
        for _, blob, weight in records:
            root.add(blob, weight)
        differ = _bits_differ(final, dict(flatten_with_path(root.finalize())))
        print(f"    last round's {len(records)} edge records vs the CPU tier's on the same "
              f"{len(cohorts)} cohorts: {codes} code bytes and {other} raw bytes differ (want "
              f"0), scales within {scale:.2e} (limit 1e-6); final update vs the CPU root fold "
              f"of the card's records: {differ} elements differ (want 0)")
        check(codes == 0 and other == 0 and scale <= 1e-6,
              f"{label}: the card's edge records differ from the CPU's")
        check(differ == 0, f"{label}: the card's root fold differs from the CPU's")
        out.update(cohorts_last_fold=len(cohorts), edge_code_bytes_differ=codes,
                   edge_scale_rel_gap=scale, fold_vs_cpu_elements=differ)
    return out


def fleet_phase(dev, params, *, n_clients: int = FLEET_CLIENTS,
                n_edges: int = FLEET_EDGES, n_attackers: int = FLEET_ATTACKERS) -> dict:
    """``run_fleet`` on ResNet18* at full width (594,378 parameters, weights
    from seed 1) at ``bench_hierarchy.py``'s top cell: 10⁶ clients, λ 0.1,
    ``DiurnalChurn``, ``FleetConfig()`` defaults (a pool of 8 payloads, 50
    examples per client). Four runs: (a) sync, flat, 2 rounds; (b) sync
    through 64 requantizing edges (``mod``), 2 rounds; (c) async, flat,
    ``FedConfig``'s async defaults (buffer_k 4, ⌈λN⌉ in flight), 3 folds;
    (d) sync, flat, 1 round, 300,000 sign-flip attackers against rule
    majority, on the vote kernel over 8 honest and 8 poisoned cohorts."""
    from repro_torch.fed.attackers import AttackConfig
    from repro_torch.fed.availability import AvailabilityConfig
    from repro_torch.fed.defense import DefenseConfig
    from repro_torch.fed.hierarchy import HierarchyConfig
    from repro_torch.fed.simulation import FedConfig

    base = dict(n_clients=n_clients, participation=FLEET_LAMBDA,
                availability=AvailabilityConfig(kind="diurnal"))
    runs = {
        "sync_flat": FedConfig(rounds=2, **base),
        "sync_tier": FedConfig(rounds=2, hierarchy=HierarchyConfig(n_edges=n_edges), **base),
        "async_flat": FedConfig(mode="async", rounds=3, **base),
        "sync_majority": FedConfig(
            rounds=1, attack=AttackConfig(kind="sign_flip", n_attackers=n_attackers),
            defense=DefenseConfig(enabled=True, rule="majority"), **base),
    }
    print(f"ResNet18* full width, {n_clients} clients, lambda {FLEET_LAMBDA}, diurnal churn, "
          f"a pool of {FLEET_POOL} payloads, 50 examples per client; tier {n_edges} edges; "
          f"{n_attackers} sign-flip attackers in the defended run")
    t0 = time.perf_counter()
    out = {"runs": {label: fleet_run(dev, params, label, cfg) for label, cfg in runs.items()}}
    out["phase_wall_s"] = time.perf_counter() - t0
    print(f"fleet phase: {out['phase_wall_s']:.2f} s of wall time")
    return out


def _same_tree(a, b) -> bool:
    """Two dense trees bit for bit (paths, dtypes, values)."""
    import torch

    from repro_torch.tree import flatten_with_path

    fa, fb = flatten_with_path(a), flatten_with_path(b)
    return len(fa) == len(fb) and all(
        pa == pb and x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())
        for (pa, x), (pb, y) in zip(fa, fb))


def socket_run(dev, params, label: str, n_clients: int, **kw) -> tuple:
    """One ``run_socket_round`` with the clients' exit reports: the server's
    launch counts (set to 0 just before, read just after), each child's
    device and launches, wall and start-up seconds, bytes up and down and
    the framing overhead. Returns (result, summary)."""
    import tempfile

    import torch

    from repro_torch.fed.mp_server import run_socket_round

    with tempfile.TemporaryDirectory() as reports:
        zero_counters()
        t0 = time.perf_counter()
        res = run_socket_round(params, n_clients, seed=SOCKET_SEED, device=dev,
                               report_dir=reports, timeout_s=SOCKET_TIMEOUT_S, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counters()
    led = res.ledger()
    reps = res.client_reports
    startup = sorted(r["startup_s"] for r in reps.values() if r["startup_s"] is not None)
    child_qp = {cid: r["launches"]["quantize_pack"] for cid, r in sorted(reps.items())}
    out = {"wall_s": wall, "round_wall_s": res.wall_s, "committed": res.committed,
           "arrivals": res.arrivals,
           "outcomes": {str(k): v for k, v in sorted(res.outcomes.items())},
           "upload_bytes": res.upload_bytes, "download_bytes": res.download_bytes,
           "payload_bytes": res.payload_bytes,
           "framing_overhead_bytes": res.framing_overhead_bytes,
           "balance_ok": led["balance_ok"], "retries": res.retries,
           "resumed_bytes": res.resumed_bytes, "dropped_update_bytes": res.dropped_update_bytes,
           "quarantined_update_bytes": res.quarantined_update_bytes, "chaos": res.chaos,
           "defense": res.defense, "server_launches": launches,
           "child_devices": sorted({r["device"] for r in reps.values()}),
           "child_quantize_pack_launches": child_qp,
           "child_startup_s": startup}
    print(f"  {label}: {n_clients} client processes, committed {res.committed}, arrivals "
          f"{res.arrivals}, outcomes {out['outcomes']}; wall {wall:.3f} s (the round "
          f"{res.wall_s:.3f} s); client start-up to HELLO "
          f"{startup[0] if startup else float('nan'):.3f}-"
          f"{startup[-1] if startup else float('nan'):.3f} s; up {res.upload_bytes} B "
          f"(payload {res.payload_bytes} B, framing {res.framing_overhead_bytes} B), down "
          f"{res.download_bytes} B; retries {res.retries}, resumed {res.resumed_bytes} B, "
          f"dropped {res.dropped_update_bytes} B, quarantined {res.quarantined_update_bytes} B"
          + (f"; proxy {json.dumps(res.chaos)}" if res.chaos else "")
          + f"; server launches {json.dumps(launches)}; client quantize_pack launches "
          f"{json.dumps(child_qp)} on {out['child_devices']}")
    check(led["balance_ok"], f"socket {label}: the update-byte ledger does not balance")
    check(out["child_devices"] == ["cuda"],
          f"socket {label}: client devices {out['child_devices']}, want cuda only")
    check(launches["quantize_pack"] == 0 and launches["ternary_matmul"] == 0,
          f"socket {label}: the server launched {json.dumps(launches)}")
    return res, out


def socket_phase(dev, params, *, n_clients: int = SOCKET_CLIENTS,
                 chaos_clients: int = SOCKET_CHAOS_CLIENTS) -> dict:
    """``run_socket_round`` on ResNet18* at full width (594,378 parameters,
    weights from seed 1), the server and every client process on the card:
    (a) sync, 8 clients; (b) buffered, 8 clients, buffer_k 3, η 0.5; (c)
    sync through the chaos proxy at fault seed 19, 6 clients, quorum 0.5,
    with the preset's chunk scaled to the ResNet18* frame; (d) sync, 8
    clients, 2 nan_poison attackers against rule majority. Each run's hash
    against the port's in-process reference on the card over the same
    survivors in the same order; (a) also against a CPU Aggregator fed the
    blobs the server received, bit for bit."""
    import math

    import torch

    from repro_torch.comm.transport import FT_UPDATE, pack_frame
    from repro_torch.comm.wire import decode_update, encode_update
    from repro_torch.fed.aggregator import Aggregator
    from repro_torch.fed.attackers import AttackConfig, attacker_ids
    from repro_torch.fed.defense import DefenseConfig
    from repro_torch.fed.mp_server import (
        client_update_blob, client_weight, default_chaos, demo_params, params_hash,
        run_inprocess_reference,
    )

    t_phase = time.perf_counter()
    start = decode_update(encode_update(params))
    blob = client_update_blob(start, 0, SOCKET_SEED, device=dev)
    bcast = len(encode_update(params))
    print(f"ResNet18* full width, seed {SOCKET_SEED}: one client upload {len(blob)} B "
          f"(ternary, fp16 residuals), broadcast {bcast} B (fp32)")
    runs = {}

    def reference_hash(order, **kw) -> str:
        return params_hash(run_inprocess_reference(params, n_clients, seed=SOCKET_SEED,
                                                   order=order, device=dev, **kw))

    # (a) sync
    res, runs["sync"] = socket_run(dev, params, "sync", n_clients)
    check(res.committed == "full" and all(v == "ok" for v in res.outcomes.values()),
          f"socket sync: outcomes {res.outcomes}")
    check(runs["sync"]["server_launches"]["aggregate"] == 1
          and runs["sync"]["server_launches"]["vote"] == 0,
          f"socket sync: server launches {runs['sync']['server_launches']}, want aggregate 1")
    check(runs["sync"]["child_quantize_pack_launches"] == {c: 1 for c in range(n_clients)},
          "socket sync: every client must launch quantize_pack exactly once")
    check(res.payload_bytes == n_clients * len(blob),
          f"socket sync: payload {res.payload_bytes} B, want {n_clients} x {len(blob)} B")
    check(res.download_bytes >= n_clients * bcast, "socket sync: download under the broadcasts")
    check(params_hash(res.params) == reference_hash(None),
          "socket sync: the round differs from the in-process card reference")
    cpu = Aggregator(chunk_c=16, device="cpu")
    for _cid, weight, b in sorted(res.received):
        cpu.add(b, weight=weight)
    check(_same_tree(res.params, cpu.finalize()),
          "socket sync: the card's fold differs from a CPU Aggregator on the received blobs")
    print("  sync: hash equals the in-process card reference; fold equals the CPU "
          "Aggregator's on the 8 received blobs bit for bit")

    # (b) buffered
    res, runs["buffered"] = socket_run(dev, params, "buffered", n_clients, mode="buffered",
                                       buffer_k=SOCKET_BUFFER_K, eta=SOCKET_ETA)
    want = math.ceil(n_clients / SOCKET_BUFFER_K)
    check(res.committed == "full", f"socket buffered: outcomes {res.outcomes}")
    check(runs["buffered"]["server_launches"]["aggregate"] == want,
          f"socket buffered: aggregate launched {runs['buffered']['server_launches']}, "
          f"want {want} mixes")
    check(params_hash(res.params) == reference_hash(res.arrivals, mode="buffered",
                                                    buffer_k=SOCKET_BUFFER_K, eta=SOCKET_ETA),
          "socket buffered: the round differs from the reference in arrival order")
    print(f"  buffered: hash equals the in-process card reference in arrival order "
          f"{res.arrivals}")

    # (c) chaos: the preset's rates, seed and crash client, its chunk scaled
    # so a ResNet18* frame spans as many chunks as a demo frame at 512 B
    demo = demo_params(seed=SOCKET_SEED)
    demo_blob = client_update_blob(decode_update(encode_update(demo)), 0, SOCKET_SEED,
                                   device="cpu")
    meta = {"client_id": 0, "weight": client_weight(0)}
    demo_frame = len(pack_frame(FT_UPDATE, demo_blob, meta))
    frame = len(pack_frame(FT_UPDATE, blob, meta))
    chunk = round(512 * frame / demo_frame)
    print(f"  chaos chunk: {chunk} B (a {frame} B ResNet18* UPDATE frame over "
          f"{frame / chunk:.2f} chunks; the preset's 512 B over a {demo_frame} B demo frame)")
    cfg = default_chaos(seed=SOCKET_CHAOS_SEED, n_clients=chaos_clients, chunk_bytes=chunk)
    res, runs["chaos"] = socket_run(dev, params, "chaos", chaos_clients, fault_cfg=cfg,
                                    quorum_frac=0.5)
    runs["chaos"]["chunk_bytes"] = chunk
    check(res.committed == "quorum", f"socket chaos: committed {res.committed}")
    check(res.outcomes[chaos_clients - 1] == "crashed",
          f"socket chaos: the crash client's outcome is {res.outcomes[chaos_clients - 1]}")
    check(res.retries >= 1 and res.chaos["killed"] >= 1,
          f"socket chaos: retries {res.retries}, killed {res.chaos['killed']}")
    chaos_ref = params_hash(run_inprocess_reference(
        params, chaos_clients, seed=SOCKET_SEED, order=sorted(res.arrivals), device=dev))
    check(params_hash(res.params) == chaos_ref,
          "socket chaos: the round differs from the reference over its survivors")
    print(f"  chaos: hash equals the in-process card reference over survivors "
          f"{sorted(res.arrivals)}")

    # (d) defended: nan_poison against rule majority, on the vote kernel
    attack = AttackConfig(kind="nan_poison", n_attackers=SOCKET_ATTACKERS)
    attackers = attacker_ids(attack, n_clients)
    res, runs["majority"] = socket_run(
        dev, params, "majority", n_clients, attack=attack,
        defense=DefenseConfig(enabled=True, rule="majority"),
        quorum_frac=(n_clients - SOCKET_ATTACKERS) / n_clients)
    quarantined = {c for c, v in res.outcomes.items() if v == "quarantined"}
    check(quarantined == set(attackers),
          f"socket majority: quarantined {sorted(quarantined)}, attackers {sorted(attackers)}")
    check(runs["majority"]["server_launches"]["vote"] == 1
          and runs["majority"]["server_launches"]["aggregate"] == 0,
          f"socket majority: server launches {runs['majority']['server_launches']}, want vote 1")
    honest = sorted(set(range(n_clients)) - attackers)
    check(params_hash(res.params) == reference_hash(honest, rule="majority"),
          "socket majority: the round differs from the honest survivors' reference")
    print(f"  majority: attackers {sorted(attackers)} quarantined; hash equals the in-process "
          f"card reference over {honest} under rule majority")
    wall = time.perf_counter() - t_phase
    print(f"socket phase: {wall:.2f} s of wall time")
    return {"runs": runs, "blob_bytes": len(blob), "broadcast_bytes": bcast,
            "phase_wall_s": wall}


def ops_timings(layers, served) -> dict:
    """ternary_quantize over the given fp32 layers (olmo-1b's 112, 2^30
    weights) and pack2bit / unpack2bit (to int8) over the served 2^30 codes,
    with their plain versions and bytes bounds. No single PyTorch call
    computes any of the three."""
    import torch

    from repro_torch.kernels.ops import fttq_scalars
    from repro_torch.kernels.pack2bit import pack2bit, pack2bit_plain, unpack2bit, unpack2bit_plain
    from repro_torch.kernels.ternary_quantize import ternary_quantize, ternary_quantize_plain

    out = {}
    scals = [fttq_scalars(t, 0.7) for t in layers]
    n = sum(t.numel() for t in layers)
    out["tq_ms"] = time_ms(lambda: [ternary_quantize(t, *s) for t, s in zip(layers, scals)], 5)
    out["tq_plain_ms"] = time_ms(
        lambda: [ternary_quantize_plain(t, *s) for t, s in zip(layers, scals)], 2)
    tq_bytes = 9 * n + 12 * len(layers)     # θ and 3 scalars in; codes and θ_t out
    out["tq_bound_ms"], out["tq_bound_by"] = bound(tq_bytes, 2 * n)
    print(f"ternary_quantize, {len(layers)} layers ({n} fp32 weights): kernel "
          f"{out['tq_ms']:.4f} ms, plain {out['tq_plain_ms']:.4f} ms, bound "
          f"{out['tq_bound_ms']:.4f} ms ({out['tq_bound_by']}, {tq_bytes} B); library: none")

    packed = [w.packed.reshape(-1, w.packed.shape[-1]) for group in ("attn", "mlp")
              for w in served["blocks"][group].values()]
    codes = [unpack2bit(p) for p in packed]
    n_codes = sum(c.numel() for c in codes)
    pk_bytes = n_codes + n_codes // 4
    for name, fn, plain, args in (("pack2bit", pack2bit, pack2bit_plain, codes),
                                  ("unpack2bit", unpack2bit, unpack2bit_plain, packed)):
        out[f"{name}_ms"] = time_ms(lambda: [fn(a) for a in args], 10)
        out[f"{name}_plain_ms"] = time_ms(lambda: [plain(a) for a in args], 2)
        out[f"{name}_bound_ms"], out[f"{name}_bound_by"] = bound(pk_bytes, 0)
        print(f"{name}, {len(args)} launches over {n_codes} codes: kernel "
              f"{out[f'{name}_ms']:.4f} ms, plain {out[f'{name}_plain_ms']:.4f} ms, bound "
              f"{out[f'{name}_bound_ms']:.4f} ms ({out[f'{name}_bound_by']}, {pk_bytes} B); "
              "library: none")
    del codes
    torch.cuda.empty_cache()
    return out


def federated_trace(dev, setup) -> None:
    """A window of the federated configuration: one round of one client at
    E = 5, B = 64 (35 QAT steps, with the broadcast, encode, fan-in and
    eval around them), run once untraced and timed, then again under
    torch.profiler. The idle share is the device time against the untraced
    wall of the same window, since the profiler slows the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fed.simulation import FedConfig, run_federated
    from repro_torch.models.paper_models import resnet_cifar
    from repro_torch.optim import adam

    clients, params, eval_fn = setup
    cfg = FedConfig(rounds=1, n_clients=len(clients), participation=1 / len(clients))

    def one_round():
        run_federated(resnet_cifar, params, clients, cfg, adam(1e-3), eval_fn, device=dev)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_round()
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_round()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    report_trace(prof, wall_ms, f"1 round, 1 client x E {cfg.local_epochs}, B "
                 f"{cfg.batch_size}", untraced_ms)


def fanin_trace(dev, uploads) -> dict:
    """The aggregate phase of one mean and one majority round as the
    simulation runs it (every upload's ``add``, then ``finalize(reset=True)``
    and a synchronize) on the last federated round's uploads: once untraced
    on a fresh Aggregator (plans, table and staging built, as in a run's
    first round), once untraced on the kept plans, then under
    torch.profiler, with the Aggregator's host ranges (add, stage, copy,
    launch, finalize)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fed.aggregator import Aggregator

    out = {}
    for rule in ("mean", "majority"):
        agg = Aggregator(chunk_c=FANIN_C, device=dev, rule=rule)

        def phase():
            for blob, weight in uploads:
                agg.add(blob, weight)
            agg.finalize(reset=True)
            torch.cuda.synchronize()

        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            phase()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            phase()
            traced_ms = (time.perf_counter() - t0) * 1e3
        host = aggregator_ranges(prof)
        out[rule] = {"first_ms": walls[0], "steady_ms": walls[1], "traced_ms": traced_ms,
                     "host_ms": host}
        print(f"aggregate phase, rule {rule}, {len(uploads)} uploads: {walls[0]:.3f} ms wall "
              f"with planning, {walls[1]:.3f} ms on kept plans ({traced_ms:.3f} ms traced); "
              "host ms inside the traced ranges: "
              + ", ".join(f"{k} {v:.3f}" for k, v in host.items()))
        report_trace(prof, traced_ms, f"aggregate phase, rule {rule}", walls[1])
    return out


AGGREGATOR_RANGES = ("add", "stage", "copy", "launch", "finalize")


def aggregator_ranges(prof) -> dict:
    """Host ms inside each of the Aggregator's ranges (``aggregator.<name>``,
    inclusive of what runs within), from the CPU side of a trace."""
    host = dict.fromkeys(AGGREGATOR_RANGES, 0.0)
    for e in prof.key_averages():
        name = e.key.removeprefix("aggregator.")
        if e.key.startswith("aggregator.") and name in host:
            host[name] = max(host[name], e.cpu_time_total / 1e3)
    return host


def report_trace(prof, wall_ms: float, what: str, untraced_ms: float | None = None) -> None:
    """Device time of a traced window and the device's idle share of it:
    against the untraced wall of the same window where one was timed,
    else against the traced wall."""
    events = prof.key_averages()

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # a host range (record_function) also shows as a device-side annotation
    # spanning its kernels: count kernels and copies only
    busy_ms = sum(device_us(e) for e in events if not e.key.startswith("aggregator.")) / 1e3
    if untraced_ms is None:
        print(f"{what}: {wall_ms:.2f} ms wall, {busy_ms:.3f} ms of device time "
              f"(device idle {100 * (1 - busy_ms / wall_ms):.1f}% of the window)")
    else:
        print(f"{what}: {untraced_ms:.2f} ms wall untraced ({wall_ms:.2f} ms traced), "
              f"{busy_ms:.3f} ms of device time (device idle "
              f"{100 * (1 - busy_ms / untraced_ms):.1f}% of the untraced window)")
    for e in sorted((e for e in events if not e.key.startswith("aggregator.")), key=device_us,
                    reverse=True)[:10]:
        print(f"  {device_us(e) / 1e3:9.3f} ms device  {e.count:6d} calls  {e.key[:70]}")
    for e in sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]:
        print(f"  {e.self_cpu_time_total / 1e3:9.3f} ms host    {e.count:6d} calls  {e.key[:70]}")


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
    from repro_torch.core.fttq import FTTQConfig, is_quantizable
    from repro_torch.kernels import _build
    from repro_torch.kernels.aggregate import packed_weighted_sum
    from repro_torch.kernels.pack2bit import unpack2bit_plain
    from repro_torch.kernels.quantize_pack import (
        quantize_pack, quantize_pack_segments, quantize_pack_segments_plain,
    )
    from repro_torch.kernels.repack import PackedTernary
    from repro_torch.kernels.ternary_matmul import (
        launch_shape, ternary_matmul, ternary_matmul_plain, ternary_matmul_split,
    )
    from repro_torch.launch.quickstart import main as quickstart_main
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

    phase("checks: quantize_pack_segments on the deploy's segments, olmo-1b in one launch "
          "(bytes, guards and counts exact, sums and scales rtol 1e-6)")
    qp_rows, qp_scal = deploy_segments([leaf for _, leaf in quantizable], fcfg)
    qp_err, qp_bytes_checked, qp_scales_checked = quantize_pack_deploy_checks(qp_rows, qp_scal)

    phase("checks: quantize_pack segments through out= (codes, counts and guards exact, "
          "sums rtol 1e-6)")
    qp_err = max(qp_err, quantize_pack_segment_checks(dev))

    phase("checks: quantize_pack_segments, one ResNet18* encode in one launch (bytes, guards "
          "and counts exact, sums and scales rtol 1e-6)")
    qp_err = max(qp_err, quantize_pack_fed_checks(dev))

    phase("checks: ternary_matmul vs plain (fp32, TF32 off, rtol 1e-4, atol 1e-4; one-hot "
          "weights bit for bit)")
    gen = torch.Generator(dev).manual_seed(5)
    tm_err = 0.0
    for m, k, n in RAGGED_MATMUL_SHAPES:
        x = torch.randn(m, k, generator=gen, device=dev)
        c = torch.randint(0, 3, (k // 4, 4, n), generator=gen, device=dev, dtype=torch.uint8)
        packed = c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)
        wq = torch.tensor(0.37, device=dev)
        y = ternary_matmul(x, packed, wq)
        y_ref = ternary_matmul_plain(x, packed, wq)
        y_split = ternary_matmul_split(x, packed, wq)
        torch.cuda.synchronize()
        err = float((y - y_ref).abs().max())
        tm_err = max(tm_err, err)
        ok = bool(torch.allclose(y, y_ref, rtol=1e-4, atol=1e-4)
                  and torch.allclose(y, y_split, rtol=1e-4, atol=1e-4))
        print(f"  M={m} K={k} N={n} (launch shape {launch_shape(m, k // 4, n)}): max abs err "
              f"{err:.3e} vs plain, {float((y - y_split).abs().max()):.3e} vs the split in "
              "plain PyTorch")
        check(ok, f"ternary_matmul disagrees with its plain version at {(m, k, n)}")
    for m, k, n in RAGGED_MATMUL_SHAPES + MATMUL_SHAPES:
        bad = onehot_matmul_mismatches(m, k, n, gen, dev)
        print(f"  one-hot weights, M={m} K={k} N={n}: {bad} of {m * n} outputs differ from the "
              "plain version or the split (want 0)")
        check(bad == 0, f"ternary_matmul is not exact on one-hot weights at {(m, k, n)}")
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
        dense = unpack2bit_plain(packed, torch.float32) * wq
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
        b_ms, b_by, _, _ = matmul_bound(m, k, n)
        per_shape.append({"m": m, "k": k, "n": n, "ms": t_k, "eager_ms": t_e, "plain_ms": t_p,
                          "library_ms": t_l, "bound_ms": b_ms, "bound_by": b_by,
                          "max_abs_err": err})
        print(f"  M={m} K={k} N={n} (launch shape {launch_shape(m, k // 4, n)}): max abs err "
              f"{err:.3e}; kernel {t_k:.4f} ms (eager {t_e:.4f} ms), plain {t_p:.4f} ms, "
              f"torch.matmul(dense) {t_l:.4f} ms ({t_l / t_k:.2f}x the kernel), "
              f"bound {b_ms:.4f} ms ({b_by})")
        check(ok, f"ternary_matmul disagrees with its plain version at {(m, k, n)}")
        del x, c, packed, dense, y, y_ref

    phase("checks: aggregate vs plain, one launch per segment table (bit-identical)")
    agg_err = fanin_checks(dev, "aggregate")

    phase("checks: vote vs plain, one launch per segment table (bit-identical)")
    vote_err = fanin_checks(dev, "vote")

    names = [("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
             ("mlp", "w_in"), ("mlp", "w_gate"), ("mlp", "w_out")]
    layers = [params["blocks"][a][b][i] for i in range(cfg.n_layers) for a, b in names]
    phase("checks: ternary_quantize vs plain on every 2-D layer of olmo-1b (bit-identical)")
    tq_err = ternary_quantize_checks(layers)

    phase("serve: olmo-1b --ternary --packed at full width")
    zero_counters()
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
    check(packed_weighted_sum.launches == 0, "the serving path launched aggregate")
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
    check(qp_launches == 2, f"quantize_pack launched {qp_launches} times by two deploys: want "
                            "one launch per deploy")
    check(tm_launches == per_forward * forwards,
          f"ternary_matmul launched {tm_launches} times, want {per_forward * forwards}")

    phase("checks: unpack2bit / pack2bit on the served 2-bit weights (bit-identical)")
    pack_err, unpack_err = pack_checks(served)

    phase("timings")
    box = {}

    def deploy_encode():
        box["out"] = quantize_pack_segments(qp_rows, qp_scal, with_scales=True)

    # the deploy's encode as core.encode makes it: eager, the table built and copied inside
    qp_ms = time_ms(deploy_encode, 5, graph=False)
    check(torch.equal(box["out"][0], qp_bytes_checked)
          and torch.equal(box["out"][2], qp_scales_checked),
          "the timed deploy encode differs from the checked one")
    del box
    qp_old_ms = time_ms(lambda: [quantize_pack(r, qp_scal[i]) for i, r in enumerate(qp_rows)],
                        5, graph=False)
    qp_plain_ms = time_ms(lambda: quantize_pack_segments_plain(qp_rows, qp_scal, True), 2,
                          graph=False)
    qp_bytes = sum(4 * n.numel() + (n.numel() + 3) // 4 + 8 * -(-n.numel() // 32768) + 12
                   for n in qp_rows)
    qp_bound, qp_by = bound(qp_bytes, 4 * n_quant)
    print(f"quantize_pack, all {len(qp_rows)} quantized leaves ({n_quant} weights), eager: one "
          f"call {qp_ms:.4f} ms ({len(qp_rows)} one-segment calls: {qp_old_ms:.4f} ms), plain "
          f"{qp_plain_ms:.4f} ms, bound {qp_bound:.4f} ms ({qp_by}, {qp_bytes} B)")
    qp_fed = quantize_pack_fed_timings(dev, FED_UPLOADS)

    ops_t = ops_timings(layers, served)

    blocks = served["blocks"]
    dense_blocks = ref_params["blocks"]

    def forward_matmuls(rows: int):
        """One forward's 112 matmuls of the served weights at ``rows`` rows
        of x, with the dequantized weights beside them."""
        calls = []
        for i in range(cfg.n_layers):
            for a, b in names:
                w: PackedTernary = blocks[a][b].layer(i)
                x = torch.randn(rows, w.k, generator=gen, device=dev)
                calls.append((x, w.packed, w.w_q.reshape(()), dense_blocks[a][b][i]))
        check(len(calls) == per_forward, "a forward does not hold 112 matmuls")
        return calls

    def time_forward(calls, what: str) -> dict:
        t = {"ms": time_ms(lambda: [ternary_matmul(x, p, s) for x, p, s, _ in calls], 10),
             "eager_ms": time_ms(lambda: [ternary_matmul(x, p, s) for x, p, s, _ in calls], 10,
                                 graph=False),
             "plain_ms": time_ms(lambda: [ternary_matmul_plain(x, p, s) for x, p, s, _ in calls],
                                 3),
             "library_ms": time_ms(lambda: [torch.matmul(x, d) for x, _, _, d in calls], 10)}
        shapes = [matmul_bound(x.shape[0], x.shape[1], p.shape[1]) for x, p, _, _ in calls]
        t["bytes"] = sum(b[2] for b in shapes)
        t["flops"] = sum(b[3] for b in shapes)
        t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["flops"], PEAK_BF16_S)
        print(f"ternary_matmul, {what}: {len(calls)} matmuls at M={calls[0][0].shape[0]}: "
              f"kernel {t['ms']:.4f} ms (eager, with launch cost: {t['eager_ms']:.4f} ms), "
              f"plain {t['plain_ms']:.4f} ms, torch.matmul on the dequantized weights "
              f"{t['library_ms']:.4f} ms ({t['library_ms'] / t['ms']:.2f}x the kernel), bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}; {t['bytes']} B, {t['flops']} bf16 "
              "operations)")
        return t

    decode_t = time_forward(forward_matmuls(BATCH), "one decode step")
    prefill_t = time_forward(forward_matmuls(BATCH * PROMPT), "one prefill forward")

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
    report_trace(prof, wall_ms, "3 decode steps")

    phase("federated: ResNet18* T-FedAvg sync rounds at full width")
    setup = federated_setup(dev)
    fed = federated_phase(dev, setup)

    phase("robust: one defended ResNet18* round (majority, 30 sign-flip attackers)")
    robust = robust_phase(dev, setup, fed["last_uploads"])

    phase("async: the buffered-async ResNet18* T-FedAvg server at full width")
    asy = async_phase(dev, setup)

    phase("hierarchy: one ResNet18* T-FedAvg sync round through 3 requantizing edges")
    hier = hierarchy_phase(dev, setup)

    phase("controller: ResNet18* sync rounds with the adaptive compression controller")
    ctrl = controller_phase(dev)

    phase("fleet: run_fleet on ResNet18* at full width, 10^6 clients (sync, 2-tier, async, "
          "defended)")
    flt = fleet_phase(dev, setup[1])

    def fleet_launches(name: str) -> dict:
        return {label: run["launches"][name] for label, run in flt["runs"].items()}

    phase("socket: run_socket_round on ResNet18* at full width, server and client processes "
          "on the card (sync, buffered, chaos, majority)")
    sock = socket_phase(dev, setup[1])

    def socket_launches(name: str) -> dict:
        return {label: run["server_launches"][name] for label, run in sock["runs"].items()}

    phase("quickstart: repro_torch.launch.quickstart on the card")
    zero_counters()
    qs = quickstart_main(["--device", "cuda"])
    torch.cuda.synchronize()
    qs_launches = read_counters()
    print(f"quickstart launches: {json.dumps(qs_launches)}")
    check(qs["unpack_roundtrip"] and qs["global_finite"] and qs["matmul_rel_err"] < 1e-5,
          "the quickstart's round trip, matmul or round is wrong")
    check(qs["codes_differ_core"] <= 512 * 256 // 10_000,
          "the quickstart's fttq_apply codes disagree with core.fttq")
    for name in ("ternary_quantize", "pack2bit", "unpack2bit", "ternary_matmul"):
        check(qs_launches[name] >= 1, f"the quickstart did not launch {name}")
    qs_err = quickstart_checks(qs, fcfg.t_k)
    tq_err = max(tq_err, qs_err["ternary_quantize"])
    pack_err = max(pack_err, qs_err["pack2bit"])
    unpack_err = max(unpack_err, qs_err["unpack2bit"])

    phase("fan-in timings")
    agg_t = fanin_timings(dev, "aggregate", fed["last_uploads"])
    vote_t = fanin_timings(dev, "vote", fed["last_uploads"])

    phase("fan-in trace: the aggregate phase of a mean and a majority round under "
          "torch.profiler")
    fanin_trace_t = fanin_trace(dev, fed["last_uploads"])

    phase("fed trace: one round of 1 client at E = 5, B = 64 under torch.profiler")
    federated_trace(dev, setup)

    table = {"kernels": [
        {"name": "quantize_pack", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/quantize_pack.cu",
         "replaces": "src/repro/kernels/quantize_pack.py:83",
         "launches": qp_launches, "max_abs_err": qp_err, "ms": qp_ms,
         "plain_ms": qp_plain_ms, "bound_ms": qp_bound, "bound_by": qp_by,
         "library_ms": None, "old_path_ms": qp_old_ms, "federated": qp_fed,
         "federated_launches": fed["launches"][0],
         "async_launches": asy["launches"]["quantize_pack"],
         "hierarchy_launches": hier["launches"]["quantize_pack"],
         "controller_launches": ctrl["launches"]["quantize_pack"],
         "fleet_launches": fleet_launches("quantize_pack"),
         "socket_client_launches": {label: sum(run["child_quantize_pack_launches"].values())
                                    for label, run in sock["runs"].items()}},
        {"name": "ternary_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ternary_matmul.cu",
         "replaces": "src/repro/kernels/ternary_matmul.py:34",
         "launches": tm_launches, "max_abs_err": tm_err, "ms": decode_t["ms"],
         "plain_ms": decode_t["plain_ms"], "bound_ms": decode_t["bound_ms"],
         "bound_by": decode_t["bound_by"], "library_ms": decode_t["library_ms"],
         "eager_ms": decode_t["eager_ms"], "prefill": prefill_t, "per_shape": per_shape},
        {"name": "aggregate", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/aggregate.cu",
         "replaces": "src/repro/kernels/aggregate.py:51",
         "launches": fed["launches"][1], "max_abs_err": agg_err, "ms": agg_t["round_ms"],
         "plain_ms": agg_t["round_plain_ms"], "bound_ms": agg_t["round_bound_ms"],
         "bound_by": agg_t["round_bound_by"], "library_ms": None,
         "eager_ms": agg_t["eager_ms"], "old_path_ms": agg_t["old_path_ms"],
         "stress_ms": agg_t["stress_ms"], "stress_plain_ms": agg_t["stress_plain_ms"],
         "stress_bound_ms": agg_t["stress_bound_ms"],
         "federated_quantize_pack_launches": fed["launches"][0],
         "per_round": fed["per_round"], "phase_trace": fanin_trace_t["mean"],
         "async_launches": asy["launches"]["aggregate"],
         "hierarchy_launches": hier["launches"]["aggregate"],
         "controller_launches": ctrl["launches"]["aggregate"],
         "fleet_launches": fleet_launches("aggregate"), "fleet": flt,
         "socket_launches": socket_launches("aggregate"), "socket": sock,
         "controller": {k: ctrl[k] for k in ("per_round", "wall_s", "bytes_by_kind",
                                             "blob_sizes", "fold_vs_cpu_elements",
                                             "encode_ms")},
         "async": {k: asy[k] for k in ("per_mix", "wall_s", "fold_vs_list_max_abs",
                                       "dispatches", "broadcast_versions",
                                       "staleness_hist", "dropped_updates",
                                       "dropped_update_bytes", "aggregate_s_first_mix",
                                       "aggregate_s_later_mixes")},
         "hierarchy": {k: hier[k] for k in ("wall_s", "phase_wall_s", "telemetry", "uploads",
                                            "edges_active",
                                            "upload_bytes", "download_bytes",
                                            "lossless_vs_flat_max_abs")}},
        {"name": "vote", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/vote.cu",
         "replaces": "src/repro/kernels/vote.py:40",
         "launches": robust["launches"]["vote"], "max_abs_err": vote_err,
         "fleet_launches": fleet_launches("vote"), "socket_launches": socket_launches("vote"),
         "ms": vote_t["round_ms"], "plain_ms": vote_t["round_plain_ms"],
         "bound_ms": vote_t["round_bound_ms"], "bound_by": vote_t["round_bound_by"],
         "library_ms": None, "eager_ms": vote_t["eager_ms"],
         "old_path_ms": vote_t["old_path_ms"], "stress_ms": vote_t["stress_ms"],
         "stress_plain_ms": vote_t["stress_plain_ms"],
         "stress_bound_ms": vote_t["stress_bound_ms"],
         "phase_trace": fanin_trace_t["majority"],
         "robust_round": {k: robust[k] for k in ("wall_s", "phase_wall_s", "defense",
                                                  "upload_bytes", "download_bytes",
                                                  "aggregate_traced", "aggregate_host_ms")}},
        {"name": "ternary_quantize", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ternary_quantize.cu",
         "replaces": "src/repro/kernels/ternary_quantize.py:25",
         "launches": qs_launches["ternary_quantize"], "max_abs_err": tq_err,
         "ms": ops_t["tq_ms"], "plain_ms": ops_t["tq_plain_ms"],
         "bound_ms": ops_t["tq_bound_ms"], "bound_by": ops_t["tq_bound_by"],
         "library_ms": None},
        {"name": "pack2bit", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/pack2bit.cu",
         "replaces": "src/repro/kernels/pack2bit.py:23",
         "launches": qs_launches["pack2bit"], "max_abs_err": pack_err,
         "ms": ops_t["pack2bit_ms"], "plain_ms": ops_t["pack2bit_plain_ms"],
         "bound_ms": ops_t["pack2bit_bound_ms"], "bound_by": ops_t["pack2bit_bound_by"],
         "library_ms": None},
        {"name": "unpack2bit", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/pack2bit.cu",
         "replaces": "src/repro/kernels/pack2bit.py:31",
         "launches": qs_launches["unpack2bit"], "max_abs_err": unpack_err,
         "ms": ops_t["unpack2bit_ms"], "plain_ms": ops_t["unpack2bit_plain_ms"],
         "bound_ms": ops_t["unpack2bit_bound_ms"], "bound_by": ops_t["unpack2bit_bound_by"],
         "library_ms": None},
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
