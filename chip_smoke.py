#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

``--phase NAME`` (repeatable; bf16_mesh, bf16_train, multidevice, midhead)
runs the device and build phases and the named ones alone, says which it
skipped, and prints an empty kernel table before the last line: a quick
run of one path, not the smoke test.

Phases (any failure exits non-zero; with no arguments no phase is skipped):
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
                 XLA's subnormal rule in the FTTQ statistics and the
                 error-feedback residuals: core.fttq and ops.fttq_apply on
                 subnormal leaves (fp32 and bf16), compress_pytree with
                 error feedback for every codec pair over three encodes
                 and the one-pod compressed sync (quantize_pack and
                 aggregate on the card), the card's bits against the
                 CPU's, and a NaN or ±inf weight through the QAT row
                 codes, forward and backward (NaN where the CPU's is);
  4. serve     — olmo-1b at full width (16 layers, d_model 2048, 2^30 quantized
                 weights, random weights from a seed) deployed through the TFW1
                 wire and served 2-bit: packed-vs-dequantized logits check,
                 prefill of 4 × 32 tokens, 15 greedy decode steps, one
                 quantize_pack launch per deploy; then unpack2bit and pack2bit
                 against their plain versions on the served 2-bit bytes (bit
                 for bit);
  4b. bf16_serve — olmo-1b at full width with bf16 weights and activations
                 (``launch.serve --dtype bfloat16``), seed 0: two deploys (one
                 bf16 quantize_pack launch each), the packed-vs-dequantized
                 logits probe (≤ 3.5e-2 of max |logits|), prefill 4 × 32 and 15
                 greedy steps (112 ternary_matmul launches per forward), beside
                 the fp32 phase's numbers; the bf16 quantize_pack (its own
                 kernel, quantize_pack_bf16.cu) on the deploy's 7 segments
                 (bytes and counts bit for bit, sums and scales within 1e-6,
                 a second call the same), on every bf16 bit pattern in one
                 launch of 4,883 segments (a denom in every bf16 binade,
                 deltas of 0, a subnormal, 0.05, 0.3, 0.7, 1 and their bf16
                 neighbours; the threshold path and the exact division), off
                 its whole-tile path (ragged, unaligned, odd byte offsets);
                 XLA's subnormal rule in the fp32 quantize_pack on a sample
                 of fp32 patterns and in ternary_quantize, and on the
                 window below 2^-126 (exact quotients and products that
                 IEEE rounds up to 2^-126 and XLA flushes: what the card's
                 .ftz division and product give there); the bf16
                 ternary_matmul (its own
                 kernels, ternary_matmul_bf16.cu) at every layer shape at
                 M = 4, 128 and 2,048 (within one bf16 ulp, the same bits
                 from a second call, one-hot bit for bit) against their
                 plain versions; their times beside the bounds, the plain
                 versions and torch.matmul on the dequantized bf16 weights
                 (the bf16 deploy encode traced with torch.profiler: its one
                 device kernel's time, the eager time and the host time of
                 the segment table);
                 one decode step's and one prefill forward's 112 bf16
                 matmuls traced with torch.profiler: one device kernel a
                 call, and the device time a call takes at each layer shape
                 beside its bound;
  5. serve_loop — ``launch.serve_loop.ServeEngine`` on olmo-1b at full width
                 (max_batch 8, fp16 residuals) at two dequant-cache
                 capacities, 16 MiB and 1 GiB, each under ``run_closed_loop``
                 (64 requests of 8 tokens) at 5 and 2,000 offered QPS: p50,
                 p99 and mean latency, mean batch, achieved QPS and the cache
                 counters; one quantize_pack launch per engine, 112
                 ternary_matmul launches per forward, the lazy and packed byte
                 counts, the engine's logits against the one-shot packed
                 deploy (rtol 1e-5, atol 1e-5);
  6. timings   — quantize_pack, eagerly as core.encode calls it (the
                 deploy's one call over olmo-1b's 7 leaves beside 7
                 one-segment calls, and that call traced with torch.profiler
                 for its device time; one ResNet18* encode as 52 one-segment
                 calls and as one call, per encode and per round),
                 ternary_matmul (one decode step's and one prefill forward's
                 112 matmuls beside torch.matmul on the dequantized weights,
                 and the zoo's new shapes: gemma3's wq, granite's MLP,
                 hubert's 1,280-wide layers, the vlm's cross K/V at 6,400
                 rows),
                 ternary_quantize, pack2bit and unpack2bit, their plain
                 versions and the PyTorch library call where one exists, with
                 CUDA events, beside the least time the card could take (bytes
                 over 3.35 TB/s, or operations over 67 TFLOP/s of fp32 or, for
                 the tensor-core ternary_matmul, 3 · 2MKN over 989 TFLOP/s of
                 bf16, whichever is larger);
  7. trace     — three decode steps under torch.profiler;
  8. zoo       — every family through ``launch.serve``'s functions, random
                 weights from seed 0, one deploy through TFW1 each (one
                 quantize_pack launch): gemma3-4b, granite-20b (4 of 52
                 layers), llama-3.2-vision-11b (5 of 40 layers, one cross
                 layer, cross gates 0.5, 4 × 1,600 patch embeds) and
                 hubert-xlarge packed, with the packed-vs-dequantized logits
                 check (≤ 1e-4 of max |logits|); qwen3-moe-30b-a3b and
                 deepseek-moe-16b (2 layers each), mamba2-370m and
                 zamba2-1.2b dequantized; causal archs
                 prefill 4 × 32 and take 15 greedy steps, hubert runs an
                 encoder forward of 2 × 512 frame embeds; per arch the peak
                 device memory, deploy s, prefill ms, decode tok/s and
                 ternary_matmul launches (238 / 24 / 84 / 288 per forward for
                 the packed four). Then gemma3's 4,096-token prefill into
                 4,112 slots (the blocked softmax on every layer, held to the
                 naive one on a global and a sliding layer within 1e-5),
                 decode against prefill for qwen3-moe (capacity 16), mamba2
                 and zamba2 (3e-3), and mamba2's SSD of a 1,024-token prefill
                 at chunk 256 against chunk 64 (1e-4);
  9. train     — (a) ``python -m repro_torch.launch.train --preset 10m --steps
                 60 --batch 8 --seq 128 --ckpt-every 30`` in a child process on
                 the card, then its step-60 checkpoint deleted and the same
                 command with --resume: it must restart at step 30, cursor 30,
                 and print the uninterrupted final loss bit for bit, and the
                 logged loss must fall; (b) olmo-1b at full width (random
                 weights from seed 0) through ``init_train_state`` and
                 ``make_train_step`` with the defaults (QAT, grad clip 1, w_q
                 lr 0.05), 3 steps at 8 × 512 and 1 step at 8 × 4,096 with
                 microbatches 4 and remat "full" (configs/shapes.py's train_4k
                 sequence, its batch of 256 cut to 8): per step the
                 synchronized ms, tokens/s, loss and grad norm, per run the
                 peak memory, the share of the fp32 bound and the launches
                 of the QAT backward's kernel (csrc/qat_backward.cu, not a
                 TPU kernel's port: the straight-through backward's
                 elementwise step under XLA's subnormal rule), which is
                 then held bit for bit to its plain version on olmo-1b's
                 7 quantized leaves (2^30 weights) and timed; ternary_stats;
                 the params saved as a ternary checkpoint (exactly one
                 quantize_pack launch), its bytes on disk against the raw
                 fp32 bytes, restored (each quantized leaf's correlation with
                 the saved one > 0.6), and two leaves' records against the
                 port's CPU encode (codes equal but at ties with Δ, scales
                 within rtol 1e-6); (c) one step of olmo-1b cut to 2 layers
                 at 2 × 128 on the card and on the CPU from the same state
                 (loss rtol 1e-5; Adam's m, w_q and params within 1e-5 of
                 their largest, params where |g| ≥ 1e-6; differing QAT codes
                 counted, each a tie at Δ); (d) each of the ten reduced archs
                 2 steps on the card and the CPU (losses within 1e-4; the MoE
                 archs microbatched, gemma3 with remat "dots");
  9a. bf16_train — the reference's production train cell as launch/dryrun.py
                 builds it for one card: olmo-1b at full width, bf16 params
                 and compute, remat "full", QAT, adam(1e-4), 2 microbatches,
                 8 × 4,096 (train_4k's batch of 256 cut to 8), 2 steps through
                 ``make_train_step``: every leaf's dtype, finite losses, step
                 ms, tokens/s and the share of the bf16 bound (8·N·tokens over
                 989 TFLOP/s), exactly one bf16 ``qat_backward`` launch per
                 quantized leaf per microbatch and no fp32 one, the bf16
                 kernel against its plain version on the last step's own
                 cotangents bit for bit, the peak (held in the dryrun phase
                 to the dry-run's estimate of the same cell, within 20%); a
                 ternary save (one quantize_pack launch, its code bytes
                 equal to the plain version's on the same segments, scales
                 within rtol 1e-6); one step of the cell cut to 2 layers at
                 2 × 128, card against CPU (loss rtol 2^-14, Adam's m 2^-5 and
                 params 2^-7 of their largest, w_q 2^-7); the bf16 entry of
                 the QAT backward's kernel on olmo-1b's 7 leaves in bf16,
                 timed beside its plain version and bound;
  9b. multidevice — two ranks spawned on the one card, joined over gloo
                 through a file rendezvous (NCCL will not put two ranks on one
                 device; every collective stages through pinned host memory),
                 in one spawn: (a) olmo-1b's whole gradient tree (1,176,764,416
                 fp32 elements, seeded per rank) through ternary_allreduce_tree
                 with error feedback: exactly one quantize_pack and two
                 aggregate launches per rank, wall and device ms, the all-
                 gather's bytes (0.25 B a coordinate plus w_q), held leaf by
                 leaf to the plain version (codes equal but at proven ties at
                 Δ, means and residuals within 1e-6), then the exact fp32
                 all-reduce's time and bytes; (c) ResNet18*'s 52 segments from
                 16 uploads, 8 per rank, folded sharded (one aggregate and one
                 vote launch per rank) against the one-launch fold of all 16
                 (1e-6); (d) qwen3-moe-30b-a3b at its published widths, 2 of
                 48 layers, EP 2: the a2a forward at capacity 16 against the
                 scatter dispatch (1e-5 of max |logits|), the int8 wire within
                 5% relative L2; (b) olmo-1b at full width cut to 6 of 16
                 layers, TrainerConfig defaults, adam(3e-4), 8 × 512 over 2
                 pods, 3 compressed steps (one quantize_pack launch a step)
                 and 3 exact ones, per step ms, loss and peak memory, held on
                 rank 0 to a one-process emulation with the plain collective
                 and to one process stepping the whole batch (losses rtol
                 1e-4, final params 5e-3 in the worst leaf's relative L2),
                 and a planted fault (the pods skip the gradient sync) that
                 must fail both limits;
  9c. tensor_parallel — in the same spawn, which has four ranks (ranks 2
                 and 3 wait for the pods x model part): (a) olmo-1b at full
                 width cut to 4 of 16 layers, TrainerConfig defaults, adam(3e-4), 2
                 steps at 8 × 512 of the CLI's token stream over a (1, 2)
                 data × model mesh on ranks 0 and 1: per step ms, tokens/s
                 and loss, per rank peak memory, launches and wire bytes; the
                 seed-0 state's QAT codes on the shards (whole-leaf
                 statistics) against the whole leaves', differing only at
                 ties at Δ, those weights then moved off Δ; held on rank 0,
                 after the ranks free the card, to one process stepping the
                 same batches from the same state (losses rtol 5e-5, worst
                 leaf ‖Δparams‖/‖params‖ 5e-3), and
                 a planted fault (FTTQ statistics per shard) that must
                 exceed both limits; (b) the trained params saved as a
                 ternary checkpoint from the shards: one quantize_pack
                 launch on rank 0, sha256-equal to the one-process save of
                 the same params (680,526,658 B at 16 layers); (c) ``launch/steps.py``
                 with the mesh: prefill 4 × 32 and 8 greedy decode steps on
                 the shards against one process (logits within 1e-4 of max
                 |logits|, the same tokens); (d) pods x model on all four
                 ranks, mesh (2, 1, 2), olmo-1b at its published widths cut
                 to 4 of 16 layers: the compressed collective on each rank's
                 shards of a seeded gradient tree (one quantize_pack and two
                 aggregate launches, all-gather 0.25 B a shard coordinate
                 plus 4 B a w_q, mean and residuals within 1e-6 of the plain
                 version, codes equal but at ties) and 2 compressed train
                 steps with the same launches and bytes per step; (e)
                 zamba2-1.2b at its published widths cut to 7 of 38
                 layers (two applications of the shared block), remat
                 "full" (each Mamba2 layer would keep ~1.2 GB of SSD
                 intermediates), trained as (a): its Mamba2 weights
                 gathered in each block, the shared attention and MLP block
                 column/row-parallel; held to one process (losses rtol
                 5e-5, ‖Δparams‖/‖params‖ 5e-3) and to a planted fault
                 (FTTQ statistics per shard on the Mamba2 leaves) that must
                 exceed both; (f) qwen3-moe-30b-a3b at its published widths
                 cut to 1 of 48 layers (two layers run out of the 80 GB),
                 trained as (a) with local experts on the replicated
                 tokens: the model ranks' top-k indices hashed and equal in
                 every MoE layer of the first step, the same limits, and a
                 planted fault (the gates enter the combine without
                 ``copy_to_model``) past both; (g) its ternary save from
                 the shards: one quantize_pack launch on rank 0,
                 sha256-equal to the one-process save; (h) zamba2's
                 prefill 4 × 32 and 8 greedy decode steps through
                 ``launch/steps.py`` with the mesh, on local attention
                 caches and SSM states (conv channels and SSD heads cut
                 over "model", the decode on the rank's own heads), against
                 one process (1e-4 of max |logits|, the same tokens, each
                 rank's cache half of one process's bytes); (i) pods x model on all
                 four ranks, mesh (2, 1, 2): the compressed collective on
                 each rank's shards of a seeded gradient tree of
                 qwen3-moe-30b-a3b cut to 1 layer (one quantize_pack and
                 two aggregate launches, the all-gather 0.25 B a shard
                 coordinate plus 4 B a w_q, mean and residuals within 1e-6
                 of the plain version, codes equal but at proven ties); (r)
                 qwen3-moe-30b-a3b cut to 1 of 48 layers on the pair with
                 the all-to-all MoE under "model" (EP over it, each rank's
                 own 64 experts, capacity 16, 2 × 128 tokens): the first QAT
                 step's loss (rtol 5e-5) and every leaf's ‖Δg‖/‖g‖ (5e-3;
                 the expert stacks and the router named) against the
                 scatter dispatch from the same state, a planted fault (no
                 1/n_ep scale on the returned copies' gradient) past the
                 limit on every expert stack, the all-to-all's bytes and
                 calls a rank against their closed form, the buffers'
                 bytes, one step of each timed, and the int8 wire's
                 forward within 5% relative L2 of the plain wire's;
  9d. fsdp — in the same spawn, FSDP over the "data" axis (params and both
                 Adam moments cut on each leaf's "data" dim, each layer's
                 weights all-gathered where it uses them, their gradients
                 reduce-scattered): (j) olmo-1b at full width cut to 4 of
                 16 layers, TrainerConfig defaults, adam(3e-4), 2 steps at 8 ×
                 512 over a (2, 1) data × model mesh on ranks 0 and 1: per
                 step ms, tokens/s, loss and the wire bytes, per rank the
                 bytes of its params and moments and the all-gather and
                 reduce-scatter bytes a step, each exactly its shards'
                 (7,678,722,048 and 2,147,483,648 at 16 layers), peak
                 memory and launches; the seed-0
                 codes on the shards against the whole leaves' (ties moved
                 off Δ); held on rank 0 to one process stepping the same
                 batches from the same state (losses rtol 5e-5, worst leaf
                 ‖Δparams‖/‖params‖ 5e-3) and a planted fault (the gather's
                 backward keeps its own slice, no reduce-scatter) past
                 both; (m) the trained data shards' ternary save: one
                 quantize_pack launch on rank 0, sha256-equal to the
                 one-process save; (n) prefill 4 × 32
                 and 8 greedy decode steps on the data shards (each layer
                 gathered, no autograd) against one process (1e-4 of max
                 |logits|, the same tokens); (k) olmo-1b cut to 4 of 16
                 layers over (2, 2) data × model on all four ranks, 1
                 step: each rank's state bytes and the run against one
                 process (the same limits); (l) pods × data, mesh (2, 2,
                 1), olmo-1b cut to 4 layers: the compressed collective on
                 each rank's data shards (one quantize_pack and two
                 aggregate launches, all-gather 0.25 B a shard coordinate
                 plus 4 B a w_q, mean and residuals within 1e-6 of the plain
                 version) and 2 compressed steps with the same launches, the
                 weights' gathers and reduce-scatters counted exactly;
  9e. serve_rows — in the same spawn: (o) is (n), 2 rows a rank, 4 greedy
                 steps; (p) olmo-1b 4 of 16 layers, batch 1, a 4,096-slot cache's
                 sequence over the two data ranks, a 2,044-token prompt and
                 6 steps, the fifth writing rank 1's first slot; (q)
                 granite-20b (MQA) cut to 4 of 52 layers, batch 2, its
                 cache's sequence over 2 model ranks; each against one
                 process (1e-4 of max |logits|, the same tokens, every
                 rank's cache exactly half);
  9g. bf16_mesh — in the same spawn, the reference's bf16 production train
                 cell (``launch/dryrun.py::build_cell``: bf16 params and
                 compute, remat "full", the batch constrained to "data",
                 QAT, adam(1e-4), 2 microbatches) over the mesh, olmo-1b at
                 full width cut to 4 of 16 layers, 2 steps at 8 × 512: (t)
                 over (1, 2) data × model and (u) over (2, 1) on ranks 0
                 and 1, each held on rank 0 to one process's bf16 steps
                 from the same state (the loss within 2^-13, the worst
                 leaf's ‖Δparams‖ within 0.25 of the one-process update
                 ‖params − start‖) and a planted fault past both (FTTQ
                 statistics per shard; the gather's backward keeping its
                 own slice); the shards' codes against the whole leaves'
                 (ties moved off Δ); exactly one bf16 ``qat_backward``
                 launch per quantized leaf shard per microbatch per step
                 and rank, none of the fp32 entry; per step ms, ms inside
                 gloo, per rank peak memory; (u) its state bytes, its
                 gathers and reduce-scatters a step in their closed form,
                 its ternary save from the data shards (one quantize_pack
                 launch, the one-process save's bytes, codes and scales
                 equal to the plain version's, and so the records' scales)
                 and its peak within 20% of the dry-run's; (v) pods × model
                 on all four ranks, mesh (2, 1, 2), 4 layers, 2 compressed
                 steps: one quantize_pack and two aggregate launches a step
                 and rank, the all-gather 0.25 B a shard coordinate plus 4
                 B a w_q, and each step's sync against the plain version on
                 its own inputs (codes equal but at proven ties, mean and
                 residuals within 1e-6);
  9f. midhead — sixteen ranks spawned on the card over gloo, a (1, 16) data
                 × model mesh: (s) gemma3-4b at its published widths cut to
                 6 of 34 layers (five sliding-window layers, then the global
                 one), 8 query heads, so each rank's wq columns are half a
                 head; its seed-0 params drawn once by the first rank and
                 handed out as shards; the shards' QAT codes against the
                 whole leaves' (differing only at ties at Δ); prefill 2 × 64
                 and 2 greedy steps with the cache's sequence over "model"
                 against one process (1e-4 of max |logits|, the same
                 tokens, each rank's cache exactly 1/16 of its bytes); the
                 first QAT step's loss (rtol 5e-5) and worst leaf ‖Δg‖/‖g‖
                 (5e-3) against one process from the same params;
 10. federated — two T-FedAvg sync rounds (paper Algorithm 2) on ResNet18* at
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
 11. robust    — one defended sync round of ResNet18* at full width (rule
                 majority on the vote kernel, 30 seeded sign-flip attackers of
                 100 clients): bytes, phase wall times, the gate's telemetry and
                 ledger, launches (one vote launch per flush); then, on the
                 last federated round's 10
                 uploads, the majority, median and trimmed_mean folds on the
                 card against the CPU plain folds, the sign-flip guarantee, and
                 the gate against 3 nan_poison uploads;
 12. async     — the buffered-async T-FedAvg server (``mode="async"``) on
                 ResNet18* at full width, FedConfig defaults (10 clients in
                 flight), buffer_k 4, staleness exponent 0.5, η 1, staleness
                 cap 1 with the drop policy, 2 mixes: per mix the simulated
                 time, wall seconds per phase, bytes, dispatches, staleness,
                 drops and accuracy; launches (one quantize_pack per dispatch
                 and per broadcast version, one aggregate per mix on the run's
                 one long-lived aggregator); the last mix's fold on its
                 buffered uploads and staleness weights against
                 ``server_aggregate``;
 13. hierarchy — one sync T-FedAvg round on ResNet18* at full width through
                 3 requantizing edges (``mod``): the tier's telemetry and
                 ledger, upload = client→edge + edge→root bytes, launches (one
                 quantize_pack per broadcast, upload and active edge; one
                 aggregate per active edge and at the root); then a lossless
                 tier on the card over the same uploads against a flat card
                 Aggregator;
 14. controller — two sync T-FedAvg rounds on ResNet18* at full width with
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
 15. fleet     — ``repro_torch.fed.run_fleet`` on ResNet18* at full width at
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
 16. socket    — ``repro_torch.fed.run_socket_round`` on ResNet18* at full
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
 17. quickstart — repro_torch.launch.quickstart on the card, then its own
                 ternary_quantize, pack2bit and unpack2bit outputs against
                 the plain versions on the same inputs, bit for bit;
 18. fan-in timings — aggregate and vote over one round's fold (52 segments,
                 10 clients) in one launch, as a CUDA-graph replay and as an
                 eager Aggregator flush (staging fill, pinned copy, launch),
                 beside the per-segment pattern of 52 launches of 32-row tiles
                 at C = 16, and at 16 clients × 2^26 elements; bytes bounds and
                 plain versions;
 19. fan-in trace — the aggregate phase of one mean and one majority round
                 on the last round's uploads under torch.profiler, with the
                 Aggregator's host ranges (add, stage, copy, launch, finalize);
 20. fed trace — one round of one client at E = 1, B = 64, timed untraced
                 and then run under torch.profiler.
Before each driven path (serve, each serve-loop engine and closed-loop run,
each zoo arch, the train phase's ternary save, federated, robust, async,
hierarchy, controller, each fleet run, each socket run, quickstart) every
kernel's launch counter is set to 0, and read just after; a socket run's client
processes count their own launches and report them as they exit.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import json
import math
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
BF16_LONG_ROWS = 2048       # the bf16 matmul checks' long prompt, beside decode and prefill rows


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


_START = time.perf_counter()


def phase(name: str) -> None:
    print(f"== {name} (at {time.perf_counter() - _START:.1f} s)", flush=True)


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
# the async server's buffered mixes, and the fed trace's local epochs (the
# paper's E is 5), cut from 3 and 5 to make room for the bf16_train phase in
# the script's time
ASYNC_MIXES = 2
FED_TRACE_EPOCHS = 1
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
    from repro_torch.kernels.qat_backward import qat_backward, qat_backward_bf16
    from repro_torch.kernels.quantize_pack import quantize_pack
    from repro_torch.kernels.ternary_matmul import ternary_matmul
    from repro_torch.kernels.ternary_quantize import ternary_quantize
    from repro_torch.kernels.vote import packed_vote_counts

    return {"quantize_pack": quantize_pack, "ternary_matmul": ternary_matmul,
            "aggregate": packed_weighted_sum, "vote": packed_vote_counts,
            "ternary_quantize": ternary_quantize, "pack2bit": pack2bit,
            "unpack2bit": unpack2bit, "qat_backward": qat_backward,
            "qat_backward_bf16": qat_backward_bf16}


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


def _subnormal_inputs():
    """Seeded fp32 leaves that hold subnormals (numpy): all subnormal, the
    same with a tiny normal (2e-38) as the maximum, and values within six
    steps of 2^-126 on either side; and an error-feedback tree: a weight
    whose first 16 rows are subnormal, an all-subnormal bias and weight,
    and such an edge weight."""
    import numpy as np

    tiny = 2.0 ** -126
    base = np.random.default_rng(0).normal(size=(64, 32)).astype(np.float32)
    sub = (base * 1e-39).astype(np.float32)
    tiny_max = sub.copy()
    tiny_max.reshape(-1)[5] = np.float32(2e-38)
    rng = np.random.default_rng(1)
    edge = (rng.choice([-1.0, 1.0], size=(64, 32))
            * (tiny + rng.integers(-6, 7, size=(64, 32)) * 2.0 ** -149)).astype(np.float32)
    w = base.copy()
    w[:16] *= np.float32(1e-39)
    tree = {"layer": {"w": w, "bias": sub[0].copy()}, "sub": {"w": sub[:16].copy()},
            "edge": {"w": edge[:16].copy()}}
    return {"subnormal": sub, "tiny_max": tiny_max, "edge": edge}, tree


def subnormal_rule_checks(dev) -> dict:
    """XLA's subnormal rule in the FTTQ statistics and the error-feedback
    residuals, the card against the CPU on the same inputs: on each leaf of
    ``_subnormal_inputs`` in fp32 and bf16, ``core.fttq``'s θ_s, Δ (both
    rules), codes, init_wq, QAT forward and backward, row codes and row
    statistics, and ``ops.fttq_apply`` (the QAT step at the CPU's
    init_wq on both devices); over three encodes of the tree,
    ``compress_pytree`` with error feedback for every pair of registered
    codecs (kind, residual); and three steps of the one-pod compressed sync
    (``ternary_allreduce_tree``, the quantize_pack and aggregate kernels on
    the card). Every output bit for bit, except a sum over many normal
    terms, which each device runs in its own order (the edge leaf's Δ, w_q
    and g_wq; a ternary scale from tile moments where a code is nonzero,
    and the residual where a code was): those within rtol 1e-6 (bf16:
    2^-8); and a NaN or ±inf weight through the row codes and the QAT
    forward and backward, NaN where the CPU's is. Fails on any other
    difference."""
    import numpy as np
    import torch

    from repro_torch.core import fttq
    from repro_torch.comm.wire import encode_update
    from repro_torch.core.compression import (
        CodecSpec, available_codecs, compress_pytree, is_wire_leaf,
    )
    from repro_torch.core.ternary import TernaryTensor
    from repro_torch.kernels import ops
    from repro_torch.parallel.collectives import ternary_allreduce_tree
    from repro_torch.tree import flatten_with_path, tree_map

    def bits(t):
        t = t.detach().cpu().contiguous().reshape(-1)
        return t.view(torch.uint8)

    def fttq_outputs(x, cot, wq, d):
        x, cot = x.to(d), cot.to(d)
        out = {}
        ts = fttq.scale_layer(x)
        out["theta_s"] = (ts, True)
        for rule in ("mean", "max"):
            delta = fttq.fttq_threshold(ts, 0.7, rule)
            out[f"delta_{rule}"] = (delta, rule == "max")
            out[f"codes_{rule}"] = (fttq.ternarize(ts, delta), True)
            out[f"init_wq_{rule}"] = (fttq.init_wq(x, fttq.FTTQConfig(threshold_rule=rule)),
                                      False)
        rows = x.reshape(4, -1)
        out["row_codes"] = (fttq.row_codes(rows, 0.7), True)
        denom, delta = fttq.leaf_row_stats([rows], 0.7, [()])[0]
        out["row_denom"], out["row_delta"] = (denom, True), (delta, False)
        theta = x.clone().requires_grad_()
        wq = wq.to(d).clone().requires_grad_()
        y = fttq.FTTQQuantize.apply(theta, wq, 0.7)
        y.backward(cot.to(x.dtype))
        out["qat_forward"], out["qat_g_theta"], out["qat_g_wq"] = (y, True), \
            (theta.grad, True), (wq.grad, False)
        i_t, theta_t, w_q = ops.fttq_apply(x, 0.7)
        out["apply_codes"], out["apply_theta_t"], out["apply_wq"] = (i_t, True), \
            (theta_t, False), (w_q, False)
        return out

    t0 = time.perf_counter()
    leaves, tree_np = _subnormal_inputs()
    cot = torch.from_numpy(leaves["edge"]) * 2.0 ** 126     # normal cotangents near ±1
    n_outputs = n_exact = bad = 0
    worst = 0.0
    for name, leaf in leaves.items():
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(leaf).to(dtype)
            wq = fttq.init_wq(x, fttq.FTTQConfig())     # one factor for both devices
            cpu, card = fttq_outputs(x, cot, wq, "cpu"), fttq_outputs(x, cot, wq, dev)
            for key, (want, exact) in cpu.items():
                got = card[key][0]
                n_outputs += 1
                if exact or name != "edge":
                    n_exact += 1
                    if not torch.equal(bits(got), bits(want)):
                        bad += 1
                        print(f"  {name} {dtype} {key}: the card's bits differ from the CPU's")
                else:
                    g, w = got.detach().cpu().double(), want.detach().double()
                    rel = float(((g - w).abs() / w.abs().clamp_min(1e-300)).max())
                    worst = max(worst, rel)
                    if rel > (1e-6 if dtype == torch.float32 else 2 ** -8):
                        bad += 1
                        print(f"  {name} {dtype} {key}: rtol {rel:.2e}")
    # a NaN or ±inf weight at x[1, 3] of a (4, 16) leaf with a factor a row:
    # codes, θ_t and g_θ NaN where the CPU's are and bit for bit elsewhere,
    # g_wq (16 terms in each device's order) within rtol 1e-6
    rng = np.random.default_rng(9)
    x_nf = rng.normal(size=(4, 16)).astype(np.float32)
    w_nf = np.abs(rng.normal(size=(4,))).astype(np.float32)
    c_nf = torch.from_numpy(rng.normal(size=(4, 16)).astype(np.float32))

    def qat_rows(x, d):
        theta = torch.from_numpy(x).to(d).requires_grad_()
        wq = torch.from_numpy(w_nf).to(d).requires_grad_()
        q = fttq.FTTQQuantize.apply(theta, wq, 0.7)
        (q * c_nf.to(d)).sum().backward()
        return [fttq.row_codes(theta.detach(), 0.7), q.detach(), theta.grad, wq.grad]

    n_nonfinite = 0
    for value in (float("nan"), float("inf"), -float("inf")):
        x = x_nf.copy()
        x[1, 3] = value
        for i, (got, want) in enumerate(zip(qat_rows(x, dev), qat_rows(x, "cpu"))):
            got, nan = got.cpu(), torch.isnan(want)
            n_nonfinite += int(nan.sum())
            same = torch.equal(torch.isnan(got), nan) and (
                torch.equal(bits(got[~nan]), bits(want[~nan])) if i < 3 else
                bool(((got[~nan] - want[~nan]).abs() <= 1e-6 * want[~nan].abs()).all()))
            if not same:
                bad += 1
                print(f"  a {value} weight: the card's {('codes', 'theta_t', 'g_theta', 'g_wq')[i]} "
                      "differ from the CPU's")
    tree = tree_map(torch.from_numpy, tree_np)
    card_tree = tree_map(lambda t: t.to(dev), tree)
    pairs = [(k, r) for k in available_codecs() for r in available_codecs()
             if (k, r) != ("none", "none")]
    n_leaves = n_res_exact = 0
    for kind, residual in pairs:
        spec = CodecSpec(kind=kind, residual=residual, topk_fraction=0.3, error_feedback=True)
        r_cpu = r_card = None
        exact = {}
        for step in range(3):
            w_cpu, r_cpu = compress_pytree(tree, spec, residual=r_cpu)
            w_card, r_card = compress_pytree(card_tree, spec, residual=r_card)
            for ((path, a), (_, b)), (_, ra), (_, rb) in zip(
                    zip(flatten_with_path(w_card, is_leaf=is_wire_leaf),
                        flatten_with_path(w_cpu, is_leaf=is_wire_leaf)),
                    flatten_with_path(r_card), flatten_with_path(r_cpu)):
                n_leaves += 1
                ra, rb = ra.detach().cpu().reshape(-1), rb.reshape(-1)
                if not isinstance(b, TernaryTensor):
                    n_res_exact += 1
                    if encode_update({"x": a}) != encode_update({"x": b}) or not torch.equal(
                            bits(ra), bits(rb)):
                        bad += 1
                        print(f"  {kind}/{residual} {path}: the card's wire or residual bits "
                              "differ from the CPU's")
                    continue
                p = b.packed.reshape(-1)
                codes = torch.stack([(p >> k) & 3 for k in (0, 2, 4, 6)], 1).reshape(-1)
                zero = codes[: rb.numel()] == 1
                ok = exact[path] = zero & exact.get(path, torch.ones_like(zero))
                scale = float(b.w_q.abs().max())
                w_gap = float((a.w_q.cpu() - b.w_q).abs().max())
                if not torch.equal(bits(a.packed), bits(b.packed)) \
                        or (bool(zero.all()) and not torch.equal(bits(a.w_q), bits(b.w_q))) \
                        or w_gap > 1e-6 * scale or not torch.equal(bits(ra[ok]), bits(rb[ok])) \
                        or float(torch.cat([(ra[~ok] - rb[~ok]).abs(), torch.zeros(1)]).max()) \
                        > 1e-6 * (step + 1) * scale:
                    bad += 1
                    print(f"  {kind}/{residual} {path}: the card's ternary leaf differs from "
                          "the CPU's")
    s_cpu = s_card = None
    for _ in range(3):
        sync_cpu, s_cpu = ternary_allreduce_tree(tree, None, residuals=s_cpu)
        sync_card, s_card = ternary_allreduce_tree(card_tree, None, residuals=s_card)
        for (path, a), (_, b) in zip(flatten_with_path([sync_card, s_card]),
                                     flatten_with_path([sync_cpu, s_cpu])):
            n_leaves += 1
            if "sub" in str(path) or "bias" in str(path):
                n_res_exact += 1
                if not torch.equal(bits(a), bits(b)):
                    bad += 1
                    print(f"  sync {path}: the card's bits differ from the CPU's")
            elif float((a.cpu() - b).abs().max()) > 1e-6 * float(b.abs().max()):
                bad += 1
                print(f"  sync {path}: beyond 1e-6 of the largest |value|")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"  FTTQ statistics on {len(leaves)} subnormal leaves x 2 dtypes: {n_outputs} "
          f"outputs, {n_exact} held bit for bit, the rest within rtol {worst:.2e}; a NaN, "
          f"+inf and -inf weight through the row codes and the QAT forward and backward: "
          f"{n_nonfinite} NaN outputs where the CPU's are; "
          f"compress_pytree with error feedback, {len(pairs)} codec pairs x 3 encodes, and "
          f"3 steps of the one-pod sync: {n_leaves} leaves, {n_res_exact} of them bit for bit "
          f"(wire and residual), the ternary ones as the docstring holds them; {bad} "
          f"differences; {secs:.2f} s")
    check(bad == 0, "the card breaks XLA's subnormal rule where the CPU keeps it")
    return {"outputs": n_outputs, "exact": n_exact, "nonfinite_nans": n_nonfinite,
            "leaves": n_leaves,
            "leaves_exact": n_res_exact, "worst_rtol": worst, "differences": bad, "s": secs}


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


def qat_backward_checks(dev) -> dict:
    """The QAT backward's kernel (not a TPU kernel's port: it fuses what XLA
    fuses for the reference's straight-through backward) on olmo-1b's
    quantized leaves at full width (olmo-1b: 7 stacked leaves, 2^30 fp32
    weights), a seeded cotangent, codes and per-layer factors: g_θ and the
    g · I_t terms bit for bit against the plain version leaf by leaf, then
    the kernel over all of them timed by CUDA-graph replay beside the plain
    version and its bytes bound (two reads, two writes of 4 B a weight).
    No single PyTorch call computes it."""
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.fttq import FTTQConfig, backward_cuts, is_quantizable
    from repro_torch.kernels.qat_backward import qat_backward, qat_backward_plain
    from repro_torch.models.transformer import param_shapes
    from repro_torch.tree import flatten_with_path

    fcfg = FTTQConfig()
    shapes = [shape for path, shape in flatten_with_path(
        param_shapes(get_config("olmo-1b")), is_leaf=lambda x: isinstance(x, tuple))
        if is_quantizable(path, torch.empty(shape, device="meta"), fcfg)]
    gen = torch.Generator(device=dev).manual_seed(41)
    args = []
    bad = 0
    worst = 0.0
    for shape in shapes:
        rows = shape[0] if len(shape) >= 3 else 1
        g = torch.randn(rows, math.prod(shape) // rows, generator=gen, device=dev) * 1e-3
        codes = torch.randint(-1, 2, g.shape, generator=gen, device=dev).float()
        w = torch.rand(rows, 1, generator=gen, device=dev) * 0.05
        (cut,) = backward_cuts([w])
        args.append((g, codes, w, cut))
        for a, b in zip(qat_backward(g, codes, w, cut), qat_backward_plain(g, codes, w, cut)):
            bad += int((a.view(torch.int32) != b.view(torch.int32)).sum())
            worst = max(worst, _max_abs_diff(a, b))
        torch.cuda.empty_cache()
    n = sum(a[0].numel() for a in args)
    out = {"leaves": len(args), "weights": n, "differ": bad, "max_abs_err": worst}
    out["ms"] = time_ms(lambda: [qat_backward(*a) for a in args], 5)
    out["plain_ms"] = time_ms(lambda: [qat_backward_plain(*a) for a in args], 2)
    nbytes = 16 * n + 8 * sum(a[2].numel() for a in args)
    out["bound_ms"], out["bound_by"] = bound(nbytes, 3 * n)
    del args
    torch.cuda.empty_cache()
    print(f"qat_backward, {out['leaves']} leaves ({n} fp32 weights): {bad} outputs differ from "
          f"the plain version; kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, "
          f"bound {out['bound_ms']:.4f} ms ({out['bound_by']}, {nbytes} B); library: none")
    check(bad == 0, "qat_backward differs from its plain version")
    return out


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
    E = FED_TRACE_EPOCHS, B = 64 (7 QAT steps an epoch, with the broadcast,
    encode, fan-in and eval around them), run once untraced and timed, then
    again under torch.profiler. The idle share is the device time against
    the untraced wall of the same window, since the profiler slows the
    host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fed.simulation import FedConfig, run_federated
    from repro_torch.models.paper_models import resnet_cifar
    from repro_torch.optim import adam

    clients, params, eval_fn = setup
    cfg = FedConfig(rounds=1, n_clients=len(clients), participation=1 / len(clients),
                    local_epochs=FED_TRACE_EPOCHS)

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


SERVE_LOOP_REQUESTS = 64
SERVE_LOOP_PROMPT = 8
SERVE_LOOP_BATCH = 8
SERVE_LOOP_QPS = (5.0, 2000.0)               # under and over saturation
SERVE_LOOP_CAPACITIES = (1 << 24, 1 << 30)   # the default, and room for the embedding
ZOO_MATMUL_SHAPES = [(4, 2560, 2048), (128, 2560, 2048),      # gemma3 wq, head_dim 256
                     (4, 6144, 24576), (128, 6144, 24576),    # granite's MLP
                     (1024, 1280, 1280),                      # hubert, 2 × 512 frames
                     (6400, 4096, 1024)]                      # vlm cross K/V, 4 × 1600
# (arch, how it is served, layers kept; None keeps them all)
# the vlm cut from 10 to 5 layers (one cross layer) and the MoE archs from 4
# to 2 to make room for the bf16_mesh phase: their deploys (the host's wire
# codec) took 13.8, 8.0 and 5.6 s
ZOO = [("gemma3-4b", "packed", None), ("granite-20b", "packed", 4),
       ("llama-3.2-vision-11b", "packed", 5), ("hubert-xlarge", "packed", None),
       ("qwen3-moe-30b-a3b", "ternary", 2), ("deepseek-moe-16b", "ternary", 2),
       ("mamba2-370m", "ternary", None), ("zamba2-1.2b", "ternary", None)]
ZOO_FRAMES = 512           # hubert: 2 × 512 frame embeddings
LONG_PREFILL = 4096        # gemma3: one 4,096-token prefill into 4,112 slots
SSD_PREFILL = 1024         # mamba2-370m: 4 chunks of 256


def serve_loop_phase(dev, cfg, params, fcfg) -> dict:
    """``ServeEngine`` on olmo-1b at full width at two cache capacities,
    each under ``run_closed_loop`` at two offered rates; launch counts,
    byte counts and cache counters held to their derived values."""
    import torch

    from repro_torch.launch.serve import ternary_deploy
    from repro_torch.launch.serve_loop import ServeEngine, run_closed_loop
    from repro_torch.models.transformer import forward

    per_forward = cfg.n_layers * LAYER_MATMULS
    embed_bytes = cfg.vocab_size * cfg.d_model * 4
    packed_bytes = 2 ** 30 // 4 + LAYER_MATMULS * cfg.n_layers * 4
    out = {"engines": {}}
    for cap in SERVE_LOOP_CAPACITIES:
        zero_counters()
        t0 = time.perf_counter()
        engine = ServeEngine(cfg, params, max_batch=SERVE_LOOP_BATCH, residual="fp16",
                             cache_capacity_bytes=cap, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        launches = read_counters()
        st = engine.stats()
        print(f"engine, cache {cap} B: built in {build_s:.3f} s; wire {st['wire_bytes']} B, "
              f"packed weights {st['packed_weight_bytes']} B, lazy leaves "
              f"{engine._lazy_keys} ({st['lazy_wire_bytes_dense']} B dense); launches "
              f"{json.dumps(launches)}")
        check(launches["quantize_pack"] == 1, "an engine's deploy is one quantize_pack launch")
        check(engine._lazy_keys == ["['embed']['table']"], "olmo-1b's one lazy leaf")
        check(st["lazy_wire_bytes_dense"] == embed_bytes == 412_090_368,
              f"lazy dense bytes {st['lazy_wire_bytes_dense']}")
        check(st["packed_weight_bytes"] == packed_bytes == 268_435_904,
              f"packed weight bytes {st['packed_weight_bytes']}")
        row = {"build_s": build_s, "stats": st, "runs": {}}
        if cap == SERVE_LOOP_CAPACITIES[0]:
            served, wire_bytes, _, _ = ternary_deploy(params, fcfg, packed=True,
                                                      residual="fp16", device=dev)
            check(wire_bytes == st["wire_bytes"], "the engine's artifact differs from the "
                                                  "one-shot deploy's")
            probe = torch.randint(0, cfg.vocab_size, (2, 8),
                                  generator=torch.Generator(dev).manual_seed(3), device=dev)
            le = engine.forward(probe)
            lr, _, _ = forward(cfg, served, probe)
            err = float((le - lr).abs().max())
            print(f"engine vs one-shot packed deploy logits: max |d| = {err:.3e} "
                  "(rtol 1e-5, atol 1e-5)")
            check(bool(torch.allclose(le, lr, rtol=1e-5, atol=1e-5)),
                  "the engine's logits differ from the one-shot deploy's")
            row["vs_deploy_max_abs"] = err
            del served, le, lr
        for qps in SERVE_LOOP_QPS:
            zero_counters()
            f0 = engine.forwards
            rep = run_closed_loop(engine, n_requests=SERVE_LOOP_REQUESTS, offered_qps=qps,
                                  prompt_len=SERVE_LOOP_PROMPT, seed=0)
            launches = read_counters()
            n_fwd = engine.forwards - f0
            r = rep.row()
            print(f"  offered {qps} QPS: p50 {r['p50_ms']:.3f} ms, p99 {r['p99_ms']:.3f} ms, "
                  f"mean {r['mean_ms']:.3f} ms, mean batch {r['mean_batch']:.3f}, achieved "
                  f"{r['achieved_qps']:.3f} QPS, busy {r['wall_s']:.3f} s, {n_fwd} forwards; "
                  f"cache {json.dumps(r['cache'])}; launches {json.dumps(launches)}")
            check(launches["ternary_matmul"] == per_forward * n_fwd,
                  f"ternary_matmul launched {launches['ternary_matmul']} times in "
                  f"{n_fwd} forwards")
            check(launches["quantize_pack"] == 0, "serving launched quantize_pack")
            row["runs"][qps] = {"report": r, "forwards": n_fwd, "launches": launches}
        c = engine.cache.stats()
        total = engine.forwards
        if cap < embed_bytes:
            ok = c["misses"] == total and c["evictions"] == total and c["hits"] == 0
        else:
            ok = c["misses"] == 1 and c["hits"] == total - 1 and c["evictions"] == 0
        check(ok, f"cache counters {c} after {total} forwards at capacity {cap}")
        out["engines"][cap] = row
        del engine
        torch.cuda.empty_cache()
    return out


def _free() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


class _Capture:
    """Wraps ``module.name`` and keeps the arguments of the calls whose
    index is in ``keep`` (the wrapped function still runs)."""

    def __init__(self, module, name: str, keep):
        self.module, self.name, self.keep = module, name, set(keep)
        self.real = getattr(module, name)
        self.calls = 0
        self.args = {}

    def __enter__(self):
        def wrapped(*args, **kw):
            if self.calls in self.keep:
                self.args[self.calls] = (args, dict(kw))
            self.calls += 1
            return self.real(*args, **kw)

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def _decode_vs_prefill(cfg, params, dev, tokens: int = 16) -> float:
    """Max |logits| gap between a prefill of ``tokens`` and as many cached
    one-token steps, held to rtol 3e-3, atol 3e-3 (the reference test's)."""
    import torch

    from repro_torch.models.transformer import decode_step, forward, init_cache

    toks = torch.randint(0, cfg.vocab_size, (2, tokens),
                         generator=torch.Generator(dev).manual_seed(4), device=dev)
    full, _, _ = forward(cfg, params, toks)
    cache = init_cache(cfg, 2, tokens, device=dev)
    steps = []
    for t in range(tokens):
        lg, cache = decode_step(cfg, params, toks[:, t:t + 1], cache, t)
        steps.append(lg[:, 0])
    dec = torch.stack(steps, 1)
    gap = float((dec - full).abs().max())
    check(bool(torch.allclose(dec, full, rtol=3e-3, atol=3e-3)),
          f"{cfg.name}: cached decode differs from the prefill by {gap:.3e}")
    return gap


def _long_prefill_check(cfg, served, dev) -> dict:
    """gemma3: one 4,096-token prefill into 4,112 slots takes the blocked
    softmax on every layer; on global layer 5 and sliding layer 0 the
    blocked path's output on that prefill's q/k/v equals the naive one."""
    import torch

    from repro_torch.models import attention as attn_mod
    from repro_torch.models.transformer import forward, init_cache, layer_windows

    windows = layer_windows(cfg)
    check(windows[5] == 1 << 30 and windows[0] == cfg.sliding_window, "gemma3's layer windows")
    toks = torch.randint(0, cfg.vocab_size, (1, LONG_PREFILL),
                         generator=torch.Generator(dev).manual_seed(6), device=dev)
    cache = init_cache(cfg, 1, LONG_PREFILL + 16, device=dev)
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _Capture(attn_mod, "_attend_flash", keep=(0, 5)) as cap:
        logits, _, _ = forward(cfg, served, toks, cache=cache, pos=0)
        torch.cuda.synchronize()
    t_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counters()
    check(cap.calls == cfg.n_layers, f"{cap.calls} blocked-softmax calls, want {cfg.n_layers}")
    check(bool(torch.isfinite(logits).all()), "long prefill logits are not finite")
    errs = {}
    for layer in (0, 5):
        args, kw = cap.args[layer]
        got = cap.real(*args, **kw)
        want = attn_mod._attend_naive(*args, **kw)
        errs[layer] = float((got - want).abs().max())
        check(errs[layer] <= 1e-5, f"blocked vs naive softmax at layer {layer}: "
                                   f"{errs[layer]:.3e}")
    del cap, cache, logits
    print(f"  long prefill 1 x {LONG_PREFILL} into {LONG_PREFILL + 16} slots: {t_ms:.2f} ms, "
          f"blocked softmax on all {cfg.n_layers} layers; blocked vs naive max |d|: layer 0 "
          f"(window {cfg.sliding_window}) {errs[0]:.3e}, layer 5 (global) {errs[5]:.3e} "
          f"(limit 1e-5); ternary_matmul {launches['ternary_matmul']} launches")
    check(launches["ternary_matmul"] == cfg.n_layers * LAYER_MATMULS,
          "the long prefill's ternary_matmul launches")
    return {"ms": t_ms, "max_abs": errs, "launches": launches}


def _ssd_chunk_check(cfg, params, dev) -> dict:
    """mamba2-370m: the first layer's SSD inputs from a 1 × 1,024 prefill
    (4 chunks of 256) scanned at chunk 256 and at chunk 64 agree within
    1e-4 of max |y|, final states too: the inter-chunk recurrence."""
    import torch

    from repro_torch.models import mamba2 as mb
    from repro_torch.models.transformer import forward

    toks = torch.randint(0, cfg.vocab_size, (1, SSD_PREFILL),
                         generator=torch.Generator(dev).manual_seed(7), device=dev)
    with _Capture(mb, "ssd_chunked", keep=(0,)) as cap:
        forward(cfg, params, toks)
    args, _ = cap.args[0]
    x, dt, a, b, c, chunk = args
    check(chunk == 256 and x.shape[1] == SSD_PREFILL, "mamba2-370m's chunk and length")
    y256, h256 = mb.ssd_chunked(x, dt, a, b, c, 256)
    y64, h64 = mb.ssd_chunked(x, dt, a, b, c, 64)
    ey = float((y256 - y64).abs().max()) / float(y256.abs().max())
    eh = float((h256 - h64).abs().max()) / float(h256.abs().max())
    print(f"  SSD of layer 0 on a 1 x {SSD_PREFILL} prefill, chunk 256 vs 64: max |dy| / max "
          f"|y| = {ey:.3e}, max |dh| / max |h| = {eh:.3e} (limit 1e-4)")
    check(ey <= 1e-4 and eh <= 1e-4, "the SSD scan depends on the chunk size")
    return {"y_rel": ey, "state_rel": eh}


def zoo_phase(dev, fcfg) -> dict:
    """Every family through ``launch/serve.py``'s functions: one deploy
    through TFW1, the packed logits check (packed archs), prefill 4 × 32 and
    15 greedy steps (causal archs) or an encoder forward (hubert); peak
    memory, times and launches per arch; the long-prefill, decode-vs-prefill
    and chunk checks. Each arch frees its tensors before the next."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate, packed_logits_check, ternary_deploy
    from repro_torch.models.frontends import synth_audio_frames, synth_vision_patches
    from repro_torch.models.transformer import forward, init_params, param_count

    out = {}
    for arch, how, layers in ZOO:
        cut = {"n_layers": layers} if layers else {}
        cfg = get_config(arch, **cut)
        full_layers = get_config(arch).n_layers
        packed = how == "packed"
        row = {"how": how, "layers": cfg.n_layers, "of_layers": full_layers,
               "params": param_count(cfg)}
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()       # what earlier phases still hold
        params = init_params(cfg, seed=0, device=dev)
        if cfg.family == "vlm":      # tanh(0) = 0 would silence the cross layers
            params["cross"]["gate_attn"].fill_(0.5)
            params["cross"]["gate_mlp"].fill_(0.5)
        torch.cuda.synchronize()
        zero_counters()
        t0 = time.perf_counter()
        served, wire_bytes, _, _ = ternary_deploy(params, fcfg, packed=packed, device=dev)
        torch.cuda.synchronize()
        row["deploy_s"] = time.perf_counter() - t0
        row["wire_bytes"] = wire_bytes
        launches = read_counters()
        check(launches["quantize_pack"] == 1, f"{arch}: the deploy's quantize_pack launches")
        check(launches["ternary_matmul"] == 0, f"{arch}: the deploy launched ternary_matmul")
        row["launches"] = {"quantize_pack": launches["quantize_pack"]}
        per_forward = 0
        if packed:
            per_forward = (cfg.n_layers + cfg.n_cross) * (6 + cfg.gated_mlp)
        gen = torch.Generator(dev).manual_seed(2)
        vis4 = (synth_vision_patches(gen, BATCH, cfg.n_patches, cfg.d_model)
                if cfg.family == "vlm" else None)
        forwards = 0
        if packed:
            ref_params, ref_bytes, _, _ = ternary_deploy(params, fcfg, packed=False, device=dev)
            check(ref_bytes == wire_bytes, f"{arch}: the two deploys' artifacts differ")
            row["launches"]["quantize_pack"] = read_counters()["quantize_pack"]
            check(row["launches"]["quantize_pack"] == 2, f"{arch}: two deploys, want two "
                                                         "quantize_pack launches")
        zero_counters()
        if packed:
            if cfg.family == "audio":
                probe = {"probe": None, "embeds": synth_audio_frames(gen, 2, ZOO_FRAMES,
                                                                     cfg.d_model)}
            else:
                probe = {"probe": torch.randint(0, cfg.vocab_size, (2, 8), generator=gen,
                                                device=dev)}
                if vis4 is not None:
                    probe["vision_embeds"] = vis4[:2]
            diff, ref_max = packed_logits_check(cfg, served, ref_params, **probe)
            forwards += 1
            row["logits_ratio"] = diff / ref_max
            print(f"{arch}: packed-vs-dequant logits max |d| {diff:.3e}, max |logits_ref| "
                  f"{ref_max:.3e}, ratio {diff / ref_max:.3e} (limit 1e-4)")
            check(diff / ref_max <= 1e-4, f"{arch}: packed logits disagree")
            del ref_params
            _free()
        del params
        _free()
        if cfg.causal:
            prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                                    device=dev)
            tokens, t_prefill, t_decode = generate(cfg, served, prompts, GEN,
                                                   vision_embeds=vis4)
            forwards += GEN
            check(tuple(tokens.shape) == (BATCH, GEN)
                  and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
                  f"{arch}: generated tokens out of shape or vocab")
            row.update(prefill_ms=t_prefill * 1e3, decode_tok_s=BATCH * (GEN - 1) / t_decode)
        else:
            frames = synth_audio_frames(gen, 2, ZOO_FRAMES, cfg.d_model)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _, _ = forward(cfg, served, None, embeds=frames)
            torch.cuda.synchronize()
            row["encoder_ms"] = (time.perf_counter() - t0) * 1e3
            forwards += 1
            check(tuple(logits.shape) == (2, ZOO_FRAMES, cfg.vocab_size)
                  and bool(torch.isfinite(logits).all()), f"{arch}: encoder logits")
            del logits
        launches = read_counters()
        row["launches"]["ternary_matmul"] = launches["ternary_matmul"]
        row["ternary_matmul_per_forward"] = per_forward
        check(launches["ternary_matmul"] == per_forward * forwards,
              f"{arch}: ternary_matmul launched {launches['ternary_matmul']} times, want "
              f"{per_forward} x {forwards}")
        check(launches["quantize_pack"] == 0, f"{arch}: serving launched quantize_pack")
        if arch == "gemma3-4b":
            row["long_prefill"] = _long_prefill_check(cfg, served, dev)
        if arch == "qwen3-moe-30b-a3b":
            row["decode_vs_prefill"] = _decode_vs_prefill(
                dataclasses.replace(cfg, capacity_factor=16.0), served, dev)
        if cfg.family in ("ssm", "hybrid"):
            row["decode_vs_prefill"] = _decode_vs_prefill(cfg, served, dev)
        if arch == "mamba2-370m":
            row["ssd_chunks"] = _ssd_chunk_check(cfg, served, dev)
        row["peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        if cfg.causal:
            times = (f"prefill {row['prefill_ms']:.2f} ms, decode "
                     f"{row['decode_tok_s']:.1f} tok/s")
        else:
            times = f"encoder forward 2 x {ZOO_FRAMES} {row['encoder_ms']:.2f} ms"
        extra = (f", decode vs prefill max |d| {row['decode_vs_prefill']:.3e} (rtol/atol 3e-3)"
                 if "decode_vs_prefill" in row else "")
        print(f"{arch} ({how}, {cfg.n_layers} of {full_layers} layers, {row['params']} params): "
              f"wire {wire_bytes} B, deploy {row['deploy_s']:.3f} s, {times}, peak "
              f"{row['peak_gib']:.2f} GiB above the {base / 2 ** 30:.2f} GiB held before; "
              f"launches quantize_pack {row['launches']['quantize_pack']} (one per deploy), "
              f"ternary_matmul {launches['ternary_matmul']} = {per_forward} x {forwards} "
              f"forwards{extra}")
        out[arch] = row
        del served, vis4
        _free()
    return out


# --------------------------------------------------------------------------
# The train phase: the CLI with a resume, olmo-1b at full width, card vs
# CPU, and every family reduced.
# --------------------------------------------------------------------------

TRAIN_CLI = ["--preset", "10m", "--steps", "60", "--batch", "8", "--seq", "128",
             "--ckpt-every", "30"]
# (batch, seq, steps, microbatches, remat): configs/shapes.py's train_4k
# sequence, its global batch of 256 cut to 8 for one card
# (the 8 x 4,096 run takes one step, to make room for the bf16_train phase)
TRAIN_RUNS = [(8, 512, 3, 1, "none"), (8, 4096, 1, 4, "full")]
TRAIN_LR = 3e-4             # the CLI's default learning rate
TRAIN_CHECK_LAYERS = 2      # olmo-1b cut for the card-vs-CPU step
TRAIN_CHECK_BATCH = (2, 128)
TRAIN_ZOO_STEPS = 2          # cut from 3 to make room for the bf16_train phase
TRAIN_ZOO_DOTS = "gemma3-4b"  # the arch that trains with remat "dots"


def _cli_run(argv, env) -> dict:
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train"] + argv, env=env,
                         capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(res.returncode == 0, f"launch.train {argv} failed: {res.stderr[-2000:]}")
    lines = res.stdout.strip().splitlines()
    check(lines[-1].startswith("done. final loss: "), f"no final loss in {lines[-3:]}")
    logged = [(int(ln.split()[1]), float(ln.split("loss=")[1].split()[0]),
               float(ln.split("gnorm=")[1].split()[0]), float(ln.split()[4]))
              for ln in lines if ln.startswith("step ")]
    return {"wall_s": wall, "final": lines[-1].split(": ", 1)[1], "logged": logged,
            "lines": lines}


def train_cli_check(device: str) -> dict:
    """``python -m repro_torch.launch.train`` (10m preset, 60 steps of 8 x
    128, a checkpoint every 30) in a child process on ``device``; then the
    step-60 checkpoint is deleted and the same command resumes from step 30.
    The resumed final loss must equal the uninterrupted one bit for bit,
    and the logged loss must fall."""
    import shutil

    d = os.path.join(ROOT, "build", "train_smoke_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=SRC)
    argv = TRAIN_CLI + ["--ckpt-dir", d, "--device", device]
    full = _cli_run(argv, env)
    steps = sorted(os.listdir(d))
    check(steps == ["step_000000000030", "step_000000000060"], f"checkpoints {steps}")
    shutil.rmtree(os.path.join(d, "step_000000000060"))
    resumed = _cli_run(argv + ["--resume"], env)
    shutil.rmtree(d, ignore_errors=True)
    check("resumed from step 30 (cursor=30)" in resumed["lines"],
          f"the resumed run did not start at step 30, cursor 30: {resumed['lines'][:3]}")
    losses = [loss for _, loss, _, _ in full["logged"]]
    print(f"CLI 10m, 60 steps of 8 x 128 on {device}: {full['wall_s']:.1f} s in its process; "
          f"logged loss {' -> '.join(f'{x:.4f}' for x in losses)}; ms/step "
          f"{[ms for *_, ms in full['logged']]}; final {full['final']}; resumed from step 30 "
          f"in {resumed['wall_s']:.1f} s: final {resumed['final']}")
    check(resumed["final"] == full["final"],
          f"resume gave final loss {resumed['final']}, the uninterrupted run {full['final']}")
    check(len(losses) == 6 and losses[-1] < losses[0] - 0.1,
          f"the CLI's logged loss does not fall: {losses}")
    return {"wall_s": full["wall_s"], "resume_wall_s": resumed["wall_s"],
            "final_loss": full["final"], "logged": full["logged"],
            "resumed_logged": resumed["logged"]}


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def train_full_width(dev, cfg, fcfg, runs=TRAIN_RUNS) -> dict:
    """``init_train_state`` and ``make_train_step`` with the defaults (QAT,
    grad_clip 1, wq_lr 0.05) on ``cfg``, one run per entry of ``runs``
    from the same seed-0 state; per step the synchronized ms, tokens/s,
    loss and grad norm; per run the peak device memory and the share of
    the fp32 bound (6·N·tokens operations, 8·N under remat, over 67
    TFLOP/s). Then the last state's params are saved as a ternary
    checkpoint (one quantize_pack launch), restored and held to the trained
    params, and two leaves' records to the port's CPU encode."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core.fttq import ternary_stats
    from repro_torch.data.synthetic import synthetic_tokens, token_batches
    from repro_torch.launch.train import DATA_SEED
    from repro_torch.models.transformer import param_count
    from repro_torch.optim import adam
    from repro_torch.train import TrainerConfig, init_train_state, make_train_step
    from repro_torch.tree import tree_leaves

    n_params = param_count(cfg)
    tcfg0 = TrainerConfig()
    out = {"params": n_params, "runs": []}
    tokens = synthetic_tokens(DATA_SEED, max(b * (s + 1) * n for b, s, n, _, _ in runs),
                              cfg.vocab_size)
    state = None
    for b, s, n_steps, micro, remat in runs:
        del state
        _free()
        run_cfg = dataclasses.replace(cfg, remat=remat)
        tcfg = dataclasses.replace(tcfg0, microbatches=micro)
        opt = adam(TRAIN_LR)
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()         # what earlier phases still hold
        t0 = time.perf_counter()
        state = init_train_state(run_cfg, tcfg, opt, seed=0, device=dev)
        _sync(dev)
        init_s = time.perf_counter() - t0
        step = make_train_step(run_cfg, tcfg, opt)
        batches = token_batches(tokens, b, s, device=dev)
        rows = []
        zero_counters()
        for _ in range(n_steps):
            batch, _ = next(batches)
            _sync(dev)
            t0 = time.perf_counter()
            state, m = step(state, batch)
            _sync(dev)
            ms = (time.perf_counter() - t0) * 1e3
            rows.append({"ms": ms, "tok_s": b * s / ms * 1e3, "loss": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"]), "ce": float(m["ce"])})
        ops = (8 if remat != "none" else 6) * n_params * b * s
        best = min(r["ms"] for r in rows)
        peak = torch.cuda.max_memory_allocated()
        held_state = sum(x.numel() * x.element_size() for x in tree_leaves(
            [state.params, state.opt_state["m"], state.opt_state["v"]]))
        qat_launches = read_counters()["qat_backward"]
        run = {"batch": b, "seq": s, "microbatches": micro, "remat": remat, "steps": rows,
               "qat_backward_launches": qat_launches,
               "init_s": init_s, "peak_gib": peak / 2 ** 30, "peak_bytes": peak,
               "held_gib": held / 2 ** 30, "held_bytes": held, "state_bytes": held_state,
               "bound_ms": ops / PEAK_FP32_S * 1e3, "operations": ops}
        run["bound_share"] = run["bound_ms"] / best
        out["runs"].append(run)
        print(f"{cfg.name} at full width ({n_params} params), {b} x {s}, microbatches {micro}, "
              f"remat {remat}: steps " + "; ".join(
                  f"{r['ms']:.1f} ms ({r['tok_s']:.0f} tok/s) loss {r['loss']:.5f} gnorm "
                  f"{r['grad_norm']:.4f}" for r in rows)
              + f"; peak {run['peak_gib']:.2f} GiB ({run['held_gib']:.2f} GiB held before the "
              f"run); fp32 bound {run['bound_ms']:.1f} ms "
              f"({ops:.3e} operations), {100 * run['bound_share']:.1f}% of it at the best step; "
              f"the QAT backward's kernel launched {qat_launches} times")
        check(qat_launches > 0, "a full-width QAT train run launched no qat_backward kernel")
        check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in rows),
              "a full-width train step gave a non-finite loss or grad norm")
        check(int(state.step) == n_steps, f"state.step {int(state.step)} after {n_steps} steps")
    out["qat_backward_launches"] = sum(r["qat_backward_launches"] for r in out["runs"])
    stats = ternary_stats(state.params, fcfg)
    print(f"ternary_stats of the trained params: {json.dumps(stats)}")
    out["ternary_stats"] = stats
    out["ternary_checkpoint"] = ternary_checkpoint_check(dev, state.params, fcfg)
    del state
    _free()
    return out


def ternary_checkpoint_check(dev, params, fcfg) -> dict:
    """``params`` saved as a ternary checkpoint: exactly one quantize_pack
    launch; on-disk bytes against the raw fp32 bytes of the leaves; every
    quantized leaf restored with correlation > 0.6 to the saved one (the
    reference test's bound); two leaves' records against the port's CPU
    encode: the codes equal except at ties of |θ_s| with Δ (each side sums
    |θ_s| for Δ in its own order), the scales within rtol 1e-6."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.core.compression import CodecSpec, compress_pytree
    from repro_torch.core.encode import leaf_scalars
    from repro_torch.core.ternary import unpack_codes
    from repro_torch.core.fttq import is_quantizable
    from repro_torch.train import restore_checkpoint, save_checkpoint
    from repro_torch.train._msgpack import unpackb
    from repro_torch.train.checkpoint import flatten
    from repro_torch.tree import flatten_with_path

    d = os.path.join(ROOT, "build", "train_smoke_tern")
    shutil.rmtree(d, ignore_errors=True)
    spec = CodecSpec(kind="ternary", fttq=fcfg)
    zero_counters()
    t0 = time.perf_counter()
    save_checkpoint(d, 1, params, compression=spec)
    save_s = time.perf_counter() - t0
    launches = read_counters()
    raw = sum(leaf.numel() * leaf.element_size() for _, leaf in flatten_with_path(params))
    path = os.path.join(d, "step_000000000001")
    disk = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    t0 = time.perf_counter()
    restored, meta = restore_checkpoint(d, example_state=params, device=dev)
    _sync(dev)
    restore_s = time.perf_counter() - t0
    corr = {}
    for p, leaf in flatten_with_path(params):
        if is_quantizable(p, leaf, fcfg):
            a = leaf.reshape(-1).double()
            r = restored
            for _, k in p:
                r = r[k]
            b = r.reshape(-1).double()
            a, b = a - a.mean(), b - b.mean()
            corr["/".join(str(k) for _, k in p)] = float((a @ b) / (a.norm() * b.norm()))
    del restored
    with open(os.path.join(path, "state.msgpack"), "rb") as f:
        records = unpackb(f.read())["leaves"]
    names = [name for name, _ in flatten(params)]
    shutil.rmtree(d, ignore_errors=True)
    probe = ("blocks/attn/wk", "blocks/attn/wq")
    cpu_tree = {"blocks": {"attn": {k.split("/")[-1]: params["blocks"]["attn"][k.split("/")[-1]]
                                    .cpu() for k in probe}}}
    cpu_wire, _ = compress_pytree(cpu_tree, spec)
    n_codes = n_diff = n_tie = 0
    scale_gap = 0.0
    for name in probe:
        rec = records[names.index(name)]
        want = cpu_wire["blocks"]["attn"][name.split("/")[-1]]
        theta = cpu_tree["blocks"]["attn"][name.split("/")[-1]].reshape(-1)
        n = theta.numel()
        got_codes = unpack_codes(torch.frombuffer(bytearray(rec["packed"]), dtype=torch.uint8), n)
        diff = got_codes != unpack_codes(want.packed, n)
        n_codes += n
        n_diff += int(diff.sum())
        if bool(diff.any()):
            # a code the two encodes set apart sits on a Δ they round apart
            (denom, delta), _ = leaf_scalars(theta, fcfg)
            gap = ((theta[diff] / denom).abs() - delta).abs()
            n_tie += int((gap <= 1e-6 * delta).sum())
        w_disk = np.frombuffer(rec["w_q"], np.float32)
        w_cpu = want.w_q.numpy().astype(np.float32).reshape(-1)
        scale_gap = max(scale_gap, float(np.max(np.abs(w_disk - w_cpu) / np.abs(w_cpu))))
    print(f"ternary checkpoint of the params: {disk} B on disk against {raw} B of raw fp32 "
          f"leaves ({raw / disk:.2f}x smaller); save {save_s:.2f} s, restore {restore_s:.2f} s; "
          f"launches {json.dumps(launches)}; restored-vs-saved correlation of the quantized "
          f"leaves {min(corr.values()):.4f} to {max(corr.values()):.4f} (> 0.6); "
          f"{list(probe)} records vs the CPU encode: {n_diff} of {n_codes} codes differ, "
          f"{n_tie} of them ties at Delta (within 1e-6 of it), scales within rtol "
          f"{scale_gap:.2e} (limit 1e-6)")
    check(launches["quantize_pack"] == 1,
          f"the ternary save launched quantize_pack {launches['quantize_pack']} times, want 1")
    check(meta["compressed"] and min(corr.values()) > 0.6, "a restored leaf does not correlate")
    check(n_tie == n_diff and scale_gap <= 1e-6,
          "the card's ternary records differ from the CPU's away from a tie at Delta")
    return {"disk_bytes": disk, "raw_bytes": raw, "save_s": save_s, "restore_s": restore_s,
            "launches": launches, "min_corr": min(corr.values()), "scale_rtol": scale_gap,
            "codes_checked": n_codes, "codes_differing": n_diff, "ties": n_tie}


def _code_ties(state, fcfg, dev) -> tuple[dict, int, int, int]:
    """The QAT forward's codes of ``state`` (on the CPU) computed on the
    CPU and on ``dev``: {param path: mask of the codes that differ}, the
    number of codes, of differing codes and of those that are ties (|θ_s|
    within 1e-6 of Δ, which each device sums in its own order)."""
    from repro_torch.core import fttq
    from repro_torch.tree import flatten_with_path

    wqs = dict(flatten_with_path(state.wq))
    masks, n_codes, n_diff, n_tie = {}, 0, 0, 0
    for path, theta in flatten_with_path(state.params):
        if wqs.get(path) is None:
            continue
        rows = theta.reshape(wqs[path].numel(), -1)
        diff = fttq.row_codes(rows, fcfg.t_k) != fttq.row_codes(rows.to(dev), fcfg.t_k).cpu()
        n_codes += rows.numel()
        n_diff += int(diff.sum())
        if bool(diff.any()):
            masks[path] = diff.reshape(theta.shape)
            denom = fttq.row_denom(rows)
            theta_s = rows / denom
            delta = fttq.row_threshold(fttq.scaled_abs(rows, denom), fcfg.t_k).expand_as(theta_s)
            gap = (theta_s.abs() - delta).abs()[diff]
            n_tie += int((gap <= 1e-6 * delta[diff]).sum())
    return masks, n_codes, n_diff, n_tie


def _update_gaps(new_cpu, new_card) -> dict:
    """One step's results, card against CPU: Adam's m relative to each
    leaf's largest |m|; params relative to each leaf's largest |param|
    where |g| ≥ 1e-6 (|m| ≥ 1e-7), and absolute where |g| < 1e-6, where
    Adam's first update lr·g/(|g| + 1e-8) is ill-conditioned (bound 2·lr;
    a bf16 param's gap there is counted beyond one bf16 ulp of it, the
    rounding of p + u on each device); and the three leaves with the
    largest m gaps."""
    import torch

    from repro_torch.tree import flatten_with_path, path_str

    out = {"m": 0.0, "params": 0.0, "params_small_g": 0.0, "n_small_g": 0}
    card_p = dict(flatten_with_path(new_card.params))
    card_m = dict(flatten_with_path(new_card.opt_state["m"]))
    cpu_m = dict(flatten_with_path(new_cpu.opt_state["m"]))
    per_leaf = []
    for path, p0 in flatten_with_path(new_cpu.params):
        m0 = cpu_m[path]
        m_gap = float((card_m[path].cpu() - m0).abs().max()) / (float(m0.abs().max()) or 1.0)
        per_leaf.append((m_gap, path_str(path)))
        out["m"] = max(out["m"], m_gap)
        d = (card_p[path].cpu() - p0).abs()
        small = m0.abs() < 1e-7
        if bool((~small).any()):
            out["params"] = max(out["params"], float(d[~small].max()) / float(p0.abs().max()))
        if bool(small.any()):
            d_small = d[small].float()
            if p0.dtype == torch.bfloat16:
                # p + u rounds to bf16 on each device: one bf16 ulp of p beyond 2·lr
                ulp = torch.exp2(torch.floor(torch.log2(p0[small].float().abs()
                                                        .clamp_min(2.0 ** -126))) - 7)
                d_small = (d_small - ulp).clamp_min(0)
            out["params_small_g"] = max(out["params_small_g"], float(d_small.max()))
            out["n_small_g"] += int(small.sum())
    out["worst"] = [f"{name} {gap:.1e}" for gap, name in sorted(per_leaf, reverse=True)[:3]]
    return out


TRAIN_CHECK_LIMITS = {"loss": 1e-5, "m": 1e-5, "params": 1e-5, "wq": 1e-5}


def train_card_vs_cpu(dev, cfg, fcfg, tcfg=None, lr: float = TRAIN_LR,
                      limits: dict = TRAIN_CHECK_LIMITS) -> dict:
    """One train step of ``cfg`` at 2 x 128 (``tcfg``, default the
    defaults, adam(``lr``)) from the same seed-0 state on the card (TF32
    off) and through the port's CPU path. The QAT codes of the state are
    counted where the two devices differ, each a tie of |θ_s| with Δ; those
    weights are moved off Δ, and from that state (``limits``, fp32's by
    default): loss within rtol 1e-5, Adam's m within 1e-5 of each leaf's
    largest, params within 1e-5 of each leaf's largest where |g| ≥ 1e-6
    (elsewhere within 2·lr), w_q within 1e-5."""
    import torch

    from repro_torch.data.synthetic import synthetic_tokens, token_batches
    from repro_torch.launch.train import DATA_SEED
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adam
    from repro_torch.train import TrainerConfig, init_train_state, make_train_step
    from repro_torch.train.fault import elastic_reshard
    from repro_torch.tree import flatten_with_path, tree_leaves

    b, s = TRAIN_CHECK_BATCH
    tcfg = tcfg or TrainerConfig()
    opt = adam(lr)
    cpu = torch.device("cpu")
    state = init_train_state(cfg, tcfg, opt, params=init_params(cfg, seed=0, device=cpu),
                             device=cpu)
    # a code that differs between the devices flips one weight of the QAT
    # forward by ±w_q and moves every gradient it feeds: count those ties,
    # then move the tied weights to half their value (code 0 on both
    # devices) so that the step is held on the same codes
    masks, n_codes, n_diff, n_tie = _code_ties(state, fcfg, dev)
    detied = 0
    while masks and detied < 1000:
        params = dict(flatten_with_path(state.params))
        for path, mask in masks.items():
            params[path][mask] *= 0.5
            detied += int(mask.sum())
        masks = _code_ties(state, fcfg, dev)[0]
    check(not masks, "the card's QAT codes still differ after moving the ties off Delta")
    card = elastic_reshard(state, dev)
    batch, _ = next(token_batches(synthetic_tokens(DATA_SEED, b * (s + 1), cfg.vocab_size),
                                  b, s, device=cpu))
    step = make_train_step(cfg, tcfg, opt)
    t0 = time.perf_counter()
    new_cpu, m_cpu = step(state, batch)
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    new_card, m_card = step(card, {k: v.to(dev) for k, v in batch.items()})
    _sync(dev)
    card_s = time.perf_counter() - t0
    gaps = _update_gaps(new_cpu, new_card)
    loss_rel = abs(float(m_card["loss"]) - float(m_cpu["loss"])) / abs(float(m_cpu["loss"]))
    wq_gap = max(float((a.cpu() - c).abs().max()) / float(c.abs().max())
                 for a, c in zip(tree_leaves(new_card.wq), tree_leaves(new_cpu.wq)))
    lim = limits
    print(f"{cfg.name} ({cfg.param_dtype}) cut to {cfg.n_layers} layers, one step at {b} x {s}, "
          f"card vs CPU: loss {float(m_card['loss']):.7f} vs {float(m_cpu['loss']):.7f} (rel "
          f"{loss_rel:.2e}, limit {lim['loss']:.1e}); QAT codes of the seed-0 state differing "
          f"{n_diff} of {n_codes}, {n_tie} of them ties at Delta (within 1e-6 of it), {detied} "
          f"weights moved off Delta; then Adam m gap {gaps['m']:.2e} of max "
          f"({lim['m']:.1e}), params gap {gaps['params']:.2e} of max ({lim['params']:.1e}) "
          f"where |g| >= 1e-6 and {gaps['params_small_g']:.2e} abs over the "
          f"{gaps['n_small_g']} elements below (limit {2 * lr:.0e}); w_q gap "
          f"{wq_gap:.2e} of max ({lim['wq']:.1e}); worst leaves {gaps['worst']}; card step "
          f"{card_s * 1e3:.1f} ms, CPU step {cpu_s * 1e3:.1f} ms")
    check(loss_rel <= lim["loss"], "the card's train step loss differs from the CPU's")
    check(n_tie == n_diff, "a code differs between the card and the CPU away from a tie")
    check(gaps["m"] <= lim["m"] and gaps["params"] <= lim["params"] and wq_gap <= lim["wq"]
          and gaps["params_small_g"] <= 2 * lr,
          "the card's train step update differs from the CPU's")
    return {"loss_card": float(m_card["loss"]), "loss_cpu": float(m_cpu["loss"]),
            "loss_rel": loss_rel, "wq_gap": wq_gap, "codes": n_codes,
            "codes_differing": n_diff, "ties": n_tie, "detied": detied, **gaps,
            "card_ms": card_s * 1e3, "cpu_ms": cpu_s * 1e3}


def _zoo_batch(cfg, b: int, s: int, seed: int) -> dict:
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    out = {}
    if cfg.family == "audio":
        out["embeds"] = (rng.normal(size=(b, s, cfg.d_model)) * 0.02).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    out["labels"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    if cfg.family == "vlm":
        out["vision_embeds"] = (rng.normal(size=(b, cfg.n_patches, cfg.d_model))
                                * 0.02).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in out.items()}


def train_zoo(dev) -> dict:
    """Each of the ten reduced archs takes TRAIN_ZOO_STEPS default steps on
    the card and on the CPU from the same seed-0 state and batches (2 x 16;
    the MoE archs 4 x 16 with microbatches=2; gemma3 with remat "dots"):
    finite losses, each step's card loss within 1e-4 of the CPU's."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import ARCH_IDS, get_reduced
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adam
    from repro_torch.train import TrainerConfig, init_train_state, make_train_step
    from repro_torch.train.fault import elastic_reshard

    out = {}
    cpu = torch.device("cpu")
    for arch in ARCH_IDS:
        cfg = get_reduced(arch, remat="dots" if arch == TRAIN_ZOO_DOTS else "none")
        micro = 2 if cfg.family == "moe" else 1
        tcfg = dataclasses.replace(TrainerConfig(), microbatches=micro)
        opt = adam(3e-3)
        state = init_train_state(cfg, tcfg, opt, params=init_params(cfg, seed=0, device=cpu),
                                 device=cpu)
        if cfg.family == "vlm":     # tanh(0) would silence the cross layers
            for gate in ("gate_attn", "gate_mlp"):
                state.params["cross"][gate].fill_(0.5)
        card = elastic_reshard(state, dev)
        step = make_train_step(cfg, tcfg, opt)
        losses = []
        for i in range(TRAIN_ZOO_STEPS):
            batch = _zoo_batch(cfg, 2 * micro, 16, seed=i)
            state, m_cpu = step(state, batch)
            card, m_card = step(card, {k: v.to(dev) for k, v in batch.items()})
            losses.append((float(m_card["loss"]), float(m_cpu["loss"])))
        gap = max(abs(a - c) for a, c in losses)
        out[arch] = {"losses": losses, "gap": gap, "microbatches": micro, "remat": cfg.remat}
        print(f"  {arch} ({cfg.family}, microbatches {micro}, remat {cfg.remat}): card losses "
              f"{[round(a, 6) for a, _ in losses]}, max |card - CPU| {gap:.2e} (limit 1e-4)")
        check(all(np.isfinite(a) for a, _ in losses), f"{arch}: a non-finite loss on the card")
        check(gap <= 1e-4, f"{arch}: the card's losses differ from the CPU's")
    return out


def train_phase(dev, fcfg, cfg=None, check_cfg=None, runs=TRAIN_RUNS,
                cli_device: str = "cuda") -> dict:
    """(a) the CLI with a resume; (b) olmo-1b at full width; (c) card vs CPU
    on olmo-1b cut to two layers; (d) every family reduced."""
    from repro_torch.configs import get_config

    cfg = cfg or get_config("olmo-1b")
    check_cfg = check_cfg or get_config("olmo-1b", n_layers=TRAIN_CHECK_LAYERS)
    t0 = time.perf_counter()
    out = {"cli": train_cli_check(cli_device)}
    out["full_width"] = train_full_width(dev, cfg, fcfg, runs)
    out["card_vs_cpu"] = train_card_vs_cpu(dev, check_cfg, fcfg)
    out["zoo"] = train_zoo(dev)
    out["phase_s"] = time.perf_counter() - t0
    print(f"train phase: {out['phase_s']:.1f} s")
    return out


# --------------------------------------------------------------------------
# bf16 training: the reference's production train cell on one card.
# --------------------------------------------------------------------------

# configs/shapes.py's train_4k sequence, its batch of 256 cut to 8
BF16_TRAIN_BATCH, BF16_TRAIN_SEQ = 8, 4096
BF16_TRAIN_STEPS = 2
BF16_TRAIN_LR = 1e-4          # launch/dryrun.py's TrainKind: adam(1e-4)
# card vs CPU, one bf16 step of olmo-1b at 2 layers: each device rounds its
# bf16 matmuls' fp32 sums in its own order, one bf16 ulp (2^-8 to 2^-7) apart
# where they differ, and the clip's bf16 scale can round one ulp apart with
# the grad norm. Measured on an H100 80GB HBM3 at 700 W: loss 1.20e-5, m
# 1.38e-2 of a leaf's largest, params 3.65e-3 of a leaf's largest, w_q 0.
BF16_CHECK_LIMITS = {"loss": 2.0 ** -14, "m": 2.0 ** -5, "params": 2.0 ** -7, "wq": 2.0 ** -7}


def bf16_train_cell(n_layers: int | None = None):
    """olmo-1b's train cell as ``launch.dryrun.build_cell`` builds it for
    one device: bf16 params and compute, remat "full", QAT, the arch's
    microbatches (2), adam(1e-4). Returns (cfg, tcfg)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import MICROBATCHES
    from repro_torch.train import TrainerConfig

    cut = {} if n_layers is None else {"n_layers": n_layers}
    cfg = get_config("olmo-1b", param_dtype="bfloat16", compute_dtype="bfloat16", remat="full",
                     **cut)
    return cfg, TrainerConfig(qat=True, microbatches=MICROBATCHES["olmo-1b"])


@contextlib.contextmanager
def _recording(module, name: str, keep, limit: int | None = None):
    """Within the block, ``module.name`` records the arguments and result
    of each call (of the first ``limit``) into ``keep`` (a list) while
    calling through."""
    orig = getattr(module, name)

    def rec(*args, **kw):
        out = orig(*args, **kw)
        if limit is None or len(keep) < limit:
            keep.append((args, kw, out))
        return out

    setattr(module, name, rec)
    try:
        yield keep
    finally:
        setattr(module, name, orig)


def bf16_train_full_width(dev, fcfg, card: str) -> dict:
    """``bf16_train_cell`` at full width, BF16_TRAIN_BATCH x BF16_TRAIN_SEQ,
    BF16_TRAIN_STEPS steps through ``make_train_step`` from the seed-0 state:
    every leaf's dtype; finite losses; exactly one bf16 ``qat_backward``
    launch per quantized leaf per microbatch and no fp32 one; the peak over
    the steps before the last (which records its first microbatch's QAT
    cotangents); the bf16 kernel against its plain version on those
    cotangents, bit for bit (NaNs as NaNs); then a ternary save of the
    params: one quantize_pack launch, its code bytes equal to the plain
    version's on the same segments, its scales within rtol 1e-6."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.core import encode, fttq
    from repro_torch.core.compression import CodecSpec
    from repro_torch.data.synthetic import synthetic_tokens, token_batches
    from repro_torch.kernels.qat_backward import qat_backward_bf16, qat_backward_bf16_plain
    from repro_torch.kernels.quantize_pack import quantize_pack_segments_plain
    from repro_torch.launch.train import DATA_SEED
    from repro_torch.models.transformer import param_count
    from repro_torch.optim import adam
    from repro_torch.train import init_train_state, make_train_step, save_checkpoint
    from repro_torch.tree import tree_leaves

    cfg, tcfg = bf16_train_cell()
    b, s, n_steps = BF16_TRAIN_BATCH, BF16_TRAIN_SEQ, BF16_TRAIN_STEPS
    n_params = param_count(cfg)
    opt = adam(BF16_TRAIN_LR)
    _free()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state = init_train_state(cfg, tcfg, opt, seed=0, device=dev)
    _sync(dev)
    init_s = time.perf_counter() - t0
    dtypes = {name: sorted({str(x.dtype) for x in tree_leaves(tree) if x is not None})
              for name, tree in (("params", state.params), ("wq", state.wq),
                                 ("m", state.opt_state["m"]), ("v", state.opt_state["v"]))}
    n_quant = sum(1 for w in tree_leaves(state.wq) if w is not None)
    step = make_train_step(cfg, tcfg, opt)
    batches = token_batches(synthetic_tokens(DATA_SEED, b * (s + 1) * n_steps, cfg.vocab_size),
                            b, s, device=dev)
    rows, cot = [], []
    zero_counters()
    peak = None
    for i in range(n_steps):
        batch, _ = next(batches)
        last = i == n_steps - 1
        if last:
            _sync(dev)
            peak = torch.cuda.max_memory_allocated()
        with (_recording(fttq, "qat_backward_bf16", cot, n_quant) if last
              else contextlib.nullcontext()):
            _sync(dev)
            t0 = time.perf_counter()
            state, m = step(state, batch)
            _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        rows.append({"ms": ms, "tok_s": b * s / ms * 1e3, "loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"])})
    launches = read_counters()
    ops = 8 * n_params * b * s
    best = min(r["ms"] for r in rows)
    run = {"batch": b, "seq": s, "microbatches": tcfg.microbatches, "remat": cfg.remat,
           "steps": rows, "init_s": init_s, "dtypes": dtypes, "quantized_leaves": n_quant,
           "launches": launches, "peak_bytes": peak, "held_bytes": held,
           "peak_gib": peak / 2 ** 30, "held_gib": held / 2 ** 30,
           "state_bytes": sum(x.numel() * x.element_size() for x in tree_leaves(
               [state.params, state.opt_state["m"], state.opt_state["v"]])),
           "bound_ms": ops / PEAK_BF16_S * 1e3, "operations": ops}
    run["bound_share"] = run["bound_ms"] / best
    want = n_quant * tcfg.microbatches * n_steps
    print(f"{cfg.name} at full width ({n_params} params), bf16 params and compute, remat "
          f"{cfg.remat}, QAT, adam({BF16_TRAIN_LR}), {b} x {s}, microbatches "
          f"{tcfg.microbatches} (card {card}): steps " + "; ".join(
              f"{r['ms']:.1f} ms ({r['tok_s']:.0f} tok/s) loss {r['loss']:.5f} gnorm "
              f"{r['grad_norm']:.4f}" for r in rows)
          + f"; bf16 bound {run['bound_ms']:.1f} ms ({ops:.3e} operations over 989 TFLOP/s), "
          f"{100 * run['bound_share']:.1f}% of it at the best step; peak before the last step "
          f"{run['peak_gib']:.2f} GiB ({run['held_gib']:.2f} GiB held before); leaf dtypes "
          f"{json.dumps(dtypes)}; launches {json.dumps(launches)} (qat_backward_bf16 want "
          f"{want}: {n_quant} quantized leaves x {tcfg.microbatches} microbatches x {n_steps} "
          f"steps)")
    check(dtypes == {"params": ["torch.bfloat16"], "wq": ["torch.bfloat16"],
                     "m": ["torch.float32"], "v": ["torch.float32"]},
          f"the bf16 train state's leaf dtypes are {dtypes}")
    check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in rows),
          "a bf16 train step gave a non-finite loss or grad norm")
    check(int(state.step) == n_steps, f"state.step {int(state.step)} after {n_steps} steps")
    check(launches["qat_backward_bf16"] == want and launches["qat_backward"] == 0,
          f"the bf16 steps launched qat_backward_bf16 {launches['qat_backward_bf16']} times "
          f"(want {want}) and the fp32 entry {launches['qat_backward']} times (want 0)")
    # the kernel against its plain version on the last step's cotangents
    check(len(cot) == n_quant, "the last step's QAT cotangents are missing")
    bad = n = 0
    worst = 0.0
    with torch.no_grad():
        for args, _, got in cot:
            want_out = qat_backward_bf16_plain(*args)
            for a, c in zip(got, want_out):
                bad += _bf16_differing(a, c)
                worst = max(worst, _max_abs_diff(a, c))
            n += args[0].numel()
            del want_out
    del cot
    _free()
    run["cotangent_check"] = {"weights": n, "differ": bad, "max_abs_err": worst}
    print(f"qat_backward_bf16 on the last step's first microbatch ({n_quant} leaves, {n} "
          f"weights): {bad} outputs differ from the plain version")
    check(bad == 0, "qat_backward_bf16 differs from its plain version on the step's cotangents")
    # the ternary save, its one launch held to the plain version
    d = os.path.join(ROOT, "build", "train_smoke_bf16_tern")
    shutil.rmtree(d, ignore_errors=True)
    calls = []
    zero_counters()
    t0 = time.perf_counter()
    with _recording(encode, "quantize_pack_segments", calls):
        save_checkpoint(d, n_steps, state.params,
                        compression=CodecSpec(kind="ternary", fttq=fcfg))
    save_s = time.perf_counter() - t0
    save_launches = read_counters()["quantize_pack"]
    shutil.rmtree(d, ignore_errors=True)
    byte_diff = n_bytes = 0
    scale_rel = 0.0
    for (rows_, scal), kw, (packed, _, scales) in calls:
        p_packed, _, p_scales = quantize_pack_segments_plain(rows_, scal,
                                                             kw.get("with_scales", False))
        byte_diff += int((packed != p_packed).sum())
        n_bytes += packed.numel()
        if scales is not None:
            scale_rel = max(scale_rel, float(((scales - p_scales).abs()
                                              / p_scales.abs().clamp_min(1e-30)).max()))
        seg_dtype = str(rows_[0].dtype)
    del calls
    run["save"] = {"launches": save_launches, "save_s": save_s, "bytes": n_bytes,
                   "bytes_differing": byte_diff, "scale_rtol": scale_rel}
    print(f"ternary save of the bf16 params ({seg_dtype} segments): {save_launches} "
          f"quantize_pack launch(es) in {save_s:.2f} s; {byte_diff} of {n_bytes} code bytes "
          f"differ from the plain version on the same segments, its scales within rtol "
          f"{scale_rel:.2e} (limit 1e-6: fp32 sums of the tiles' moments in another order)")
    check(save_launches == 1, f"the bf16 ternary save launched quantize_pack {save_launches} "
          "times, want 1")
    check(byte_diff == 0 and scale_rel <= 1e-6,
          "the bf16 ternary save's codes or scales differ from the plain version's")
    del state
    _free()
    return run


def _bf16_differing(a, b) -> int:
    """Elements of two bf16 tensors whose bits differ, a NaN of any bits
    matching a NaN (PyTorch writes a NaN's bits by path and device)."""
    import torch

    return int(((a.view(torch.int16) != b.view(torch.int16)) & ~(a.isnan() & b.isnan())).sum())


def qat_backward_bf16_timings(dev) -> dict:
    """The bf16 entry of the QAT backward's kernel on olmo-1b's quantized
    leaves in bf16 (7 stacked leaves, 2^30 weights), a seeded cotangent,
    codes and per-layer factors: timed by CUDA-graph replay beside the
    plain version and its bytes bound (two reads, two writes of 2 B a
    weight); outputs against the plain version leaf by leaf."""
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.fttq import FTTQConfig, is_quantizable
    from repro_torch.kernels.qat_backward import qat_backward_bf16, qat_backward_bf16_plain
    from repro_torch.models.transformer import param_shapes
    from repro_torch.tree import flatten_with_path

    fcfg = FTTQConfig()
    shapes = [shape for path, shape in flatten_with_path(
        param_shapes(get_config("olmo-1b")), is_leaf=lambda x: isinstance(x, tuple))
        if is_quantizable(path, torch.empty(shape, device="meta"), fcfg)]
    gen = torch.Generator(device=dev).manual_seed(43)
    args, bad, worst = [], 0, 0.0
    for shape in shapes:
        rows = shape[0] if len(shape) >= 3 else 1
        g = (torch.randn(rows, math.prod(shape) // rows, generator=gen, device=dev)
             * 1e-3).bfloat16()
        codes = torch.randint(-1, 2, g.shape, generator=gen, device=dev).bfloat16()
        w = (torch.rand(rows, 1, generator=gen, device=dev) * 0.05).bfloat16()
        args.append((g, codes, w))
        for a, c in zip(qat_backward_bf16(g, codes, w), qat_backward_bf16_plain(g, codes, w)):
            bad += _bf16_differing(a, c)
            worst = max(worst, _max_abs_diff(a, c))
        torch.cuda.empty_cache()
    n = sum(a[0].numel() for a in args)
    out = {"leaves": len(args), "weights": n, "differ": bad, "max_abs_err": worst}
    out["ms"] = time_ms(lambda: [qat_backward_bf16(*a) for a in args], 5)
    out["plain_ms"] = time_ms(lambda: [qat_backward_bf16_plain(*a) for a in args], 2)
    nbytes = 8 * n + 2 * sum(a[2].numel() for a in args)
    out["bound_ms"], out["bound_by"] = bound(nbytes, 3 * n)
    del args
    torch.cuda.empty_cache()
    print(f"qat_backward_bf16, {out['leaves']} leaves ({n} bf16 weights): {bad} outputs differ "
          f"from the plain version; kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, "
          f"bound {out['bound_ms']:.4f} ms ({out['bound_by']}, {nbytes} B); library: none")
    check(bad == 0, "qat_backward_bf16 differs from its plain version")
    return out


def bf16_train_phase(dev, fcfg, card: str) -> dict:
    """(a) ``bf16_train_full_width``; (b) one step of its cell cut to
    TRAIN_CHECK_LAYERS layers, card against the port's CPU path, within
    BF16_CHECK_LIMITS; (c) the bf16 QAT backward's timings. The peak is
    held to the dry-run's estimate of the same cell in ``dryrun_finish``."""
    t0 = time.perf_counter()
    out = {"full_width": bf16_train_full_width(dev, fcfg, card)}
    cfg2, tcfg = bf16_train_cell(TRAIN_CHECK_LAYERS)
    out["card_vs_cpu"] = train_card_vs_cpu(dev, cfg2, fcfg, tcfg, BF16_TRAIN_LR,
                                           BF16_CHECK_LIMITS)
    out["qat_backward_bf16"] = qat_backward_bf16_timings(dev)
    out["phase_s"] = time.perf_counter() - t0
    print(f"bf16_train phase: {out['phase_s']:.1f} s")
    return out


# --------------------------------------------------------------------------
# bf16 activations: olmo-1b served with bf16 weights and activations.
# --------------------------------------------------------------------------


def bf16_ulps_apart(y, y_ref, x, packed, wq) -> tuple[int, int]:
    """Outputs of two bf16 results more than one bf16 unit in the last place
    (of the larger magnitude) apart: (beyond the fp32 summation-order
    allowance of two sums of the same exact products, four fp32 ulps of
    Σ|x·w|·w_q, which matters only where a sum cancels far below its terms;
    beyond the one ulp alone)."""
    import torch

    from repro_torch.kernels.pack2bit import unpack2bit_plain

    a, b = y.float(), y_ref.float()
    m = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
    terms = (x.float().abs() @ unpack2bit_plain(packed, torch.float32).abs()) * wq.abs()
    ulp = torch.exp2(torch.floor(torch.log2(m)) - 7)
    return (int(((a - b).abs() > ulp + 2.0 ** -22 * terms).sum()),
            int(((a - b).abs() > ulp).sum()))


def bf16_matmul_bound(m: int, k: int, n: int) -> tuple[float, str, int, int]:
    """The bf16 ternary matmul's bound: bf16 x and out, the packed weights and
    w_q once; 2MKN bf16 operations (bf16 x is one part)."""
    nbytes = k // 4 * n + 2 * (m * k + m * n) + 4
    flops = 2 * m * k * n
    return (*bound(nbytes, flops, PEAK_BF16_S), nbytes, flops)


# the bf16 packed-vs-dequantized logits: 1.606e-2 measured on an H100 80GB
# HBM3 at 700 W, a 2.2x margin
BF16_LOGITS_RTOL = 3.5e-2
BF16_DELTAS = (0.05, 0.3, 0.7, 1.0)    # deltas of the pattern table, each with its bf16 neighbours


def bf16_patterns(dev):
    """Every bf16 bit pattern once (65,536 values: ±0, subnormals, ±inf and
    NaNs among them) and the same with the non-finite patterns set to 0, on
    the card."""
    import torch

    every = torch.arange(65536, dtype=torch.int32, device=dev).to(torch.int16)
    every = every.view(torch.bfloat16)
    return every, torch.where(torch.isfinite(every), every, torch.zeros_like(every))


def bf16_pattern_scalars(dev):
    """(denom, Δ) rows that reach every branch of the bf16 encode: a denom in
    every bf16 binade (a seeded significand each) and 0 and two subnormals,
    against Δ of 0, a subnormal, and each of ``BF16_DELTAS`` with the bf16
    values next to it below and above."""
    import numpy as np
    import torch

    rng = np.random.default_rng(29)
    denoms = [float(np.ldexp(1.0 + rng.integers(0, 128) / 128.0, e)) for e in range(-126, 128)]
    denoms += [0.0, 2.0 ** -133, 7.1e-39]
    deltas = [0.0, 1e-39]
    for d in BF16_DELTAS:
        b = torch.tensor(d).to(torch.bfloat16).view(torch.int16)
        deltas += [float((b - 1).view(torch.bfloat16)), d, float((b + 1).view(torch.bfloat16))]
    return torch.tensor([[dn, dl] for dn in denoms for dl in deltas], dtype=torch.float32,
                        device=dev)


def _same_or_within(got, want) -> float:
    """The largest relative error of ``got`` where ``want`` is finite, or
    inf where ``want`` is not finite and ``got`` is not the same (NaN
    matching NaN)."""
    import torch

    fin = torch.isfinite(want)
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    if not bool(same[~fin].all()):
        return float("inf")
    if not bool(fin.any()):
        return 0.0
    return float(((got[fin] - want[fin]).abs() / want[fin].abs().clamp_min(1e-30)).max())


def quantize_pack_pattern_checks(dev) -> dict:
    """The bf16 quantize_pack kernel on every bf16 bit pattern: one launch
    whose segment table points every row at the same 65,536-value tensor,
    each row with its own (denom, Δ) (``bf16_pattern_scalars``), over all
    patterns and (at the exact deltas) over the finite ones, against the
    plain version: bytes and counts bit for bit, tile sums and scales within
    1e-6 relative where finite and equal where not; then a second call, the
    same bytes and scales. The rows reach the kernel's threshold path
    (normal denom and Δ) and its exact division (Δ of 0 or subnormal, a
    subnormal, zero or huge denom)."""
    import torch

    from repro_torch.kernels.quantize_pack import (
        quantize_pack, quantize_pack_segments, quantize_pack_segments_plain,
    )

    every, finite = bf16_patterns(dev)
    rows = bf16_pattern_scalars(dev)
    # the finite tensor (for the sums) at Δ of 0 and each of BF16_DELTAS, not
    # their neighbours: the codes at the neighbours are the all-pattern rows'
    per_denom = 2 + 3 * len(BF16_DELTAS)
    fin_rows = rows.reshape(-1, per_denom, 2)[:, [0] + [3 + 3 * i for i in range(
        len(BF16_DELTAS))]].reshape(-1, 2)
    segs = [every] * rows.shape[0] + [finite] * fin_rows.shape[0]
    scal = torch.cat([rows, fin_rows])
    before = quantize_pack.launches
    packed, moments, scales = quantize_pack_segments(segs, scal, with_scales=True)
    launched = quantize_pack.launches - before
    again = quantize_pack_segments(segs, scal, with_scales=True)
    p_ref, m_ref, s_ref = quantize_pack_segments_plain(segs, scal, True)
    torch.cuda.synchronize()
    out = {"segments": len(segs), "elements": 65536 * len(segs), "launches": launched,
           "bytes_differ": int((packed != p_ref).sum()),
           "counts_differ": int((moments[:, 1] != m_ref[:, 1]).sum()),
           "sum_rel": _same_or_within(moments[:, 0], m_ref[:, 0]),
           "scale_rel": _same_or_within(scales, s_ref),
           "second_call_bytes_differ": int((again[0] != packed).sum()),
           "second_call_scales_same": bool(((again[2] == scales)
                                            | (torch.isnan(again[2]) & torch.isnan(scales)))
                                           .all())}
    print(f"  quantize_pack bf16 on every bf16 bit pattern: {rows.shape[0]} (denom, delta) rows, "
          f"and {fin_rows.shape[0]} of them on the finite patterns: {len(segs)} segments "
          f"({out['elements']} elements) in {launched} "
          f"launch: {out['bytes_differ']} bytes and {out['counts_differ']} counts differ from "
          f"the plain version, sums max rel err {out['sum_rel']:.3e}, scales "
          f"{out['scale_rel']:.3e}; a second call: {out['second_call_bytes_differ']} bytes "
          f"differ, scales the same: {out['second_call_scales_same']}")
    check(launched == 1 and out["bytes_differ"] == 0 and out["counts_differ"] == 0
          and out["sum_rel"] <= 1e-6 and out["scale_rel"] <= 1e-6
          and out["second_call_bytes_differ"] == 0 and out["second_call_scales_same"],
          "bf16 quantize_pack disagrees with its plain version on the bit-pattern table")
    return out


def fp32_subnormal_sample(dev):
    """A seeded sample of fp32 bit patterns: 2^20 drawn from all 2^32, and
    2^16 subnormals of every magnitude from 2^-149 to 2^-127 (both signs)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(2029)
    any_bits = rng.integers(0, 2 ** 32, 2 ** 20, dtype=np.uint64).astype(np.uint32)
    mant = (np.uint32(1) << rng.integers(0, 23, 2 ** 16).astype(np.uint32))
    mant = mant | (rng.integers(0, 2 ** 23, 2 ** 16, dtype=np.uint64).astype(np.uint32)
                   & (mant - np.uint32(1)))
    sub = mant | (rng.integers(0, 2, 2 ** 16).astype(np.uint32) << np.uint32(31))
    return torch.from_numpy(np.concatenate([any_bits, sub]).view(np.float32)).to(dev)


def window_checks(dev) -> dict:
    """The window below 2^-126 on the card: what ``div.rn.ftz.f32`` (the
    fp32 quantize_pack) and ``mul.rn.ftz.f32`` (the fp32 ternary_quantize)
    give on the exact quotients and products in [2^-126 - 2^-150, KEEP)
    (``dtypes.window_operands``, the tests' enumeration), read off their
    codes at Δ = 0 (0 where flushed, as XLA flushes, ±1 where kept at
    2^-126), and every output of those kernels and of the bf16
    entries on those inputs and their neighbours against the plain
    versions, bit for bit."""
    import numpy as np
    import torch

    from repro_torch.dtypes import window_operands, window_pairs
    from repro_torch.kernels.quantize_pack import (
        quantize_pack_segments, quantize_pack_segments_plain, segment_layout,
    )
    from repro_torch.kernels.ternary_quantize import ternary_quantize, ternary_quantize_plain

    a, b = window_pairs("div")
    n_div = len(window_operands("div")[0])
    out = {"div_window": 0, "div_flushed": 0, "mul_window": 0, "mul_flushed": 0, "differ": 0}
    for dtype in (torch.float32, torch.bfloat16):
        segs, rows, first = [], [], []
        for k in range(1, 128):
            at = np.flatnonzero(np.abs(b) == np.float32(2.0 ** k))
            segs.append(torch.from_numpy(a[at]).to(dtype).to(dev))
            rows.append((2.0 ** k, 0.0))
            first.append(int((at < n_div).sum()))
        scal = torch.tensor(rows, dtype=torch.float32, device=dev)
        packed, moments, _ = quantize_pack_segments(segs, scal)
        p_ref, m_ref, _ = quantize_pack_segments_plain(segs, scal)
        out["differ"] += int((packed != p_ref).sum()) + int(
            (moments.view(torch.uint8) != m_ref.view(torch.uint8)).sum())
        if dtype == torch.float32:
            codes = torch.stack([(packed.cpu() >> s) & 3 for s in (0, 2, 4, 6)], 1).reshape(-1)
            lay = segment_layout([x.numel() for x in segs])
            for at, m in zip(lay.byte_offsets, first):     # the window's first in each
                out["div_window"] += m
                out["div_flushed"] += int((codes[4 * at:4 * at + m] == 1).sum())
    g, s = window_pairs("mul")
    n_mul = len(window_operands("mul")[0])
    for dtype in (torch.float32, torch.bfloat16):
        for i in range(0, n_mul, max(1, n_mul // 64)):
            theta = torch.tensor([g[i], g[i + n_mul], g[i + 2 * n_mul], -g[i]] * 64,
                                 dtype=torch.float32).to(dtype).reshape(4, 64).to(dev)
            it, tt = ternary_quantize(theta, float(s[i]), 0.0, 0.5)
            it_ref, tt_ref = ternary_quantize_plain(theta, float(s[i]), 0.0, 0.5)
            out["differ"] += int((it != it_ref).sum()) + int(
                (tt.view(torch.uint8) != tt_ref.view(torch.uint8)).sum())
            if dtype == torch.float32:
                out["mul_window"] += 1
                out["mul_flushed"] += int(it[0, 0] == 0)
    torch.cuda.synchronize()
    print(f"  window [2^-126 - 2^-150, 2^-126 - 2^-151): div.rn.ftz.f32 flushed "
          f"{out['div_flushed']} of {out['div_window']} exact quotients (XLA flushes all, "
          f"IEEE rounds them to 2^-126), mul.rn.ftz.f32 {out['mul_flushed']} of "
          f"{out['mul_window']} products; quantize_pack and ternary_quantize (fp32, bf16) on "
          f"them and their neighbours: {out['differ']} outputs differ from the plain versions")
    check(out["differ"] == 0 and out["div_flushed"] == out["div_window"] > 0
          and out["mul_flushed"] == out["mul_window"] > 0,
          "the kernels keep a result in the window below 2^-126, or disagree there with "
          "their plain versions")
    return out


def subnormal_checks(dev) -> dict:
    """XLA's subnormal rule on the card: the fp32 quantize_pack on the fp32
    sample at (denom, Δ) pairs with a zero or subnormal Δ or denom and
    normal ones, in one launch, bytes and counts bit for bit against the
    plain version; ternary_quantize on subnormal θ (and the bf16 bit
    patterns) at Δ = 0 and a subnormal inverse scale and w_q, fp32 and bf16,
    codes and θ_t bit for bit."""
    import torch

    from repro_torch.kernels.quantize_pack import (
        quantize_pack, quantize_pack_segments, quantize_pack_segments_plain,
    )
    from repro_torch.kernels.ternary_quantize import ternary_quantize, ternary_quantize_plain

    x = fp32_subnormal_sample(dev)
    pairs = [(0.8125, 0.0), (7.1e-39, 0.5), (1.0, 0.05), (1.7e38, 0.01), (1.0, 1e-39),
             (2.0 ** -126 - 2.0 ** -149, 2.0 ** 100)]
    scal = torch.tensor(pairs, dtype=torch.float32, device=dev)
    before = quantize_pack.launches
    packed, moments, scales = quantize_pack_segments([x] * len(pairs), scal, with_scales=True)
    launched = quantize_pack.launches - before
    p_ref, m_ref, s_ref = quantize_pack_segments_plain([x] * len(pairs), scal, True)
    out = {"fp32_launches": launched, "fp32_bytes_differ": int((packed != p_ref).sum()),
           "fp32_counts_differ": int((moments[:, 1] != m_ref[:, 1]).sum()),
           "fp32_sum_rel": _same_or_within(moments[:, 0], m_ref[:, 0]),
           "fp32_scale_rel": _same_or_within(scales, s_ref)}
    tiny = x[-2 ** 16:].reshape(256, 256)
    every, _ = bf16_patterns(dev)
    bad = 0
    for theta in (tiny, tiny.to(torch.bfloat16), every.reshape(256, 256)):
        for inv, delta, wq in ((1.0, 0.0, 0.5), (3.0, 0.0, 1e-39), (1e-39, 0.0, 0.5),
                               (2.0 ** -100, 0.0, 1.0)):
            it, tt = ternary_quantize(theta, inv, delta, wq)
            it_ref, tt_ref = ternary_quantize_plain(theta, inv, delta, wq)
            bad += int((it != it_ref).sum()) + int((tt.view(torch.uint8)
                                                    != tt_ref.view(torch.uint8)).sum())
    torch.cuda.synchronize()
    out["ternary_quantize_differ"] = bad
    print(f"  subnormals: quantize_pack fp32 on {x.numel()} sampled patterns at {len(pairs)} "
          f"(denom, delta) pairs in {launched} launch: {out['fp32_bytes_differ']} bytes and "
          f"{out['fp32_counts_differ']} counts differ, sums max rel err "
          f"{out['fp32_sum_rel']:.3e}, scales {out['fp32_scale_rel']:.3e}; ternary_quantize on "
          f"subnormal theta (fp32, bf16) and the bf16 patterns: {bad} codes or theta_t bytes "
          "differ")
    check(launched == 1 and out["fp32_bytes_differ"] == 0 and out["fp32_counts_differ"] == 0
          and out["fp32_sum_rel"] <= 1e-6 and out["fp32_scale_rel"] <= 1e-6 and bad == 0,
          "the kernels' subnormal rule disagrees with their plain versions")
    out["window"] = window_checks(dev)
    return out


def quantize_pack_bf16_layout_checks(dev) -> dict:
    """The bf16 quantize_pack on the layouts that leave its whole-tile path:
    a ragged tail, a source aligned to 2 bytes but not to 16, wire bytes at
    an odd offset, and many small segments, in one launch each, against the
    plain version (bytes and counts bit for bit, sums and scales within
    1e-6)."""
    import torch

    from repro_torch.core.encode import leaf_scalars
    from repro_torch.core.fttq import FTTQConfig
    from repro_torch.kernels.quantize_pack import (
        quantize_pack_segments, quantize_pack_segments_plain,
    )

    gen = torch.Generator(dev).manual_seed(31)
    base = torch.randn(3 * 32768 + 1001, generator=gen, device=dev).to(torch.bfloat16)
    cases = {"ragged": [base[:2 * 32768 + 777]], "unaligned": [base[1:]],
             "odd_offset": [base[:9], base[8:8 + 32768 * 2], base[3:40003]],
             "small": [base[i:i + n] for i, n in ((0, 1), (16, 3), (64, 8), (128, 37),
                                                  (256, 4096), (8192, 32768))]}
    worst = {}
    for name, segs in cases.items():
        scal = torch.cat([leaf_scalars(x, FTTQConfig())[0][None] for x in segs])
        packed, moments, scales = quantize_pack_segments(segs, scal, with_scales=True)
        p_ref, m_ref, s_ref = quantize_pack_segments_plain(segs, scal, True)
        bad = int((packed != p_ref).sum()) + int((moments[:, 1] != m_ref[:, 1]).sum())
        rel = max(_same_or_within(moments[:, 0], m_ref[:, 0]),
                  _same_or_within(scales, s_ref))
        worst[name] = {"differ": bad, "rel": rel}
        check(bad == 0 and rel <= 1e-6, f"bf16 quantize_pack disagrees on the {name} layout")
    print(f"  quantize_pack bf16 off the whole-tile path: {json.dumps(worst)}")
    return worst


@contextlib.contextmanager
def device_trace():
    """torch.profiler over the card's activity, opened by one small fill
    kernel that ``traced_kernels`` leaves out: on an H100 a session begun
    after the bit-pattern checks lost its first device event (my chip call
    3), so the fill is that event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").fill_(2.0)
        torch.cuda.synchronize()
        yield prof
        torch.cuda.synchronize()


def traced_kernels(prof, keep=lambda name: True) -> list:
    """The device events of a ``device_trace`` session in launch order,
    without its opening fill, those whose name ``keep`` takes."""
    import torch

    return sorted((e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "FillFunctor" not in e.name and keep(e.name)),
                  key=lambda e: e.time_range.start)


def kernel_name(name: str) -> str:
    """A device kernel's name without its namespace, template and arguments."""
    return name.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]


def device_us(e) -> float:
    return getattr(e, "device_time_total", None) or e.cuda_time_total


def encode_trace(rows, scal, reps: int = 5) -> dict:
    """One deploy encode (``quantize_pack_segments`` over ``rows`` with
    scales, the segment table built and copied inside, as ``core.encode``
    calls it): its eager ms by CUDA events, the device kernels of one call
    under torch.profiler with their device ms, and the host ms of building
    the segment table alone (``segment_table``: the rows, then the copy to
    the card)."""
    import torch

    from repro_torch.kernels.quantize_pack import quantize_pack_segments, segment_table

    out = {"eager_ms": time_ms(lambda: quantize_pack_segments(rows, scal, with_scales=True),
                               reps, graph=False)}
    host = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        segment_table(rows)
        host.append((time.perf_counter() - t0) * 1e3)
    out["table_host_ms"] = sum(host) / reps
    with device_trace() as prof:
        quantize_pack_segments(rows, scal, with_scales=True)
    kernels = traced_kernels(prof, keep=lambda name: "Memcpy" not in name)
    out["device_kernels"] = len(kernels)
    out["kernel_names"] = sorted({kernel_name(e.name) for e in kernels})
    out["device_ms"] = sum(device_us(e) for e in kernels) / 1e3
    return out


def bf16_kernel_checks(dev, rows, scal, served) -> dict:
    """The bf16 kernels against their plain versions on the bf16 model's own
    inputs: quantize_pack_segments over the deploy's 7 bf16 segments in one
    launch (bytes and counts bit for bit, sums and scales within 1e-6
    relative: fp32 order; a second call the same bytes and scales);
    ternary_matmul on bf16 x at every served layer's
    shape at decode (M = 4), prefill (M = 128) and long-prompt (M = 2,048)
    rows, within one bf16 ulp of the plain version (plus the fp32
    summation-order allowance where a sum cancels), the same bits from a
    second call, and bit for bit on one-hot weights."""
    import torch

    from repro_torch.kernels.quantize_pack import (
        quantize_pack, quantize_pack_segments, quantize_pack_segments_plain,
    )
    from repro_torch.kernels.ternary_matmul import (
        launch_shape_bf16, ternary_matmul, ternary_matmul_plain,
    )

    before = quantize_pack.launches
    packed, moments, scales = quantize_pack_segments(rows, scal, with_scales=True)
    launched = quantize_pack.launches - before
    p_ref, m_ref, s_ref = quantize_pack_segments_plain(rows, scal, True)
    torch.cuda.synchronize()
    bad_bytes = int((packed != p_ref).sum())
    bad_counts = int((moments[:, 1] != m_ref[:, 1]).sum())
    sum_rel = float(((moments[:, 0] - m_ref[:, 0]).abs()
                     / m_ref[:, 0].abs().clamp_min(1e-30)).max())
    scale_rel = float(((scales - s_ref).abs() / s_ref.abs().clamp_min(1e-30)).max())
    print(f"  quantize_pack bf16: {len(rows)} segments ({sum(r.numel() for r in rows)} "
          f"elements) in {launched} launch: {bad_bytes} bytes and {bad_counts} counts differ "
          f"from the plain version, sums max rel err {sum_rel:.3e}, scales {scale_rel:.3e}")
    again = quantize_pack_segments(rows, scal, with_scales=True)
    same_again = bool(torch.equal(again[0], packed) and torch.equal(again[2], scales))
    print(f"  quantize_pack bf16: a second call gives the same bytes and scales: {same_again}")
    check(launched == 1 and bad_bytes == 0 and bad_counts == 0 and sum_rel <= 1e-6
          and scale_rel <= 1e-6 and same_again,
          "bf16 quantize_pack_segments disagrees with its plain version or itself")
    del again
    gen = torch.Generator(dev).manual_seed(17)
    shapes = sorted({(w.k, w.packed.shape[1]) for w in _packed_layers(served)})
    worst = 0.0
    for m in (BATCH, BATCH * PROMPT, BF16_LONG_ROWS):
        bad_ulp, over_ulp, n_out, bad_onehot, unequal = 0, 0, 0, 0, 0
        for k, n in shapes:
            x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
            c = torch.randint(0, 3, (k // 4, 4, n), generator=gen, device=dev,
                              dtype=torch.uint8)
            packed_w = c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)
            wq = torch.tensor(0.02, device=dev)
            y, y_ref = ternary_matmul(x, packed_w, wq), ternary_matmul_plain(x, packed_w, wq)
            check(y.dtype == torch.bfloat16, "bf16 ternary_matmul returned another dtype")
            unequal += int((ternary_matmul(x, packed_w, wq) != y).sum())
            bad, over = bf16_ulps_apart(y, y_ref, x, packed_w, wq)
            bad_ulp, over_ulp, n_out = bad_ulp + bad, over_ulp + over, n_out + y.numel()
            worst = max(worst, float((y.float() - y_ref.float()).abs().max()))
            codes = torch.ones(k, n, dtype=torch.uint8, device=dev)
            codes[torch.randint(0, k, (n,), generator=gen, device=dev),
                  torch.arange(n, device=dev)] = 2
            c = codes.reshape(k // 4, 4, n)
            onehot = c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)
            bad_onehot += int((ternary_matmul(x, onehot, wq)
                               != ternary_matmul_plain(x, onehot, wq)).sum())
            del x, c, packed_w, y, y_ref, codes, onehot
        torch.cuda.synchronize()
        print(f"  ternary_matmul bf16 at {len(shapes)} layer shapes x M = {m} (launch shapes "
              f"{[launch_shape_bf16(m, k // 4, n) for k, n in shapes]}): {bad_ulp} of {n_out} "
              f"outputs more than 1 bf16 ulp from the plain version beyond the fp32-order "
              f"allowance ({over_ulp} beyond 1 ulp alone); a second call: {unequal} differ; "
              f"one-hot weights: {bad_onehot} differ")
        check(bad_ulp == 0 and bad_onehot == 0 and unequal == 0,
              f"bf16 ternary_matmul disagrees with its plain version or itself at M = {m}")
    print(f"  ternary_matmul bf16 max abs err {worst:.3e}")
    return {"quantize_pack_sum_rel": sum_rel, "quantize_pack_scale_rel": scale_rel,
            "quantize_pack_max_abs_err": float((moments[:, 0] - m_ref[:, 0]).abs().max()),
            "matmul_max_abs_err": worst, "packed": packed, "scales": scales}


def _packed_layers(served):
    from repro_torch.kernels.repack import PackedTernary
    from repro_torch.tree import tree_leaves

    stacks = tree_leaves(served, is_leaf=lambda x: isinstance(x, PackedTernary))
    return [s.layer(0) for s in stacks if isinstance(s, PackedTernary)]


def bf16_forward_trace(calls) -> dict:
    """One forward's bf16 ternary_matmul calls, eagerly, under torch.profiler:
    the device kernels they launch (one a call: no split-K reduce, no
    workspace, no memset), and the device time a call takes at each layer
    shape beside that call's bound."""
    from repro_torch.kernels.ternary_matmul import ternary_matmul

    with device_trace() as prof:
        for x, p, s, _ in calls:
            ternary_matmul(x, p, s)
    kernels = traced_kernels(prof)
    names = {kernel_name(e.name) for e in kernels}
    per_call = {}
    if len(kernels) == len(calls):
        for e, (x, p, _, _) in zip(kernels, calls):
            row = per_call.setdefault(f"K={x.shape[1]} N={p.shape[1]}",
                                      {"k": x.shape[1], "n": p.shape[1], "calls": 0,
                                       "device_us": 0.0})
            row["calls"] += 1
            row["device_us"] += device_us(e)
        for row in per_call.values():
            row["device_us"] /= row["calls"]
            b_ms, b_by, _, _ = bf16_matmul_bound(calls[0][0].shape[0], row["k"], row["n"])
            row["bound_us"], row["bound_by"] = b_ms * 1e3, b_by
    return {"device_kernels": len(kernels), "kernel_names": sorted(names),
            "per_call": per_call}


def bf16_timings(dev, cfg, served, dense, rows, scal, checked) -> dict:
    """The bf16 kernels' times on the card: the deploy's quantize_pack over
    the 7 bf16 segments as the encode calls it (``encode_trace``: its
    device time by torch.profiler, eager time by CUDA events, the host time
    of the segment table);
    one decode step's and one prefill forward's 112 ternary matmuls on bf16
    x as graph replays, beside their plain versions and ``torch.matmul`` of
    bf16 x with the dequantized bf16 weights; each beside its bound; and
    each forward traced once (``bf16_forward_trace``)."""
    import torch

    from repro_torch.kernels.quantize_pack import (
        quantize_pack_segments, quantize_pack_segments_plain,
    )
    from repro_torch.kernels.ternary_matmul import ternary_matmul, ternary_matmul_plain

    trace = encode_trace(rows, scal)
    check(trace["device_kernels"] == 1, f"one bf16 deploy encode launched "
          f"{trace['device_kernels']} quantize_pack device kernels (want one)")
    timed, _, timed_scales = quantize_pack_segments(rows, scal, with_scales=True)
    check(torch.equal(timed, checked["packed"]) and torch.equal(timed_scales, checked["scales"]),
          "the timed bf16 encode differs")
    del timed, timed_scales
    out = {"quantize_pack": {"ms": trace["device_ms"], **trace}}
    out["quantize_pack"]["plain_ms"] = time_ms(
        lambda: quantize_pack_segments_plain(rows, scal, True), 2, graph=False)
    n = sum(r.numel() for r in rows)
    nbytes = sum(2 * r.numel() + (r.numel() + 3) // 4 + 8 * -(-r.numel() // 32768) + 12
                 for r in rows)
    out["quantize_pack"]["bound_ms"], out["quantize_pack"]["bound_by"] = bound(nbytes, 4 * n)
    out["quantize_pack"]["bytes"] = nbytes
    gen = torch.Generator(dev).manual_seed(23)
    names = [("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
             ("mlp", "w_in"), ("mlp", "w_gate"), ("mlp", "w_out")]
    for label, m in (("decode", BATCH), ("prefill", BATCH * PROMPT)):
        calls = []
        for i in range(cfg.n_layers):
            for a, b in names:
                w = served["blocks"][a][b].layer(i)
                x = torch.randn(m, w.k, generator=gen, device=dev).to(torch.bfloat16)
                calls.append((x, w.packed, w.w_q.reshape(()).float(), dense["blocks"][a][b][i]))
        t = {"ms": time_ms(lambda: [ternary_matmul(x, p, s) for x, p, s, _ in calls], 10),
             "eager_ms": time_ms(lambda: [ternary_matmul(x, p, s) for x, p, s, _ in calls], 10,
                                 graph=False),
             "plain_ms": time_ms(lambda: [ternary_matmul_plain(x, p, s)
                                          for x, p, s, _ in calls], 3),
             "library_ms": time_ms(lambda: [torch.matmul(x, d) for x, _, _, d in calls], 10),
             "launches_per_forward": len(calls)}
        shapes = [bf16_matmul_bound(x.shape[0], x.shape[1], p.shape[1]) for x, p, _, _ in calls]
        t["bytes"], t["flops"] = sum(b[2] for b in shapes), sum(b[3] for b in shapes)
        t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["flops"], PEAK_BF16_S)
        t.update(bf16_forward_trace(calls))
        out[f"ternary_matmul_{label}"] = t
        print(f"ternary_matmul bf16, one {label} forward's {len(calls)} matmuls at M={m}: "
              f"kernel {t['ms']:.4f} ms (eager {t['eager_ms']:.4f} ms), plain "
              f"{t['plain_ms']:.4f} ms, torch.matmul on the dequantized bf16 weights "
              f"{t['library_ms']:.4f} ms ({t['library_ms'] / t['ms']:.2f}x the kernel), bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}); traced eagerly: "
              f"{t['device_kernels']} device kernels for {len(calls)} calls")
        for key, row in t["per_call"].items():
            print(f"  {key}: {row['calls']} calls, {row['device_us']:.2f} us of device "
                  f"time a call, bound {row['bound_us']:.3f} us ({row['bound_by']})")
        check(t["device_kernels"] == len(calls),
              f"one bf16 {label} forward launched {t['device_kernels']} device kernels for "
              f"{len(calls)} ternary_matmul calls (want one each)")
    q = out["quantize_pack"]
    print(f"quantize_pack bf16, the deploy's {len(rows)} segments ({n} weights): device "
          f"{q['device_ms']:.4f} ms ({q['device_kernels']} kernel {q['kernel_names']}, "
          f"profiler), eager {q['eager_ms']:.4f} ms (the "
          f"segment table alone {q['table_host_ms']:.4f} ms of host time), plain "
          f"{q['plain_ms']:.4f} ms, bound {q['bound_ms']:.4f} ms ({q['bound_by']}, {nbytes} B, "
          f"{q['bound_ms'] / max(q['device_ms'], 1e-9):.1%} of it)")
    return out


def bf16_serve_phase(dev, fcfg, fp32: dict) -> dict:
    """olmo-1b at full width with bf16 weights and activations (the CLI's
    ``--dtype bfloat16``), seed 0: its kernels held to their plain versions,
    two deploys (one bf16 quantize_pack launch each), the packed-vs-
    dequantized logits probe, prefill 4 × 32 and 15 greedy steps, beside the
    fp32 serving phase's numbers of the same run; then the bf16 kernels'
    times."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.fttq import is_quantizable
    from repro_torch.launch.serve import generate, packed_logits_check, ternary_deploy
    from repro_torch.models.transformer import init_params
    from repro_torch.tree import flatten_with_path

    cfg = dataclasses.replace(get_config("olmo-1b"), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    params = init_params(cfg, seed=0, device=dev)
    leaves = [leaf for _, leaf in flatten_with_path(params)]
    check(all(leaf.dtype == torch.bfloat16 for leaf in leaves),
          "the bf16 model's parameter tree is not bf16")
    quantizable = [leaf for p, leaf in flatten_with_path(params) if is_quantizable(p, leaf, fcfg)]
    rows, scal = deploy_segments(quantizable, fcfg)
    zero_counters()
    t0 = time.perf_counter()
    served, wire_bytes, _, _ = ternary_deploy(params, fcfg, packed=True, device=dev)
    torch.cuda.synchronize()
    t_deploy = time.perf_counter() - t0
    dense, ref_bytes, _, _ = ternary_deploy(params, fcfg, packed=False, device=dev)
    check(ref_bytes == wire_bytes, "the two bf16 deploys saw different wire artifacts")
    probe = torch.randint(0, cfg.vocab_size, (2, 8),
                          generator=torch.Generator(dev).manual_seed(9), device=dev)
    diff, ref_max = packed_logits_check(cfg, served, dense, probe)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=torch.Generator(dev).manual_seed(1), device=dev)
    tokens, t_prefill, t_decode = generate(cfg, served, prompts, GEN)
    launches = read_counters()
    forwards = 1 + 1 + (GEN - 1)
    per_forward = launches["ternary_matmul"] / forwards
    out = {"wire_bytes": wire_bytes, "deploy_s": t_deploy, "logits_ratio": diff / ref_max,
           "prefill_ms": t_prefill * 1e3, "decode_tok_s": BATCH * (GEN - 1) / t_decode,
           "launches": launches, "ternary_matmul_per_forward": per_forward}
    print(f"bf16 edge checkpoint: {wire_bytes} B on the wire (fp32 model: {fp32['wire_bytes']} "
          f"B); deploy {t_deploy:.2f} s (fp32 {fp32['deploy_s']:.2f} s)")
    print(f"bf16 packed-vs-dequant logits: max |d| = {diff:.3e}, max |logits_ref| = "
          f"{ref_max:.3e}, ratio {diff / ref_max:.3e} (limit {BF16_LOGITS_RTOL:.1e}: the two "
          "paths' bf16 matmul outputs round one ulp apart where their fp32 sums' order "
          "differs, over 16 layers)")
    print(f"bf16 prefill {BATCH}x{PROMPT}: {out['prefill_ms']:.2f} ms (fp32 "
          f"{fp32['prefill_ms']:.2f} ms); decode {out['decode_tok_s']:.1f} tok/s at batch "
          f"{BATCH} (fp32 {fp32['decode_tok_s']:.1f}); ternary_matmul {per_forward:.0f} "
          f"launches per forward (fp32 {fp32['per_forward']}), quantize_pack "
          f"{launches['quantize_pack']} in two deploys")
    check(diff / ref_max <= BF16_LOGITS_RTOL,
          "bf16 packed logits disagree with the dequantized path")
    check(tuple(tokens.shape) == (BATCH, GEN)
          and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          "bf16 serving produced bad tokens")
    check(launches["quantize_pack"] == 2, "bf16 deploys: want one quantize_pack launch each")
    check(launches["ternary_matmul"] == cfg.n_layers * LAYER_MATMULS * forwards,
          f"bf16 serving launched ternary_matmul {launches['ternary_matmul']} times")
    phase("checks: the bf16 kernels against their plain versions (quantize_pack bytes and "
          "counts bit for bit; ternary_matmul within 1 bf16 ulp, one-hot bit for bit)")
    checked = bf16_kernel_checks(dev, rows, scal, served)
    out["checks"] = {k: v for k, v in checked.items() if k not in ("packed", "scales")}
    phase("timings: the bf16 kernels")
    out["timings"] = bf16_timings(dev, cfg, served, dense, rows, scal, checked)
    phase("checks: the bf16 quantize_pack on every bf16 bit pattern and off its whole-tile "
          "path; the subnormal rule of the fp32 quantize_pack and ternary_quantize")
    out["checks"].update(quantize_pack_patterns=quantize_pack_pattern_checks(dev),
                         quantize_pack_layouts=quantize_pack_bf16_layout_checks(dev),
                         subnormals=subnormal_checks(dev))
    del params, served, dense, rows, scal, checked, quantizable, leaves
    _free()
    return out


# --------------------------------------------------------------------------
# Multi-device: two ranks on the one card over gloo.
# --------------------------------------------------------------------------

MD_RANKS = 2                 # the ranks of (a)-(d) and of the tensor_parallel (a)-(c)
MD_WORLD = 4                 # the spawn's ranks: four for the pods x model mesh (2, 1, 2)
# olmo-1b cut in depth so two ranks' training fits 80 GB: at 8 layers the
# two ranks' compressed-step peaks reached 33.68 + 38.21 GiB in one run and
# ran out of the card in the next (an H100 80GB HBM3 at 700 W)
MD_TRAIN_LAYERS = 6
# the two-pod runs against their one-process references: the largest loss
# gap relative to the loss, and the worst leaf's ‖Δparam‖ / ‖param‖ after
# the last step (a planted fault, no gradient sync, must exceed both)
MD_LOSS_RTOL, MD_PARAM_RTOL_L2 = 1e-4, 5e-3
MD_BATCH, MD_SEQ, MD_STEPS = 8, 512, 3
MD_MOE_LAYERS = 2            # qwen3-moe-30b-a3b cut from 48 layers
MD_MOE_TOKENS = (2, 64)
MD_FANIN_UPLOADS = 16
MD_TIMEOUT_S = 900


def _md_device_ms(prof) -> float:
    events = prof.key_averages()
    return sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
               for e in events) / 1e3


def _md_collective(mesh, dev, cfg, fcfg) -> dict:
    """(a) olmo-1b's whole gradient tree (synthetic, seeded per rank)
    through ``ternary_allreduce_tree`` with error feedback: launches, wire
    bytes, wall and device ms; held leaf by leaf to the plain version
    (codes equal except ties at Δ, each proven; means and residuals within
    1e-6 of their largest elsewhere); then the exact fp32 all-reduce."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.transformer import param_count, param_shapes
    from repro_torch.parallel.collectives import (
        all_gather, all_reduce_, compressed_bytes_per_element,
        compressed_leaf, group_rank, leaf_mean_plain, quantize_lastdim_plain, reset_wire_bytes,
        ternary_allreduce_tree, unpack_lastdim_plain, wire_bytes,
    )
    from repro_torch.tree import flatten_with_path, tree_map

    group, me = mesh.group("pod"), group_rank(mesh.group("pod"))
    gen = torch.Generator(dev).manual_seed(100 + me)
    grads = tree_map(lambda s: torch.randn(s, generator=gen, device=dev) * 1e-3,
                     param_shapes(cfg), is_leaf=lambda x: isinstance(x, tuple))
    n = param_count(cfg)
    items = flatten_with_path(grads)
    n_comp = sum(g.numel() for p, g in items if compressed_leaf(p, g, fcfg))
    n_leaves_comp = sum(1 for p, g in items if compressed_leaf(p, g, fcfg))
    _sync(dev)
    zero_counters()
    reset_wire_bytes()
    t0 = time.perf_counter()
    synced, res = ternary_allreduce_tree(grads, group, cfg=fcfg)
    _sync(dev)
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches, wires = read_counters(), wire_bytes()
    del synced, res
    _free()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        synced, res = ternary_allreduce_tree(grads, group, cfg=fcfg)
        _sync(dev)
        traced_ms = (time.perf_counter() - t0) * 1e3
    device_ms = _md_device_ms(prof) if dev.type == "cuda" else float("nan")
    del prof
    out = {"elements": n, "compressed_elements": n_comp, "compressed_leaves": n_leaves_comp,
           "wall_ms": wall_ms, "traced_wall_ms": traced_ms, "device_ms": device_ms,
           "launches": launches, "wire": wires,
           "want_gather_bytes": int(n_comp * compressed_bytes_per_element(MD_RANKS))
           + 4 * n_leaves_comp * (MD_RANKS - 1)}
    flips = ties = 0
    mean_gap = res_gap = 0.0
    for (path, g), s_k, r_k in zip(items, [x for _, x in flatten_with_path(synced)],
                                   [x for _, x in flatten_with_path(res)]):
        xs = list(all_gather(g, group).unbind(0))
        comp = compressed_leaf(path, g, fcfg)
        mean_p, _ = leaf_mean_plain(xs, t_k=fcfg.t_k, compressed=comp)
        if not comp:
            mean_gap = max(mean_gap, float((s_k - mean_p).abs().max()
                                           / mean_p.abs().max().clamp_min(1e-30)))
            continue
        packed_p, wq_p, recon_p = quantize_lastdim_plain(g.to(torch.float32), fcfg.t_k)
        codes_p = unpack_lastdim_plain(packed_p)
        codes_k = torch.round((g - r_k) / wq_p)
        flip = codes_k != codes_p
        mine = int(flip.sum())
        if mine:
            absg = g.abs()
            mx = absg.max() + 1e-12
            delta = fcfg.t_k * absg.mean() / mx
            gap = ((g[flip] / mx).abs() - delta).abs()
            ties += int((gap <= 1e-6 * delta).sum())
        flips += mine
        anywhere = all_gather(flip.to(torch.uint8), group).any(0).to(torch.bool)
        keep = ~anywhere
        mean_gap = max(mean_gap, float((s_k - mean_p)[keep].abs().max()
                                       / mean_p.abs().max().clamp_min(1e-30)))
        nres_p = g - recon_p
        res_gap = max(res_gap, float((r_k - nres_p)[~flip].abs().max()
                                     / nres_p.abs().max().clamp_min(1e-30)))
        del xs, mean_p, packed_p, recon_p, codes_p, codes_k, flip, anywhere, nres_p
    out.update(code_flips=flips, proven_ties=ties, mean_rel_gap=mean_gap,
               residual_rel_gap=res_gap)
    del synced, res
    _free()
    if dev.type == "cuda" and me == 0:        # timed on one rank while the other waits
        out["quantize_pack_alone"] = _md_quantize_pack_alone(dev, cfg, fcfg, items)
    torch.distributed.barrier(group=group)
    reset_wire_bytes()
    _sync(dev)
    t0 = time.perf_counter()
    for _, g in items:
        all_reduce_(g, group, mean=True)
    _sync(dev)
    out["exact_wall_ms"] = (time.perf_counter() - t0) * 1e3
    out["exact_wire"] = wire_bytes()
    del grads, items
    _free()
    return out


def _md_quantize_pack_alone(dev, cfg, fcfg, items) -> dict:
    """The collective's one quantize_pack launch timed alone (eager, as the
    collective calls it) beside its plain version and its bound: on the
    compressed leaves of ``items`` whole (each a segment), and on one rank's
    shards of them over a "model" axis of 2 (the tensor-parallel layout)."""
    from repro_torch.launch.mesh import AXES, MeshSpec
    from repro_torch.kernels.quantize_pack import (
        quantize_pack_segments, quantize_pack_segments_plain,
    )
    from repro_torch.parallel.collectives import collective_scalars, compressed_leaf
    from repro_torch.parallel.sharding import model_dims
    from repro_torch.tree import flatten_with_path

    dims = dict(flatten_with_path(model_dims(cfg, MeshSpec((1, 1, TP_RANKS), AXES))))
    comp = [(p, g) for p, g in items if compressed_leaf(p, g, fcfg)]
    layouts = {"whole": [g.reshape(-1) for _, g in comp],
               "shard": [g.chunk(TP_RANKS, dims[p])[0].contiguous().reshape(-1)
                         if dims.get(p) is not None else g.reshape(-1) for p, g in comp]}
    out = {}
    for name, flat in layouts.items():
        scal = collective_scalars(flat, fcfg.t_k)
        n = sum(f.numel() for f in flat)
        nbytes = sum(4 * f.numel() + (f.numel() + 3) // 4 + 8 * -(-f.numel() // 32768) + 12
                     for f in flat)
        b_ms, b_by = bound(nbytes, 4 * n)
        out[name] = {
            "segments": len(flat), "elements": n,
            "ms": time_ms(lambda: quantize_pack_segments(flat, scal, with_scales=True), 5,
                          graph=False),
            "plain_ms": time_ms(lambda: quantize_pack_segments_plain(flat, scal, True), 2,
                                graph=False),
            "bound_ms": b_ms, "bound_by": b_by}
    del layouts
    _free()
    return out


def _md_fanin(dev, mesh_data) -> dict:
    """(c) ResNet18*'s 52 segments from 16 uploads, sharded 8 per rank:
    one aggregate and one vote launch per rank, against the one-launch
    fold of all 16."""
    import torch

    from repro_torch.kernels.aggregate import packed_weighted_sum_segments
    from repro_torch.kernels.vote import packed_vote_counts_segments
    from repro_torch.parallel.fanin import fanin_vote_counts_segments, fanin_weighted_sum_segments

    layout = [(b, 4 * b) for b in resnet_segment_bytes()]
    table, staged, coeffs, weights = fanin_case(layout, MD_FANIN_UPLOADS,
                                                torch.Generator(dev).manual_seed(21), dev)
    zero_counters()
    got = fanin_weighted_sum_segments(staged, coeffs, table, mesh=mesh_data)
    got_v = fanin_vote_counts_segments(staged, weights, table, mesh=mesh_data)
    _sync(dev)
    launches = read_counters()
    ref = packed_weighted_sum_segments(staged, coeffs, table)
    ref_v = packed_vote_counts_segments(staged, weights, table)
    return {"launches": launches, "segments": table.n_segments,
            "sum_rel_gap": float((got - ref).abs().max() / ref.abs().max()),
            "vote_rel_gap": float((got_v - ref_v).abs().max() / ref_v.abs().max())}


def _md_moe(dev, mesh_ep, moe_cfg) -> dict:
    """(d) qwen3-moe at its published widths, cut in depth, EP 2 over the
    "model" axis: the a2a forward at drop-free capacity against the scatter
    dispatch (``moe.py``) on the same tokens, and the int8 wire against the
    plain wire."""
    import dataclasses

    import torch

    from repro_torch.models.transformer import forward, init_params
    from repro_torch.parallel.collectives import reset_wire_bytes, set_mesh, wire_bytes

    cfg_g = dataclasses.replace(moe_cfg, moe_impl="gspmd")
    cfg_a = dataclasses.replace(moe_cfg, moe_impl="a2a", moe_wire="bf16")
    cfg_q = dataclasses.replace(cfg_a, moe_wire="int8")
    params = init_params(cfg_g, seed=0, device=dev)
    toks = torch.randint(0, moe_cfg.vocab_size, MD_MOE_TOKENS,
                         generator=torch.Generator(dev).manual_seed(5), device=dev)
    out = {}
    with torch.no_grad(), set_mesh(mesh_ep):
        for name, cfg in (("scatter", cfg_g), ("a2a", cfg_a), ("a2a_int8", cfg_q)):
            reset_wire_bytes()
            _sync(dev)
            t0 = time.perf_counter()
            logits, _, _ = forward(cfg, params, toks)
            _sync(dev)
            out[name] = {"ms": (time.perf_counter() - t0) * 1e3,
                         "a2a_bytes": wire_bytes().get("all_to_all", 0), "logits": logits}
    lg, la, lq = (out[k].pop("logits") for k in ("scatter", "a2a", "a2a_int8"))
    out["a2a_rel_gap"] = float((la - lg).abs().max() / lg.abs().max())
    out["int8_rel_l2"] = float(torch.linalg.vector_norm(la - lq)
                               / (torch.linalg.vector_norm(la) + 1e-9))
    del params, lg, la, lq
    _free()
    return out


def _md_train(mesh, dev, cfg, batch: int, seq: int, steps: int) -> dict:
    """(b) olmo-1b at full width cut in depth, TrainerConfig defaults,
    adam(3e-4), the global batch split over the pods: ``steps`` compressed
    steps and ``steps`` exact ones (per step ms and loss, launches, wire
    bytes, peak memory); then, on rank 0 alone, the one-process emulation
    (both pods' halves, the plain collective) and the single-process
    full-batch step from the same state, each held to its run's losses and
    final params, and a planted fault (no gradient sync) held to the
    full-batch step by the same measures."""
    import torch

    from repro_torch.data.synthetic import synthetic_tokens, token_batches
    from repro_torch.launch.train import DATA_SEED
    from repro_torch.optim import adam
    from repro_torch.parallel.collectives import reset_wire_bytes, wire_bytes
    from repro_torch.train import TrainerConfig, init_train_state, make_train_step

    tokens = synthetic_tokens(DATA_SEED, batch * (seq + 1) * steps, cfg.vocab_size)
    gen = token_batches(tokens, batch, seq, device=dev)
    batches = [next(gen)[0] for _ in range(steps)]
    out = {"layers": cfg.n_layers, "batch": batch, "seq": seq}
    final = {}
    for name, compressed in (("compressed", True), ("exact", False)):
        tcfg = TrainerConfig(pod_compression=compressed, error_feedback=True)
        opt = adam(TRAIN_LR)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        state = init_train_state(cfg, tcfg, opt, seed=0, device=dev, n_pods=MD_RANKS, mesh=mesh)
        step = make_train_step(cfg, tcfg, opt, mesh=mesh)
        zero_counters()
        reset_wire_bytes()
        rows = []
        for b in batches:
            _sync(dev)
            t0 = time.perf_counter()
            state, m = step(state, b)
            _sync(dev)
            rows.append({"ms": (time.perf_counter() - t0) * 1e3, "loss": float(m["loss"])})
        out[name] = {"steps": rows, "launches": read_counters(), "wire": wire_bytes(),
                     "peak_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                                  if dev.type == "cuda" else float("nan"))}
        final[name] = _host_tree(state.params)
        del state, step
        _free()
    torch.distributed.barrier(group=mesh.group("pod"))
    if mesh.index("pod") == 0:
        losses = {k: [r["loss"] for r in out[k]["steps"]] for k in final}
        out["emulation"] = _md_train_emulation(dev, cfg, batches, losses["compressed"],
                                               final["compressed"])
        out["single"], single_params = _md_train_single(dev, cfg, batches, losses["exact"],
                                                        final["exact"])
        out["fault"] = _md_train_fault(dev, cfg, batches, out["single"]["losses"],
                                       single_params)
        del single_params
    del final
    torch.distributed.barrier(group=mesh.group("pod"))
    return out


def _host_tree(tree):
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def _md_gaps(dev, losses, ref_losses, params, ref_params, start=None) -> dict:
    """The largest loss gap over the steps relative to the reference's
    loss; after the last step the worst leaf's max |Δparam| over its largest
    reference |param|, and the worst leaf's ‖Δparam‖ over its reference
    ‖param‖; with ``start`` (the params both runs began from) also the
    worst leaf's ‖Δparam‖ over the reference's update ‖param − start‖."""
    import torch

    from repro_torch.tree import tree_leaves

    worst, worst_l2, worst_upd = 0.0, 0.0, 0.0
    starts = tree_leaves(start) if start is not None else [None] * len(tree_leaves(params))
    for a, b, a0 in zip(tree_leaves(params), tree_leaves(ref_params), starts):
        d, b = (a.to(dev) - b.to(dev)).float(), b.to(dev).float()
        worst = max(worst, float(d.abs().max() / b.abs().max().clamp_min(1e-30)))
        worst_l2 = max(worst_l2, float(torch.linalg.vector_norm(d)
                                       / torch.linalg.vector_norm(b).clamp_min(1e-30)))
        if a0 is not None:
            upd = torch.linalg.vector_norm(b - a0.to(dev).float())
            worst_upd = max(worst_upd, float(torch.linalg.vector_norm(d)
                                             / upd.clamp_min(1e-30)))
    out = {"loss_rel_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
           "param_rel_gap": worst, "param_rel_l2": worst_l2}
    if start is not None:
        out["update_rel_l2"] = worst_upd
    return out


def _md_train_emulation(dev, cfg, batches, losses, params) -> dict:
    """Both pods' halves in one process with the plain collective
    (``pods_mean_plain``), the compressed run's losses and params held to
    it."""
    import torch

    from repro_torch.optim import adam
    from repro_torch.parallel.collectives import pods_mean_plain
    from repro_torch.train import TrainerConfig, init_train_state
    from repro_torch.train.trainer import _apply_grads, _local_grads
    from repro_torch.tree import tree_leaves, tree_map

    tcfg, opt = TrainerConfig(pod_compression=True, error_feedback=True), adam(TRAIN_LR)
    state = init_train_state(cfg, tcfg, opt, seed=0, device=dev, n_pods=MD_RANKS)
    got = []
    with torch.no_grad():
        for b in batches:
            half = {k: v.chunk(MD_RANKS) for k, v in b.items()}
            parts = [_local_grads(cfg, tcfg, state, {k: v[i] for k, v in half.items()})
                     for i in range(MD_RANKS)]
            res = [tree_map(lambda r: r[i], state.residuals) for i in range(MD_RANKS)]
            g_p, new_res = pods_mean_plain([p[2] for p in parts], cfg=tcfg.fttq,
                                           residuals_per_pod=res)
            it = iter([sum(ws) / MD_RANKS for ws in zip(*(tree_leaves(p[3]) for p in parts))])
            g_w = tree_map(lambda _: next(it), state.wq)
            loss = sum(p[0] for p in parts) / MD_RANKS
            metrics = {k: sum(p[1][k] for p in parts) / MD_RANKS for k in parts[0][1]}
            del parts, res
            state, m = _apply_grads(tcfg, opt, state, loss, metrics, g_p, g_w,
                                    _stack_pods(new_res))
            got.append(float(m["loss"]))
            del g_p, new_res, g_w
    out = {"losses": got, **_md_gaps(dev, losses, got, params, state.params)}
    del state
    _free()
    return out


def _stack_pods(trees):
    import torch

    from repro_torch.tree import tree_leaves, tree_map

    leaves = [tree_leaves(t) for t in trees]
    it = iter([torch.stack(rs) for rs in zip(*leaves)])
    return tree_map(lambda _: next(it), trees[0])


def _md_train_single(dev, cfg, batches, losses, params) -> tuple[dict, object]:
    """The exact run's losses and params held to one process stepping the
    whole global batch; also returns that process's params (on the host)."""
    from repro_torch.optim import adam
    from repro_torch.train import TrainerConfig, init_train_state, make_train_step

    tcfg, opt = TrainerConfig(pod_compression=False), adam(TRAIN_LR)
    state = init_train_state(cfg, tcfg, opt, seed=0, device=dev)
    step = make_train_step(cfg, tcfg, opt)
    got = []
    for b in batches:
        state, m = step(state, b)
        got.append(float(m["loss"]))
    out = {"losses": got, **_md_gaps(dev, losses, got, params, state.params)}
    ref = _host_tree(state.params)
    del state
    _free()
    return out, ref


def _md_train_fault(dev, cfg, batches, losses, params) -> dict:
    """A planted fault, to show the limits catch one: the pods skip the
    gradient sync, so each steps on its own half of the batch (the logged
    loss still the pods' mean). Held to the single-process full-batch run
    as the exact run is; both gaps must exceed their limits."""
    from repro_torch.optim import adam
    from repro_torch.train import TrainerConfig, init_train_state, make_train_step

    tcfg, opt = TrainerConfig(pod_compression=False), adam(TRAIN_LR)
    step = make_train_step(cfg, tcfg, opt)
    per_pod, pod0 = [], None
    for p in range(MD_RANKS):
        state = init_train_state(cfg, tcfg, opt, seed=0, device=dev)
        got = []
        for b in batches:
            state, m = step(state, {k: v.chunk(MD_RANKS)[p] for k, v in b.items()})
            got.append(float(m["loss"]))
        per_pod.append(got)
        if p == 0:
            pod0 = _host_tree(state.params)
        del state
        _free()
    mean = [sum(ls) / MD_RANKS for ls in zip(*per_pod)]
    return {"losses": mean, **_md_gaps(dev, mean, losses, pod0, params)}


# --------------------------------------------------------------------------
# Tensor parallelism: two ranks on the "model" axis, and pods x model on four.
# --------------------------------------------------------------------------

TP_RANKS = 2                 # the "model" axis of (a)-(c): mesh (1, 2) over (data, model)
# 2 steps (cut from 3 for the script's time): the loss gaps of the planted
# faults of (a) and (j) pass their limit at the first and the second step
TP_BATCH, TP_SEQ, TP_STEPS = 8, 512, 2
TP_PROMPTS, TP_PROMPT, TP_GEN = 4, 32, 8
TP_LOGITS_REL = 1e-4         # prefill and decode logits, of max |logits|
# the TP run against one process differs only in summation order, and the
# planted fault (FTTQ statistics per shard) flips ~1e-4 of the codes: the
# multi-pod loss rtol MD_LOSS_RTOL (1e-4) sits on the fault's own gap
# (1.008e-4 and 9.79e-5 in runs on an H100 80GB HBM3 at 700 W), so the loss
# is held tighter, halfway (in log) between the sound runs' 2.4e-5-2.6e-5
# and the fault's; the params keep MD_PARAM_RTOL_L2
TP_LOSS_RTOL = 5e-5
TP_SAVE_BYTES = 680_526_658  # olmo-1b's ternary checkpoint, as the train phase saves it
# (a)-(c) and the fsdp part's (j), (m), (n): olmo-1b at its published widths
# cut to 4 of 16 layers (8 to make room for the bf16_train phase, then 4
# for the bf16_mesh phase) in the script's time; at 16 layers they are
# also held to the full-width bytes TP_SAVE_BYTES, FSDP_STATE_BYTES and
# FSDP_GATHER_BYTES
TP_OLMO_LAYERS = 4
FSDP_OLMO_LAYERS = 4
TP_PODS_LAYERS = 4           # (d): olmo-1b cut to 4 of 16 layers on mesh (2, 1, 2)
TP_PODS_STEPS = 2
# (f) qwen3-moe-30b-a3b cut from 48 layers: at 2 layers (1.87 B params) a TP
# rank's step peaked past 36 GiB (params, both Adam moments old and new,
# gradients and updates) and two ranks ran out of the 80 GB; at 1 layer
# (1.25 B) the ranks and then one process fit
TP_MOE_LAYERS = 1
# (e) and (h) zamba2-1.2b cut from 38 layers so that the script fits its
# limit, keeping two applications of the shared block (layers 0 and 6): at
# 38 layers the cell took ~194 s of a 922.9 s script, at 12 layers 90.3 s of
# a 1,129.6 s one (an H100 80GB HBM3 at 700 W)
TP_ZAMBA_LAYERS = 7
TP_PODS_MOE_LAYERS = 1       # (i): qwen3-moe-30b-a3b's gradient tree on four ranks
TP_TWIN_NOISE = 1e-7         # the noise twin's relative weight noise (``_tp_twin``)
# (r) qwen3-moe-30b-a3b cut to 1 of 48 layers as (f), the all-to-all MoE
# with EP over "model": at capacity 16 a queue of C_send = T·k / 2 · 16 and a
# local expert's C_loc = 2·C_send / 64 = 2·T slots hold every copy (E_loc =
# 64, k = 8), so the a2a step computes the scatter dispatch's function
TP_A2A_LAYERS = 1
TP_A2A_TOKENS = (2, 128)
TP_A2A_CF = 16.0
TP_A2A_INT8_REL_L2 = 0.05    # the int8 wire's forward against the plain wire's
TP_A2A_LEAVES = ("blocks/moe/w_in", "blocks/moe/w_gate", "blocks/moe/w_out",
                 "blocks/moe/router")


def _peak_gib(dev) -> float:
    import torch

    return torch.cuda.max_memory_allocated() / 2 ** 30 if dev.type == "cuda" else float("nan")


def _tp_codes(whole, fcfg, sh) -> tuple[dict, dict]:
    """The QAT codes of this rank's shards of ``whole`` (cut as ``sh``, a
    ``parallel.tensor.Shards``, says: over "model", "data" or both) from
    the whole leaves' statistics (``leaf_row_stats`` over those axes)
    against the whole leaves' codes cut to the same shard: the differing
    codes, each counted as a tie where |θ_s| is within 1e-6 of Δ (as
    ``_code_ties`` counts them), and {param path: mask of the differing
    codes in the shard}."""
    from repro_torch.core import fttq
    from repro_torch.tree import flatten_with_path, path_str

    def cut(t, c):
        for ax, d in c:
            t = t.chunk(ax.size, d)[ax.rank]
        return t.contiguous()

    masks, n_codes, n_diff, n_tie = {}, 0, 0, 0
    for path, leaf in flatten_with_path(whole):
        c = sh.cuts.get(path_str(path), ())
        if not fttq.is_quantizable(path, leaf, fcfg) or not c:
            continue
        n_rows = leaf.shape[0] if leaf.ndim >= 3 else 1
        want = cut(fttq.row_codes(leaf.reshape(n_rows, -1), fcfg.t_k).reshape(leaf.shape), c)
        shard = cut(leaf, c)
        rows = shard.reshape(n_rows, -1)
        (denom, delta), = fttq.leaf_row_stats([rows], fcfg.t_k, [sh.axes(path_str(path))])
        theta_s = rows / denom
        diff = fttq.scaled_codes(rows, denom, delta).reshape(shard.shape) != want
        n_codes += diff.numel()
        n_diff += int(diff.sum())
        masks[path] = diff
        if bool(diff.any()):
            gap = (theta_s.abs() - delta).abs()
            n_tie += int((gap <= 1e-6 * delta.expand_as(gap))[diff.reshape(n_rows, -1)].sum())
        del want, shard, rows, theta_s
    return {"codes": n_codes, "differing": n_diff, "ties": n_tie}, masks


def _tp_detie(mesh, dev, cfg, fcfg) -> tuple[dict, object]:
    """The seed-0 params with the weights whose shard code differs from the
    whole leaf's (each a tie at Δ, which the two sum in their own orders)
    moved to half their value, until no code differs: so the sharded run
    and one process train the same QAT codes (``train_card_vs_cpu`` does
    the same between the card and the CPU). Returns (the first count of
    codes, differing codes and ties, plus the weights moved; the whole
    params)."""
    import torch

    from repro_torch.models.transformer import init_params
    from repro_torch.parallel.collectives import all_gather
    from repro_torch.parallel.tensor import SHARD_AXES, mesh_axis, param_shards, reduce_over
    from repro_torch.tree import flatten_with_path, path_str

    sh = param_shards(cfg, mesh)
    every = tuple(a for a in (mesh_axis(mesh, n) for n in SHARD_AXES) if a is not None)
    whole = init_params(cfg, seed=0, device=dev)
    report, masks = _tp_codes(whole, fcfg, sh)
    leaves, moved = dict(flatten_with_path(whole)), 0
    for _ in range(10):
        flips = torch.tensor([float(m.sum()) for m in masks.values()], device=dev)
        if float(reduce_over([flips], [every])[0].sum()) == 0:
            break
        for path, mask in masks.items():
            full = mask.to(torch.uint8)
            for ax, d in reversed(sh.cuts[path_str(path)]):
                full = torch.cat(list(all_gather(full.contiguous(), ax.group)), dim=d)
            leaves[path][full.bool()] *= 0.5
            moved += int(full.sum())
        masks = _tp_codes(whole, fcfg, sh)[1]
    report["moved"] = moved
    report["left"] = int(sum(int(m.sum()) for m in masks.values()))
    del masks
    _free()
    return report, whole


@contextlib.contextmanager
def _gloo_clock():
    """{"ms": host ms spent inside torch.distributed's all_reduce,
    all_gather and all_to_all_single (the reduce-scatter's on gloo)} while
    the block runs (wrappers around the three calls)."""
    import torch.distributed as dist

    box = {"ms": 0.0}
    saved = {name: getattr(dist, name) for name in ("all_reduce", "all_gather",
                                                    "all_to_all_single")}

    def timed(fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                box["ms"] += (time.perf_counter() - t0) * 1e3
        return call

    for name, fn in saved.items():
        setattr(dist, name, timed(fn))
    try:
        yield box
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


@contextlib.contextmanager
def _maybe_profile(dev, on: bool):
    """torch.profiler over the block where ``on`` (CPU and CUDA activity),
    else nothing; yields the profiler or None."""
    if not on:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        yield prof


@contextlib.contextmanager
def _route_hashes():
    """[sha256 of each MoE layer's top-k expert indices] while the block
    runs (a wrapper of ``models.moe.route``)."""
    import hashlib

    from repro_torch.models import moe as moe_mod

    seen, route = [], moe_mod.route

    def recording(probs, k):
        gates, idx = route(probs, k)
        seen.append(hashlib.sha256(idx.cpu().numpy().tobytes()).hexdigest())
        return gates, idx

    moe_mod.route = recording
    try:
        yield seen
    finally:
        moe_mod.route = route


def _tp_train(mesh, dev, cfg, batches, fcfg, params, save_dir: str | None = None,
              trace: bool = False, route_check: bool = False,
              train=None) -> tuple[dict, object]:
    """TrainerConfig defaults and adam(3e-4) (``train``: another
    (TrainerConfig, lr)) over the mesh's "model" and
    "data" axes from ``params`` (whole leaves, cut to the rank's shards):
    the bytes of the rank's params and Adam moments; per step the
    synchronized ms, tokens/s, loss, the ms the rank spent inside ``gloo``'s
    collective calls (the staging copies to and from pinned memory not
    included) and its wire bytes (the modelled bytes it received); with
    ``trace`` the last step under torch.profiler for the device's kernel
    time (its ms is then a traced wall); the rank's peak memory, launches
    and wire bytes over the run; with ``route_check`` the MoE layers'
    routing in the first step, hashed and compared across the model group;
    with ``save_dir`` the trained params saved as a ternary checkpoint from
    the shards (gathered, written by the mesh's first rank: one
    quantize_pack launch there), and with ``train`` the save's codes and
    scales against the plain version on the same segments. Returns (report,
    the gathered params on the host at the mesh's first rank, else
    None)."""
    import torch

    from repro_torch.core import encode
    from repro_torch.core.compression import CodecSpec
    from repro_torch.optim import adam
    from repro_torch.parallel.collectives import reset_wire_bytes, wire_bytes
    from repro_torch.parallel.sharding import param_specs
    from repro_torch.parallel.tensor import gather_tree
    from repro_torch.train import TrainerConfig, init_train_state, make_train_step, save_checkpoint
    from repro_torch.tree import tree_leaves, tree_map

    specs = param_specs(cfg, mesh)
    tcfg, lr = train or (TrainerConfig(), TRAIN_LR)
    opt = adam(lr)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
    t0 = time.perf_counter()
    state = init_train_state(cfg, tcfg, opt, params=tree_map(lambda t: t.to(dev), params),
                             device=dev, mesh=mesh)
    _sync(dev)
    out = {"init_s": time.perf_counter() - t0, "state_bytes": sum(
        x.numel() * x.element_size() for tree in (state.params, state.opt_state["m"],
                                                  state.opt_state["v"])
        for x in tree_leaves(tree)), "held_bytes": held,
        "quantized_leaves": sum(1 for w in tree_leaves(state.wq) if w is not None)
        if state.wq is not None else 0,
        "dtypes": sorted({str(x.dtype) for x in tree_leaves(state.params)})}
    step = make_train_step(cfg, tcfg, opt, mesh=mesh)
    zero_counters()
    rows, total = [], collections.Counter()
    for i, b in enumerate(batches):
        traced = trace and i == len(batches) - 1
        routes = _route_hashes() if route_check and i == 0 else contextlib.nullcontext([])
        with _gloo_clock() as gloo, _maybe_profile(dev, traced) as prof, routes as hashes:
            _sync(dev)
            reset_wire_bytes()
            t0 = time.perf_counter()
            state, m = step(state, b)
            _sync(dev)
            ms = (time.perf_counter() - t0) * 1e3
            total.update(wire_bytes())
        if hashes:
            import torch.distributed as dist

            every = [None] * mesh.size("model")
            dist.all_gather_object(every, hashes, group=mesh.group("model"))
            out["routes"] = {"layers": len(hashes), "hashes": list(hashes),
                             "equal": all(h == hashes for h in every)}
        rows.append({"ms": ms, "tok_s": b["tokens"].numel() / ms * 1e3,
                     "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                     "gloo_ms": gloo["ms"], "traced": traced, "wire": wire_bytes()})
        if traced and prof is not None:
            rows[-1]["device_ms"] = _md_device_ms(prof)
        del prof
    out.update(steps=rows, peak_gib=_peak_gib(dev), launches=read_counters(), wire=dict(total))
    if dev.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    if save_dir is not None:
        import hashlib
        import shutil

        shutil.rmtree(save_dir, ignore_errors=True)
        calls = []
        zero_counters()
        _sync(dev)
        t0 = time.perf_counter()
        with (_recording(encode, "quantize_pack_segments", calls) if train is not None
              else contextlib.nullcontext()):
            path = save_checkpoint(save_dir, 1, state.params,
                                   compression=CodecSpec(kind="ternary", fttq=fcfg),
                                   mesh=mesh, specs=specs)
        _sync(dev)
        out["save"] = {"s": time.perf_counter() - t0, "launches": read_counters()}
        if mesh.rank == mesh.ranks[0]:
            with open(os.path.join(path, "state.msgpack"), "rb") as f:
                blob = f.read()
            out["save"].update(sha256=hashlib.sha256(blob).hexdigest(), bytes=sum(
                os.path.getsize(os.path.join(path, n)) for n in os.listdir(path)))
            if calls:
                out["save"].update(_save_vs_plain(calls, blob))
        del calls
    whole = gather_tree(state.params, specs, mesh)
    host = _host_tree(whole) if mesh.rank == mesh.ranks[0] else None
    del whole, state, step
    _free()
    return out, host


def _save_vs_plain(calls: list, blob: bytes) -> dict:
    """A ternary save's recorded ``quantize_pack_segments`` calls against
    the plain version on the same segments: the code bytes that differ, the
    scales' largest relative gap, and the scales the file's records hold
    (fp32 values of the leaves' w_q, one per ternary record) against the
    plain version's in the segments' dtype."""
    import numpy as np

    from repro_torch.kernels.quantize_pack import quantize_pack_segments_plain
    from repro_torch.train._msgpack import unpackb

    byte_diff = n_bytes = 0
    scale_rel = 0.0
    plain_scales = []
    for (rows, scal), kw, (packed, _, scales) in calls:
        p_packed, _, p_scales = quantize_pack_segments_plain(rows, scal,
                                                             kw.get("with_scales", False))
        byte_diff += int((packed != p_packed).sum())
        n_bytes += packed.numel()
        if scales is not None:
            scale_rel = max(scale_rel, float(((scales - p_scales).abs()
                                              / p_scales.abs().clamp_min(1e-30)).max()))
            # a record keeps its leaf's w_q, the scale in the leaf's dtype
            plain_scales.append(p_scales.to(rows[0].dtype).float().reshape(-1).cpu().numpy())
    records = [r for r in unpackb(blob)["leaves"] if "__tern__" in r]
    on_disk = np.sort(np.concatenate([np.frombuffer(r["w_q"], np.float32) for r in records]))
    want = np.sort(np.concatenate(plain_scales)) if plain_scales else np.zeros(0, np.float32)
    record_rel = (float(np.max(np.abs(on_disk - want) / np.maximum(np.abs(want), 1e-30)))
                  if on_disk.shape == want.shape and want.size else float("inf"))
    return {"code_bytes": n_bytes, "code_bytes_differing": byte_diff, "scale_rtol": scale_rel,
            "records": len(records), "record_scale_rtol": record_rel,
            "segment_dtype": str(calls[0][0][0][0].dtype)}


@contextlib.contextmanager
def _fault_shard_stats(only: str | None = None):
    """A planted fault: FTTQ's statistics per shard (each shard quantized
    with its own max|θ| and Δ, its g_wq not summed over the "model" group),
    as a port without leaf-global statistics would train; on every sharded
    leaf, or on those with ``only`` in their path."""
    from repro_torch.core import fttq
    from repro_torch.parallel.tensor import Shards

    whole_leaf = fttq.quantize_tree

    def per_shard(params, wq, cfg_, shards=None):
        if only is None or shards is None:
            return whole_leaf(params, wq, cfg_)
        return whole_leaf(params, wq, cfg_,
                          Shards({p: c for p, c in shards.cuts.items() if only not in p}))

    fttq.quantize_tree = per_shard
    try:
        yield
    finally:
        fttq.quantize_tree = whole_leaf


@contextlib.contextmanager
def _fault_own_slice():
    """A planted fault: the FSDP gather's backward keeps this rank's own
    slice of its local gradient, with no reduce-scatter, so each data
    shard learns from its own rank's rows alone."""
    from repro_torch.parallel import tensor as tensor_mod

    cls = tensor_mod._GatherFromData
    saved = cls.__dict__["backward"]
    cls.backward = staticmethod(lambda ctx, g: (tensor_mod._slice(g, ctx.ax, ctx.dim), None,
                                                None))
    try:
        yield
    finally:
        cls.backward = saved


@contextlib.contextmanager
def _fault_local_gates(top_k: int):
    """A planted fault: the MoE gates enter the combine without
    ``copy_to_model``, so the router's gradient through the combine counts
    only the rank's own experts (the tokens still enter through it)."""
    from repro_torch.models import moe as moe_mod

    copy = moe_mod.copy_to_model
    moe_mod.copy_to_model = lambda x, tp: x if x.shape[-1] == top_k else copy(x, tp)
    try:
        yield
    finally:
        moe_mod.copy_to_model = copy


def _tp_single(dev, cfg, batches, fcfg, tp_run: dict, tp_params, save_dir: str,
               start, train=None) -> tuple:
    """On one rank after the others freed the card: where the TP run saved,
    its gathered params saved by one process (sha256 against the TP save),
    then one process stepping the same batches from the same state
    (``start``, the whole params on the host; ``train`` as ``_tp_train``
    takes it), held to the TP run's losses and final params. Returns
    (report, its params on the host)."""
    import hashlib
    import shutil

    from repro_torch.core.compression import CodecSpec
    from repro_torch.optim import adam
    from repro_torch.train import TrainerConfig, init_train_state, make_train_step, save_checkpoint
    from repro_torch.tree import tree_map

    sha = None
    if "save" in tp_run:
        shutil.rmtree(save_dir, ignore_errors=True)
        params = tree_map(lambda t: t.to(dev), tp_params)
        path = save_checkpoint(save_dir, 1, params,
                               compression=CodecSpec(kind="ternary", fttq=fcfg))
        with open(os.path.join(path, "state.msgpack"), "rb") as f:
            sha = hashlib.sha256(f.read()).hexdigest()
        shutil.rmtree(save_dir, ignore_errors=True)
        del params
        _free()
    tcfg, lr = train or (TrainerConfig(), TRAIN_LR)
    opt = adam(lr)
    state = init_train_state(cfg, tcfg, opt, params=tree_map(lambda t: t.to(dev), start),
                             device=dev)
    step = make_train_step(cfg, tcfg, opt)
    got = []
    for b in batches:
        state, m = step(state, b)
        got.append(float(m["loss"]))
    tp_losses = [r["loss"] for r in tp_run["steps"]]
    out = {"losses": got, "save_sha256": sha, **_md_gaps(dev, tp_losses, got, tp_params,
                                                          state.params, start)}
    ref = _host_tree(state.params)
    del state, step
    _free()
    return out, ref


def _tp_serve(mesh, dev, cfg, prompts: int = TP_PROMPTS, prompt: int = TP_PROMPT,
              gen: int = TP_GEN, max_seq: int | None = None, shards=None) -> dict:
    """``launch/steps.py`` with the mesh: a prefill of ``prompts`` ×
    ``prompt`` tokens into ``max_seq`` slots (default: room for the
    decode) and ``gen`` greedy decode steps on the rank's shards of the
    seed-0 params, each rank feeding back its own rows' tokens (its rows of
    the batch where the batch divides over the mesh's batch axes); then on
    the mesh's first rank the same on the whole params in one process: each
    step's logits gathered over the rows (``gather_rows``) against the
    one-process logits (max |Δ| over max |logits|), the greedy tokens, each
    decode step's time and the cache's bytes. ``shards``: the rank's shards
    of those params, where the caller made them."""
    import torch

    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.transformer import init_params
    from repro_torch.parallel.tensor import gather_rows

    toks = torch.randint(0, cfg.vocab_size, (prompts, prompt),
                         generator=torch.Generator(dev).manual_seed(1), device=dev)
    max_seq = max_seq or prompt + gen

    def run(params, m):
        prefill = make_prefill_step(cfg, max_seq, mesh=m)
        decode = make_decode_step(cfg, mesh=m, batch=prompts)
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": toks})
        _sync(dev)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        steps, tokens, step_ms = [gather_rows(logits, m, prompts)], [], []
        for i in range(gen):
            tok = torch.argmax(logits, dim=-1)
            tokens.append(gather_rows(tok, m, prompts))
            _sync(dev)
            t0 = time.perf_counter()
            logits, cache = decode(params, {"tokens": tok, "cache": cache,
                                            "pos": prompt + i})
            _sync(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            steps.append(gather_rows(logits, m, prompts))
        kv = cache["attn_k" if "attn_k" in cache else "k"]
        return steps, torch.cat(tokens, dim=1), {
            "prefill_ms": prefill_ms, "decode_tok_s": prompts * gen / (sum(step_ms) / 1e3),
            "step_ms": step_ms, "cache_kv_heads": int(kv.shape[3]),
            "cache_rows": int(kv.shape[1]), "cache_slots": int(kv.shape[2]),
            "cache_bytes": sum(v.numel() * v.element_size() for v in cache.values())}

    if shards is None:
        shards = init_params(cfg, seed=0, device=dev, mesh=mesh)
    with torch.no_grad():
        steps, tokens, out = run(shards, mesh)
    del shards
    _free()
    if mesh.rank == mesh.ranks[0]:
        whole = init_params(cfg, seed=0, device=dev)
        with torch.no_grad():
            ref_steps, ref_tokens, ref = run(whole, None)
        out["one_process"] = ref
        out["logits_rel"] = max(float((a - b).abs().max() / b.abs().max())
                                for a, b in zip(steps, ref_steps))
        out["tokens_equal"] = bool(torch.equal(tokens, ref_tokens))
        out["shape"] = list(steps[0].shape)
        del whole, ref_steps
    del steps
    _free()
    out.update(prompts=prompts, prompt=prompt, gen=gen, max_seq=max_seq)
    return out


def _tp_pods_collective(mesh, dev, cfg, fcfg) -> dict:
    """(d) and (i): a seeded gradient tree of ``cfg`` per pod, each leaf
    drawn whole and cut to this rank's shard, through
    ``ternary_allreduce_tree`` with whole-leaf scalars: launches and
    all-gather bytes, and leaf by leaf against the plain version on the same
    shards (codes equal but at proven ties at Δ; means and residuals within
    1e-6 of their largest elsewhere). The kernel path's results wait on the
    host while the plain version runs (four ranks share the card)."""
    import torch

    from repro_torch.models.transformer import param_shapes
    from repro_torch.parallel.collectives import (
        compressed_leaf, reset_wire_bytes, ternary_allreduce_tree, wire_bytes,
    )
    from repro_torch.parallel.tensor import param_shards
    from repro_torch.tree import flatten_with_path, path_str, tree_map_with_path

    sh = param_shards(cfg, mesh)
    group = mesh.group("pod")
    gen = torch.Generator(dev).manual_seed(200 + mesh.index("pod"))

    def draw(path, shape):
        leaf = torch.randn(shape, generator=gen, device=dev) * 1e-3
        for ax, d in sh.cuts.get(path_str(path), ()):
            leaf = leaf.chunk(ax.size, d)[ax.rank]
        return leaf.clone()

    grads = tree_map_with_path(draw, param_shapes(cfg), is_leaf=lambda x: isinstance(x, tuple))
    items = flatten_with_path(grads)
    whole_shapes = dict(flatten_with_path(param_shapes(cfg),
                                          is_leaf=lambda x: isinstance(x, tuple)))
    comp = [compressed_leaf(p, g, fcfg, whole_shapes[p][-1]) for p, g in items]
    n_comp = sum(g.numel() for (_, g), c in zip(items, comp) if c)
    _sync(dev)
    zero_counters()
    reset_wire_bytes()
    t0 = time.perf_counter()
    synced, res = ternary_allreduce_tree(grads, group, cfg=fcfg, shards=sh)
    _sync(dev)
    out = {"wall_ms": (time.perf_counter() - t0) * 1e3, "launches": read_counters(),
           "wire": wire_bytes(), "compressed_elements": n_comp,
           "want_gather_bytes": n_comp // 4 + 4 * sum(comp)}
    synced, res = _host_tree(synced), _host_tree(res)
    _free()
    out.update(_sync_vs_plain(dev, group, fcfg, sh, grads, synced, res))
    del grads, synced, res
    _free()
    return out


def _compressed_shard(path, x, fcfg, sh) -> bool:
    """Whether the tree form of the sync compresses ``x``, this rank's
    shard (cut as ``sh`` says, or whole) of the leaf at ``path``: its
    whole leaf's last dim decides."""
    from repro_torch.parallel.collectives import compressed_leaf
    from repro_torch.tree import path_str

    cut = sh.cuts.get(path_str(path), ()) if sh is not None else ()
    return compressed_leaf(path, x, fcfg, x.shape[-1] * math.prod(
        ax.size for ax, d in cut if d in (-1, x.ndim - 1)))


def _sync_vs_plain(dev, group, fcfg, sh, grads, synced, res, res_in=None) -> dict:
    """The kernel path's ``ternary_allreduce_tree`` outputs (``synced``,
    ``res``, on the host or ``dev``) of ``grads`` with the residuals
    ``res_in`` (None: zeros), leaf by leaf against the plain version on the
    same shards: its code flips and the proven ties among them (|x_s|
    within 1e-6 of Δ), and the means' and residuals' largest gap away from
    a flip, over their largest |value|."""
    import torch

    from repro_torch.parallel.collectives import (
        all_gather, shard_scalars_plain, ternary_allreduce_tree_plain,
    )
    from repro_torch.tree import flatten_with_path, path_str, tree_leaves

    synced_p, res_p = ternary_allreduce_tree_plain(grads, group, cfg=fcfg, shards=sh,
                                                   residuals=res_in)
    items = flatten_with_path(grads)
    ins = tree_leaves(res_in) if res_in is not None else [None] * len(items)
    flips = ties = 0
    mean_gap = res_gap = 0.0
    for ((path, g), r_in, s_k, r_k, s_p, r_p) in zip(
            items, ins, tree_leaves(synced), tree_leaves(res), tree_leaves(synced_p),
            tree_leaves(res_p)):
        s_k, r_k = s_k.to(dev), r_k.to(dev)
        x = g.to(torch.float32) + (r_in.to(dev) if r_in is not None else 0.0)
        keep = torch.ones(g.shape, dtype=torch.bool, device=dev)
        if _compressed_shard(path, g, fcfg, sh):
            if sh is not None and path_str(path) in sh.cuts:
                mx, delta, wq = shard_scalars_plain([x], fcfg.t_k, sh.axes(path_str(path)))[0]
            else:
                absx = x.abs()
                mx = absx.max() + 1e-12
                delta = fcfg.t_k * absx.mean() / mx
                sel = (x / mx).abs() > delta
                wq = torch.where(sel, absx, 0.0).sum() / (sel.sum() + 1e-12)
            xs = x / mx
            codes_p = torch.where(xs.abs() > delta, torch.sign(xs), 0.0)
            codes_k = torch.round((x - r_k) / wq)
            flip = codes_k != codes_p
            mine = int(flip.sum())
            if mine:
                gap = (xs[flip].abs() - delta).abs()
                ties += int((gap <= 1e-6 * delta).sum())
            flips += mine
            keep = ~all_gather(flip.to(torch.uint8), group).any(0).to(torch.bool)
            if bool((~flip).any()):
                res_gap = max(res_gap, float((r_k - r_p)[~flip].abs().max()
                                             / r_p.abs().max().clamp_min(1e-30)))
        if bool(keep.any()):
            mean_gap = max(mean_gap, float((s_k - s_p.to(s_k.dtype))[keep].abs().max().float()
                                           / s_p.abs().max().float().clamp_min(1e-30)))
    del synced_p, res_p
    return {"code_flips": flips, "proven_ties": ties, "mean_rel_gap": mean_gap,
            "residual_rel_gap": res_gap}


def _tp_pods_train(mesh, dev, cfg, batches, train=None, check_sync: bool = False) -> dict:
    """(d) TP_PODS_STEPS compressed steps over the pods x model mesh from
    the seed-0 state (TrainerConfig defaults, adam(3e-4); ``train``: another
    (TrainerConfig, lr)): per step the ms, loss, launches and wire bytes,
    each step counted on its own. With ``check_sync`` each step's cross-pod
    sync is recorded (its inputs and outputs on the host) and, after the
    step is counted, held to the plain version on the same inputs
    (``_sync_vs_plain``), and the sync's all-gather bytes expected of its
    compressed shard elements are reported."""
    import torch

    import repro_torch.train.trainer as trainer_mod
    from repro_torch.optim import adam
    from repro_torch.parallel.collectives import reset_wire_bytes, wire_bytes
    from repro_torch.train import TrainerConfig, init_train_state, make_train_step
    from repro_torch.tree import flatten_with_path

    tcfg, lr = train or (TrainerConfig(), TRAIN_LR)
    opt = adam(lr)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, tcfg, opt, seed=0, device=dev, n_pods=mesh.size("pod"),
                             mesh=mesh)
    step = make_train_step(cfg, tcfg, opt, mesh=mesh)
    calls, sync = [], trainer_mod.ternary_allreduce_tree

    def recorded(g_p, grp, *, residuals=None, **kw):
        synced, res = sync(g_p, grp, residuals=residuals, **kw)
        calls.append((_host_tree(g_p), _host_tree(residuals) if residuals is not None else None,
                      _host_tree(synced), _host_tree(res), grp, kw))
        return synced, res

    rows = []
    for b in batches:
        zero_counters()
        reset_wire_bytes()
        if check_sync:
            trainer_mod.ternary_allreduce_tree = recorded
        try:
            _sync(dev)
            t0 = time.perf_counter()
            state, m = step(state, b)
            _sync(dev)
        finally:
            trainer_mod.ternary_allreduce_tree = sync
        rows.append({"ms": (time.perf_counter() - t0) * 1e3, "loss": float(m["loss"]),
                     "launches": read_counters(), "wire": wire_bytes()})
        if check_sync:
            (g, r_in, synced, res, grp, kw), = calls
            calls.clear()
            sh, fcfg = kw.get("shards"), kw.get("cfg")
            comp = [x for p, x in flatten_with_path(g) if _compressed_shard(p, x, fcfg, sh)]
            n_comp = sum(x.numel() for x in comp)
            rows[-1].update(compressed_elements=n_comp,
                            want_gather_bytes=n_comp // 4 + 4 * len(comp),
                            sync_dtypes=sorted({str(x.dtype) for _, x in flatten_with_path(g)}),
                            **_sync_vs_plain(dev, grp, fcfg, sh, _to_dev(g, dev), synced, res,
                                             _to_dev(r_in, dev) if r_in is not None else None))
            del g, r_in, synced, res
            _free()
    out = {"steps": rows, "peak_gib": _peak_gib(dev),
           "dtypes": sorted({str(x.dtype) for _, x in flatten_with_path(state.params)})}
    del state, step
    _free()
    return out


def _to_dev(tree, dev):
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.to(dev), tree)


def _first_grads(mesh, dev, cfg, batch, fcfg, start, routes: bool = False) -> tuple:
    """The first step's loss and parameter gradients (TrainerConfig
    defaults) from ``start``, over the mesh's "model" axis or, with
    ``mesh`` None, on one process: (loss, the gradients gathered whole on
    the host at model index 0, else None, the MoE layers' routing hashes
    where ``routes``)."""
    from repro_torch.optim import adam
    from repro_torch.parallel.sharding import param_specs
    from repro_torch.parallel.tensor import gather_tree, model_axis
    from repro_torch.train import TrainerConfig, init_train_state
    from repro_torch.train.trainer import _local_grads, step_axes
    from repro_torch.tree import tree_map

    tcfg = TrainerConfig()
    state = init_train_state(cfg, tcfg, adam(TRAIN_LR), params=tree_map(lambda t: t.to(dev), start),
                             device=dev, mesh=mesh)
    tp = model_axis(mesh)
    with _route_hashes() if routes else contextlib.nullcontext([]) as hashes:
        loss, _, grads, _ = _local_grads(cfg, tcfg, state, batch, step_axes(cfg, tcfg, mesh))
    del state
    if tp is not None:
        grads = gather_tree(grads, param_specs(cfg, mesh), mesh)
    host = _host_tree(grads) if mesh is None or mesh.index("model") == 0 else None
    del grads
    _free()
    return float(loss), host, list(hashes)


def _grad_gap(dev, grads, ref) -> dict:
    """The worst leaf's ‖Δg‖ / ‖g‖ of ``grads`` against ``ref`` (host trees
    of one layout), and that leaf."""
    import torch

    from repro_torch.tree import flatten_with_path, path_str

    worst, where = 0.0, ""
    for (p, a), (_, b) in zip(flatten_with_path(grads), flatten_with_path(ref)):
        a, b = a.to(dev), b.to(dev)
        gap = float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))
        if gap > worst:
            worst, where = gap, path_str(p)
    return {"rel_l2": worst, "leaf": where}


def _tp_twin(dev, cfg, batches, start, ref_losses, ref_params) -> dict:
    """One process stepping ``batches`` from ``start`` with relative
    weight noise of TP_TWIN_NOISE (the size of a reordered fp32 sum), held
    to nothing: its gaps to the unperturbed one-process run are the model's
    own sensitivity to summation order."""
    import torch

    from repro_torch.optim import adam
    from repro_torch.train import TrainerConfig, init_train_state, make_train_step
    from repro_torch.tree import tree_map

    gen = torch.Generator().manual_seed(5)
    noisy = tree_map(lambda t: (t * (1 + TP_TWIN_NOISE * torch.randn(t.shape, generator=gen))
                                ).to(dev), start)
    tcfg, opt = TrainerConfig(), adam(TRAIN_LR)
    state = init_train_state(cfg, tcfg, opt, params=noisy, device=dev)
    del noisy
    step = make_train_step(cfg, tcfg, opt)
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    out = {"losses": losses, **_md_gaps(dev, losses, ref_losses, state.params, ref_params)}
    del state, step
    _free()
    return out


def _tp_cell(mesh, pair, dev, cfg, fcfg, out_dir: str, name: str, fault,
             save: bool = False, route_check: bool = False, first_step: bool = False,
             steps: int = TP_STEPS, train=None) -> dict:
    """One sharded train cell on ``mesh`` (its ranks the group ``pair``,
    None for all): the seed-0 params with their Δ ties moved
    (``_tp_detie``), ``steps`` steps of the CLI's token stream (the last
    traced), held on the mesh's first rank after the ranks free the card to
    one process from the same state, and (unless ``fault`` is None) the
    same run under the planted fault (``fault()``, a context manager) held
    to the same limits; with ``save`` the trained params' ternary save from
    the shards. With
    ``first_step`` the run is held to one process at its first step instead
    (its loss and its gradients, TP and fault alike), and the trajectories
    are printed beside a noise twin's (``_tp_twin``): for a model that
    amplifies a reordered sum past the limits within a few steps. ``train``:
    the (TrainerConfig, lr) of every run, as ``_tp_train`` takes it."""
    import torch.distributed as dist

    from repro_torch.data.synthetic import synthetic_tokens, token_batches
    from repro_torch.launch.train import DATA_SEED

    t0 = time.perf_counter()
    tokens = synthetic_tokens(DATA_SEED, TP_BATCH * (TP_SEQ + 1) * steps, cfg.vocab_size)
    gen = token_batches(tokens, TP_BATCH, TP_SEQ, device=dev)
    batches = [next(gen)[0] for _ in range(steps)]
    out = {"layers": cfg.n_layers}
    out["codes"], whole = _tp_detie(mesh, dev, cfg, fcfg)
    start = _host_tree(whole)
    del whole
    _free()
    dist.barrier(group=pair)
    if first_step:
        loss_tp, g_tp, _ = _first_grads(mesh, dev, cfg, batches[0], fcfg, start)
        with fault():
            loss_f, g_f, _ = _first_grads(mesh, dev, cfg, batches[0], fcfg, start)
        dist.barrier(group=pair)
        if g_tp is not None:
            loss_one, g_one, hashes = _first_grads(None, dev, cfg, batches[0], fcfg, start,
                                                   routes=route_check)
            out["first"] = {
                "loss": loss_one, "loss_rel_gap": abs(loss_tp - loss_one) / abs(loss_one),
                "grad": _grad_gap(dev, g_tp, g_one),
                "fault_loss_rel_gap": abs(loss_f - loss_one) / abs(loss_one),
                "fault_grad": _grad_gap(dev, g_f, g_one), "one_routes": hashes}
        del g_tp, g_f
        _free()
        dist.barrier(group=pair)
    out["train"], tp_params = _tp_train(
        mesh, dev, cfg, batches, fcfg, start, trace=True, route_check=route_check,
        save_dir=os.path.join(out_dir, f"{name}_tp_save") if save else None, train=train)
    dist.barrier(group=pair)
    single_params = None
    if tp_params is not None:
        out["single"], single_params = _tp_single(
            dev, cfg, batches, fcfg, out["train"], tp_params,
            os.path.join(out_dir, f"{name}_one_save"), start, train=train)
    del tp_params
    dist.barrier(group=pair)
    fault_params = None
    if fault is not None:
        with fault():
            out["fault"], fault_params = _tp_train(mesh, dev, cfg, batches, fcfg, start,
                                                   train=train)
    if fault_params is not None:
        fault_losses = [r["loss"] for r in out["fault"]["steps"]]
        out["fault"]["gaps"] = _md_gaps(dev, fault_losses, out["single"]["losses"],
                                        fault_params, single_params, start)
        del fault_params
        if first_step:
            out["twin"] = _tp_twin(dev, cfg, batches, start, out["single"]["losses"],
                                   single_params)
    del single_params, start
    _free()
    dist.barrier(group=pair)
    out["wall_s"] = time.perf_counter() - t0
    return out


def _leaf_gaps(got, ref, sh) -> dict:
    """{leaf: ‖got − ref‖ / ‖ref‖ of the whole leaf} from this rank's
    shards of two trees of one layout (``sh``: the ``Shards`` that cut
    them; the squared sums reduced over each cutting axis, in float64)."""
    import torch

    from repro_torch.parallel.tensor import reduce_over
    from repro_torch.tree import flatten_with_path, path_str

    names, parts = [], []
    for (p, a), (_, b) in zip(flatten_with_path(got), flatten_with_path(ref)):
        a, b = a.to(torch.float64), b.to(a.device, torch.float64)
        names.append(path_str(p))
        parts.append(torch.stack([((a - b) ** 2).sum(), (b ** 2).sum()]).cpu())
    sums = reduce_over(parts, [sh.axes(n) if sh is not None else () for n in names])
    return {n: float(x[0].sqrt() / x[1].sqrt().clamp_min(1e-300)) for n, x in zip(names, sums)}


@contextlib.contextmanager
def _fault_no_grad_scale():
    """A planted fault: the all-to-all MoE's returned copies keep their
    whole gradient, so every expert's owner, which computed each copy once
    per source rank, gets n_ep times its gradient."""
    from repro_torch.models import moe_a2a

    saved = moe_a2a._ScaleGrad.apply
    moe_a2a._ScaleGrad.apply = lambda x, scale: x
    try:
        yield
    finally:
        moe_a2a._ScaleGrad.apply = saved


def _tp_a2a(mesh, dev, cfg, fcfg) -> dict:
    """(r) qwen3-moe-30b-a3b over the pair's "model" axis with the
    all-to-all MoE (EP over "model", each rank's own experts, the replicated
    tokens): from one seed-0 state and one batch, the QAT step's loss and
    gradients (``train.make_grad_fn``) with the plain wire, with the
    scatter dispatch and under the planted fault (no 1/n_ep scale), each
    leaf's ‖Δg‖/‖g‖ over the whole leaf; the all-to-all's bytes and calls a
    rank, its buffers' bytes; one whole train step of each dispatch timed;
    and the int8 wire's forward logits against the plain wire's."""
    import dataclasses

    import torch

    from repro_torch.models.moe_a2a import _up8
    from repro_torch.models.transformer import forward
    from repro_torch.optim import adam
    from repro_torch.parallel.collectives import reset_wire_bytes, wire_bytes, wire_calls
    from repro_torch.parallel.tensor import model_axis, param_shards, reduce_over
    from repro_torch.train import TrainerConfig, init_train_state, make_grad_fn, make_train_step

    t_start = time.perf_counter()
    cfg_g = dataclasses.replace(cfg, moe_impl="gspmd", capacity_factor=TP_A2A_CF)
    cfg_a = dataclasses.replace(cfg_g, moe_impl="a2a", moe_wire="bf16", mesh_ep_axis="model")
    cfg_q = dataclasses.replace(cfg_a, moe_wire="int8")
    tcfg, opt = TrainerConfig(fttq=fcfg), adam(TRAIN_LR)
    state = init_train_state(cfg_g, tcfg, opt, seed=0, device=dev, mesh=mesh)
    _free()
    b, s = TP_A2A_TOKENS
    toks = torch.randint(0, cfg.vocab_size, (b, s + 1),
                         generator=torch.Generator(dev).manual_seed(3), device=dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    n_ep, t, k = mesh.size("model"), b * s, cfg.top_k
    c_send = _up8(max(int(t * k / n_ep * TP_A2A_CF), k))
    e_loc = cfg.n_experts // n_ep
    c_loc = min(_up8(max(int(n_ep * c_send / e_loc), 8)), n_ep * c_send)
    d = cfg.d_model
    out = {"tokens": [b, s], "c_send": c_send, "c_loc": c_loc,
           "send_buffer_bytes": n_ep * c_send * d * 4, "expert_buffer_bytes": e_loc * c_loc * d * 4,
           # a layer's forward: the send buffer, its int32 expert index and the
           # return trip; its backward: both trips again; a rank receives
           # (n_ep − 1)/n_ep of each
           "want_a2a_bytes": cfg.n_layers * (n_ep - 1) * c_send * (4 * d * 4 + 4),
           "want_a2a_calls": cfg.n_layers * 5}
    grads = {}
    for name, c, fault in (("gspmd", cfg_g, False), ("a2a", cfg_a, False),
                           ("fault", cfg_a, True)):
        reset_wire_bytes()
        _sync(dev)
        t0 = time.perf_counter()
        with _fault_no_grad_scale() if fault else contextlib.nullcontext():
            loss, _, g, _ = make_grad_fn(c, tcfg, mesh)(state, batch)
        _sync(dev)
        out[name] = {"loss": float(loss), "grad_ms": (time.perf_counter() - t0) * 1e3,
                     "wire": wire_bytes(), "calls": wire_calls()}
        grads[name] = g
        del g
    sh = param_shards(cfg_g, mesh)
    for name in ("a2a", "fault"):
        gaps = _leaf_gaps(grads[name], grads["gspmd"], sh)
        worst = max(gaps, key=gaps.get)
        out[name].update(loss_rel_gap=abs(out[name]["loss"] - out["gspmd"]["loss"])
                         / abs(out["gspmd"]["loss"]),
                         worst_leaf=worst, worst_rel_l2=gaps[worst],
                         named={n: gaps[n] for n in TP_A2A_LEAVES})
    del grads
    _free()
    for name, c in (("gspmd", cfg_g), ("a2a", cfg_a)):
        _sync(dev)
        t0 = time.perf_counter()
        new, m = make_train_step(c, tcfg, opt, mesh=mesh)(state, batch)
        _sync(dev)
        out[name].update(step_ms=(time.perf_counter() - t0) * 1e3, step_loss=float(m["loss"]))
        del new, m
        _free()
    tp = model_axis(mesh)
    logits = {}
    with torch.no_grad():
        for name, c in (("bf16", cfg_a), ("int8", cfg_q)):
            reset_wire_bytes()
            logits[name], _, _ = forward(c, state.params, batch["tokens"], tp=tp)
            out[f"{name}_forward_a2a_bytes"] = wire_bytes().get("all_to_all", 0)
    d2, n2 = reduce_over([torch.stack([((logits["int8"] - logits["bf16"]).double() ** 2).sum(),
                                       (logits["bf16"].double() ** 2).sum()]).cpu()],
                         [(tp,)])[0]
    out["int8_rel_l2"] = float(d2.sqrt() / n2.sqrt())
    del state, logits
    _free()
    out["wall_s"] = time.perf_counter() - t_start
    return out


def tensor_parallel_rank(rank: int, dev, fcfg, sizes: dict, pair, tp_mesh, pods_mesh,
                         out_dir: str, progress=lambda out: None) -> dict:
    """The tensor_parallel phase on one rank of the multidevice spawn: (a)
    olmo-1b at full width over the pair's "model" axis against one process
    and a planted fault, (b) the ternary save from the shards, (c) prefill
    and decode; (e) zamba2-1.2b and (f) qwen3-moe-30b-a3b trained the same
    way, each with its own planted fault, (g) the latter's ternary save, (h)
    zamba2's prefill and decode, (r) qwen3-moe's all-to-all MoE against the
    scatter dispatch and a planted fault; then (d) and (i) pods x model on all four
    ranks (olmo-1b, qwen3-moe). ``progress(out)`` is called after each
    part with the report so far."""
    import torch.distributed as dist

    from repro_torch.data.synthetic import synthetic_tokens, token_batches
    from repro_torch.launch.train import DATA_SEED

    out = {}
    if tp_mesh.member:
        cell = _tp_cell(tp_mesh, pair, dev, sizes["tp"], fcfg, out_dir, "olmo",
                        _fault_shard_stats, save=True)
        out.update({k: cell[k] for k in ("codes", "train", "single", "fault", "wall_s")
                    if k in cell})
        out["serve"] = _tp_serve(tp_mesh, dev, sizes["tp"])
        progress(out)
        dist.barrier(group=pair)
        out["zamba2"] = _tp_cell(tp_mesh, pair, dev, sizes["tp_zamba"], fcfg, out_dir, "zamba2",
                                 lambda: _fault_shard_stats(only="mamba"), first_step=True)
        progress(out)
        out["zamba2"]["serve"] = _tp_serve(tp_mesh, dev, sizes["tp_zamba"])
        progress(out)
        dist.barrier(group=pair)
        moe_cfg = sizes["tp_moe"]
        out["moe"] = _tp_cell(tp_mesh, pair, dev, moe_cfg, fcfg, out_dir, "moe",
                              lambda: _fault_local_gates(moe_cfg.top_k), save=True,
                              route_check=True, first_step=True)
        progress(out)
        dist.barrier(group=pair)
        out["a2a"] = _tp_a2a(tp_mesh, dev, sizes["tp_a2a"], fcfg)
        progress(out)
    dist.barrier()
    pods_cfg = sizes["tp_pods"]
    out["pods_collective"] = _tp_pods_collective(pods_mesh, dev, pods_cfg, fcfg)
    progress(out)
    dist.barrier()
    tokens = synthetic_tokens(DATA_SEED, TP_BATCH * (TP_SEQ + 1) * TP_PODS_STEPS,
                              pods_cfg.vocab_size)
    gen = token_batches(tokens, TP_BATCH, TP_SEQ, device=dev)
    out["pods_train"] = _tp_pods_train(pods_mesh, dev, pods_cfg,
                                       [next(gen)[0] for _ in range(TP_PODS_STEPS)])
    dist.barrier()
    out["pods_moe_collective"] = _tp_pods_collective(pods_mesh, dev, sizes["tp_pods_moe"], fcfg)
    return out


def _tp_cell_checks(r: int, tag: str, label: str, cell: dict, fault_what: str,
                    save_tag: str = "", save_bytes: int | None = None,
                    fault_in_forward: bool = True, part: str = "tensor_parallel",
                    over: str = f"{TP_RANKS} model ranks") -> None:
    """Print one TP train cell's numbers (``_tp_cell``) and hold them to
    the contract: codes equal but at ties, then none after moving them; on
    rank 0 the run within TP_LOSS_RTOL and MD_PARAM_RTOL_L2 of one process
    and the planted fault past both (a first-step cell: its first step's
    loss and gradients, the fault's gradients past the limit and its loss
    too where ``fault_in_forward``: a fault only in the backward leaves the
    first step's loss as it is); a save from the shards one quantize_pack
    launch and the one-process save's bytes; the ranks' routing equal where
    checked."""
    c = cell["codes"]
    print(f"rank {r}, {part} ({tag}) {label}: {cell['wall_s']:.1f} s for the cell; "
          "QAT codes of the seed-0 shards from "
          f"whole-leaf statistics vs the whole leaves: {c['differing']} of {c['codes']} differ, "
          f"{c['ties']} of them ties at Δ; {c['moved']} weights of the whole leaves moved off Δ, "
          f"{c['left']} codes differing after")
    check(c["differing"] == c["ties"], f"({tag}) a shard's QAT code differs from the whole "
                                       "leaf's away from a tie at Δ")
    check(c["left"] == 0, f"({tag}) the shards' QAT codes still differ after moving the ties "
                          "off Δ")
    for name in ("train", "fault"):
        run = cell[name]
        print(f"rank {r}, {part} ({tag}) {label}, {TP_BATCH} x {TP_SEQ} over "
              f"{over} ({name}): steps "
              + "; ".join(f"{s['ms']:.1f} ms{' traced' if s['traced'] else ''} "
                          f"({s['tok_s']:.0f} tok/s) loss {s['loss']:.6f}, "
                          f"{s['gloo_ms']:.1f} ms in gloo calls"
                          + (f", {s['device_ms']:.1f} ms of device kernels"
                             if "device_ms" in s else "") for s in run["steps"])
              + f"; peak {run['peak_gib']:.2f} GiB; init {run['init_s']:.1f} s; "
              f"launches {json.dumps(run['launches'])}; wire {json.dumps(run['wire'])}")
    if "routes" in cell["train"]:
        ro = cell["train"]["routes"]
        print(f"rank {r}, tensor_parallel ({tag}) routing of the first step: {ro['layers']} MoE "
              f"layers, the model ranks' top-k indices equal: {ro['equal']}")
        check(ro["equal"] and ro["layers"] > 0, f"({tag}) the model ranks routed differently")
    sv = cell["train"].get("save")
    if sv is not None:
        print(f"rank {r}, {part} ({save_tag}) ternary save from the shards: "
              f"{sv['s']:.2f} s, launches {json.dumps(sv['launches'])}"
              + (f", {sv['bytes']} B, sha256 {sv['sha256']}" if "sha256" in sv else ""))
    if "single" not in cell:
        return
    if sv is not None:
        check(sv["launches"]["quantize_pack"] == 1,
              f"({save_tag}) the ternary save from the shards launched quantize_pack other than "
              "once")
        if save_bytes is not None:
            check(sv["bytes"] == save_bytes, f"({save_tag}) the ternary save from the shards is "
                                             f"{sv['bytes']} B, not {save_bytes}")
        check(sv["sha256"] == cell["single"]["save_sha256"],
              f"({save_tag}) the ternary save from the shards differs from the one-process save")
    first = cell.get("first")
    held = "printed, not held" if first is not None else "held"
    runs = [("single", "sharded run vs one process"),
            ("fault", f"planted fault ({fault_what}) vs one process")]
    if "twin" in cell:
        runs.append(("twin", f"one process with {TP_TWIN_NOISE:g} relative weight noise vs "
                             "one process"))
    for name, what in runs:
        g = {"single": cell["single"], "fault": cell["fault"]["gaps"]}.get(name, cell.get(name))
        print(f"rank {r}, ({tag}) {what}, {TP_STEPS} steps ({held}): one-process losses "
              f"{cell['single']['losses']}; max loss rel gap {g['loss_rel_gap']:.3e} (limit "
              f"{TP_LOSS_RTOL:g}); params worst leaf ‖Δ‖/‖p‖ {g['param_rel_l2']:.3e} (limit "
              f"{MD_PARAM_RTOL_L2:g}), max |Δ| / max |p| {g['param_rel_gap']:.3e}")
    if first is not None:
        print(f"rank {r}, ({tag}) the first step from the same state, TP vs one process: loss "
              f"rel gap {first['loss_rel_gap']:.3e} (limit {TP_LOSS_RTOL:g}); gradients worst "
              f"leaf ‖Δg‖/‖g‖ {first['grad']['rel_l2']:.3e} ({first['grad']['leaf']}; limit "
              f"{MD_PARAM_RTOL_L2:g}); the planted fault: loss {first['fault_loss_rel_gap']:.3e}, "
              f"gradients {first['fault_grad']['rel_l2']:.3e} ({first['fault_grad']['leaf']})")
        if first["one_routes"]:
            print(f"rank {r}, ({tag}) first-step routing of one process equal to the model "
                  f"ranks': {first['one_routes'] == cell['train']['routes']['hashes']}")
        check(first["loss_rel_gap"] <= TP_LOSS_RTOL
              and first["grad"]["rel_l2"] <= MD_PARAM_RTOL_L2,
              f"({tag}) the first tensor-parallel step disagrees with one process")
        check(first["fault_grad"]["rel_l2"] > MD_PARAM_RTOL_L2
              and (first["fault_loss_rel_gap"] > TP_LOSS_RTOL or not fault_in_forward),
              f"({tag}) a limit of the first-step checks does not catch the planted fault")
        return
    g = cell["single"]
    check(g["loss_rel_gap"] <= TP_LOSS_RTOL and g["param_rel_l2"] <= MD_PARAM_RTOL_L2,
          f"({tag}) tensor-parallel training disagrees with one process")
    f = cell["fault"]["gaps"]
    check(f["loss_rel_gap"] > TP_LOSS_RTOL and f["param_rel_l2"] > MD_PARAM_RTOL_L2,
          f"({tag}) a limit of the tensor-parallel checks does not catch the planted fault")


def _tp_serve_checks(r: int, tag: str, label: str, s: dict, part: str = "tensor_parallel",
                     half_cache: bool = False) -> None:
    """Print a serving cell's numbers; hold its logits and tokens to one
    process, and with ``half_cache`` each rank's cache to half of one
    process's bytes."""
    print(f"rank {r}, {part} ({tag}) {label} prefill {s['prompts']} x {s['prompt']} into "
          f"{s['max_seq']} slots {s['prefill_ms']:.2f} ms, {s['gen']} greedy steps "
          f"{s['decode_tok_s']:.2f} tok/s (steps "
          + ", ".join(f"{m:.1f}" for m in s["step_ms"]) + " ms); the rank's cache "
          f"{s['cache_rows']} rows x "
          f"{s['cache_slots']} slots x {s['cache_kv_heads']} kv heads, {s['cache_bytes']} B"
          + (f"; one process prefill {s['one_process']['prefill_ms']:.2f} ms, "
             f"{s['one_process']['decode_tok_s']:.1f} tok/s, cache "
             f"{s['one_process']['cache_bytes']} B; logits shape {s['shape']}, max rel gap "
             f"{s['logits_rel']:.3e} (limit {TP_LOGITS_REL:g}), tokens equal "
             f"{s['tokens_equal']}" if "logits_rel" in s else ""))
    if "logits_rel" in s:
        check(s["logits_rel"] <= TP_LOGITS_REL and s["tokens_equal"],
              f"({tag}) sharded prefill or decode disagrees with one process")
        if half_cache:
            check(2 * s["cache_bytes"] == s["one_process"]["cache_bytes"],
                  f"({tag}) a rank's cache is not half of one process's")


def _tp_pods_collective_checks(r: int, tag: str, label: str, c: dict,
                               part: str = "tensor_parallel", what: str = "pods x model") -> None:
    print(f"rank {r}, {part} ({tag}) {what} collective on {label}'s "
          f"{c['compressed_elements']} compressed shard elements: wall {c['wall_ms']:.1f} ms; "
          f"launches {json.dumps(c['launches'])}; wire {json.dumps(c['wire'])} (all-gather "
          f"want {c['want_gather_bytes']}); code flips {c['code_flips']} "
          f"({c['proven_ties']} proven ties), mean rel gap {c['mean_rel_gap']:.3e}, residual "
          f"rel gap {c['residual_rel_gap']:.3e}")
    check(c["launches"]["quantize_pack"] == 1 and c["launches"]["aggregate"] == 2,
          f"({tag}) the {what} collective launched other than 1 quantize_pack and 2 "
          "aggregate")
    check(c["wire"].get("all_gather", 0) == c["want_gather_bytes"],
          f"({tag}) the {what} all-gather is not 0.25 B a shard coordinate plus w_q")
    check(c["code_flips"] == c["proven_ties"], f"({tag}) a {what} code differs from the "
                                               "plain version away from a tie at Δ")
    check(c["mean_rel_gap"] <= 1e-6 and c["residual_rel_gap"] <= 1e-6,
          f"({tag}) the {what} collective disagrees with the plain version")


def _tp_a2a_checks(r: int, a: dict, layers) -> None:
    """Print (r) and hold it: the a2a step's loss within TP_LOSS_RTOL and
    every leaf's ‖Δg‖/‖g‖ within MD_PARAM_RTOL_L2 of the scatter
    dispatch's, the planted fault past the gradient limit on every expert
    stack, the all-to-all's bytes and calls their closed form, and the int8
    wire's forward within TP_A2A_INT8_REL_L2 of the plain wire's."""
    b, s = a["tokens"]
    print(f"rank {r}, tensor_parallel (r) qwen3-moe-30b-a3b {layers} of 48 layers at full "
          f"width, {b} x {s} over {TP_RANKS} model ranks, the all-to-all MoE (EP over "
          f"'model', capacity {TP_A2A_CF:g}): C_send {a['c_send']}, C_loc {a['c_loc']}; send "
          f"buffer {a['send_buffer_bytes']} B, expert buffer {a['expert_buffer_bytes']} B; "
          f"{a['wall_s']:.1f} s for the cell")
    for name in ("gspmd", "a2a", "fault"):
        x = a[name]
        print(f"rank {r}, (r) {name}: loss {x['loss']:.7f}, gradients {x['grad_ms']:.1f} ms"
              + (f", one step {x['step_ms']:.1f} ms (loss {x['step_loss']:.7f})"
                 if "step_ms" in x else "")
              + f"; all_to_all {x['wire'].get('all_to_all', 0)} B in "
              f"{x['calls'].get('all_to_all', 0)} calls a rank; wire {json.dumps(x['wire'])}")
    for name, what in (("a2a", "a2a vs the scatter dispatch"),
                       ("fault", "planted fault (no 1/n_ep scale) vs the scatter dispatch")):
        x = a[name]
        print(f"rank {r}, (r) {what}: loss rel gap {x['loss_rel_gap']:.3e} (limit "
              f"{TP_LOSS_RTOL:g}); worst leaf ‖Δg‖/‖g‖ {x['worst_rel_l2']:.3e} "
              f"({x['worst_leaf']}; limit {MD_PARAM_RTOL_L2:g}); "
              + ", ".join(f"{n} {v:.3e}" for n, v in x["named"].items()))
    print(f"rank {r}, (r) the all_to_all a rank receives: {a['a2a']['wire'].get('all_to_all', 0)}"
          f" B in {a['a2a']['calls'].get('all_to_all', 0)} calls (want {a['want_a2a_bytes']} B "
          f"in {a['want_a2a_calls']}); the int8 wire's forward logits rel L2 "
          f"{a['int8_rel_l2']:.3e} of the plain wire's (limit {TP_A2A_INT8_REL_L2:g}; "
          f"all_to_all {a['int8_forward_a2a_bytes']} B against {a['bf16_forward_a2a_bytes']})")
    check(a["a2a"]["loss_rel_gap"] <= TP_LOSS_RTOL
          and a["a2a"]["worst_rel_l2"] <= MD_PARAM_RTOL_L2,
          "(r) the all-to-all MoE's step disagrees with the scatter dispatch's")
    check(all(a["fault"]["named"][n] > MD_PARAM_RTOL_L2 for n in TP_A2A_LEAVES[:3]),
          "(r) the gradient limit does not catch the missing 1/n_ep scale on the expert stacks")
    check(a["a2a"]["wire"].get("all_to_all", 0) == a["want_a2a_bytes"]
          and a["a2a"]["calls"].get("all_to_all", 0) == a["want_a2a_calls"],
          "(r) the all-to-all's bytes or calls are not the closed form's")
    check(a["int8_rel_l2"] < TP_A2A_INT8_REL_L2, "(r) the int8 wire is off by 5% or more")


def tensor_parallel_checks(reports: list, sizes: dict | None = None) -> None:
    """Print the tensor_parallel phase's numbers and hold them to the
    contract."""
    sizes = sizes or {}
    for rep in reports:
        r, tp = rep["rank"], rep.get("tensor_parallel")
        if tp is None:
            continue
        if "train" in tp:
            layers = sizes.get("tp_layers")
            _tp_cell_checks(r, "a", f"olmo-1b {layers} of 16 layers at full width", tp,
                            "FTTQ statistics per shard", "b",
                            TP_SAVE_BYTES if layers == 16 else None)
            _tp_serve_checks(r, "c", "olmo-1b", tp["serve"])
            z = tp["zamba2"]
            _tp_cell_checks(r, "e", f"zamba2-1.2b {z['layers']} of 38 layers at full width, "
                            "remat full", z, "FTTQ statistics per shard on the Mamba2 leaves")
            _tp_serve_checks(r, "h", "zamba2-1.2b", z["serve"], half_cache=True)
            mo = tp["moe"]
            _tp_cell_checks(r, "f", f"qwen3-moe-30b-a3b {mo['layers']} of 48 layers at full "
                            "width", mo, "the gates enter the combine without copy_to_model", "g",
                            fault_in_forward=False)
            _tp_a2a_checks(r, tp["a2a"], sizes.get("tp_a2a_layers", "?"))
        _tp_pods_collective_checks(r, "d", f"olmo-1b {sizes.get('tp_pods_layers', '?')} layers",
                                   tp["pods_collective"])
        c = tp["pods_collective"]
        t = tp["pods_train"]
        print(f"rank {r}, tensor_parallel (d) olmo-1b {TP_PODS_LAYERS} of 16 layers, "
              f"{TP_BATCH} x {TP_SEQ} over mesh (2, 1, 2): steps "
              + "; ".join(f"{s['ms']:.1f} ms loss {s['loss']:.6f} launches "
                          f"{json.dumps(s['launches'])} all-gather "
                          f"{s['wire'].get('all_gather', 0)} B" for s in t["steps"])
              + f"; peak {t['peak_gib']:.2f} GiB")
        for s in t["steps"]:
            check(s["launches"]["quantize_pack"] == 1 and s["launches"]["aggregate"] == 2,
                  "a pods x model step launched other than 1 quantize_pack and 2 aggregate")
            check(s["wire"].get("all_gather", 0) == c["want_gather_bytes"],
                  "a pods x model step's all-gather bytes are not the collective's")
        _tp_pods_collective_checks(
            r, "i", f"qwen3-moe-30b-a3b {sizes.get('tp_pods_moe_layers', '?')} layer(s)",
            tp["pods_moe_collective"])


# --------------------------------------------------------------------------
# FSDP: two ranks on the "data" axis, then FSDP x TP and pods x data on four.
# --------------------------------------------------------------------------

FSDP_RANKS = 2               # the "data" axis of (j), (m), (n): mesh (2, 1) over (data, model)
# (j) at full width: a rank's params, m and v, 3 × 4 B × (2^30 / 2 + 103,022,592)
# (the 112 fsdp matrices halved, the tied embedding whole), and its
# all-gather and reduce-scatter bytes a step under remat "none" (each layer
# gathers its weights once; each gradient is reduce-scattered once)
FSDP_STATE_BYTES = 7_678_722_048
FSDP_GATHER_BYTES = 2_147_483_648
FSDP_TP_LAYERS = 4           # (k): olmo-1b cut to 4 of 16 layers on mesh (2, 2)
FSDP_PODS_LAYERS = 4         # (l): olmo-1b cut to 4 of 16 layers on mesh (2, 2, 1)
# (k) 1 step (2 before the bf16_mesh phase; its second step took 11.9 s of
# staged gathers), (l) 2
FSDP_TP_STEPS, FSDP_PODS_STEPS = 1, 2


def _fsdp_want(cfg, mesh, microbatches: int | None = None) -> dict:
    """What a rank of ``mesh`` holds and moves for ``cfg`` (fp32): the bytes
    of its params and both Adam moments, and the bytes it receives to
    gather its data-cut weights once, (P−1) × their shards' bytes, which is
    also its reduce-scatter's count for their gradients. With
    ``microbatches`` (a bf16 cell): params in the cfg's dtype and fp32
    moments, and a step's bytes: each microbatch gathers the weights twice
    under remat "full" (the forward and its recompute) and reduce-scatters
    their gradients once."""
    import math

    from repro_torch.models.transformer import param_shapes
    from repro_torch.parallel.tensor import param_shards
    from repro_torch.tree import flatten_with_path, path_str

    sh = param_shards(cfg, mesh)
    shapes = flatten_with_path(param_shapes(cfg, mesh), is_leaf=lambda x: isinstance(x, tuple))
    cut = sum(math.prod(s) for p, s in shapes
              if any(a.name == "data" for a in sh.axes(path_str(p))))
    n = sum(math.prod(s) for _, s in shapes)
    if microbatches is None:
        return {"state_bytes": 3 * 4 * n, "gather_bytes": 4 * cut * (mesh.size("data") - 1)}
    width = 2 if cfg.param_dtype == "bfloat16" else 4
    once = width * cut * (mesh.size("data") - 1)
    gathers = 2 if cfg.remat == "full" else 1
    return {"state_bytes": (width + 8) * n, "gather_bytes": gathers * microbatches * once,
            "scatter_bytes": microbatches * once}


def fsdp_rank(rank: int, dev, fcfg, sizes: dict, pair, fsdp_mesh, fsdp_tp_mesh,
              pods_data_mesh, out_dir: str, progress=lambda out: None) -> dict:
    """The fsdp phase on one rank of the multidevice spawn: (j) olmo-1b at
    full width over the pair's "data" axis (mesh (2, 1)) against one
    process and a planted fault, (m) the ternary save from its data shards,
    (n) prefill and decode on them; then on all four ranks (k) olmo-1b cut
    to 4 layers over (2, 2) data x model against one process and (l) pods x
    data on (2, 2, 1): the compressed collective on data shards and 2
    compressed steps. ``progress(out)`` is called after each part."""
    import torch.distributed as dist

    from repro_torch.data.synthetic import synthetic_tokens, token_batches
    from repro_torch.launch.train import DATA_SEED

    out = {}
    if fsdp_mesh.member:
        cfg = sizes["fsdp"]
        cell = _tp_cell(fsdp_mesh, pair, dev, cfg, fcfg, out_dir, "fsdp", _fault_own_slice,
                        save=True)
        out.update({k: cell[k] for k in ("codes", "train", "single", "fault", "wall_s")
                    if k in cell}, want=_fsdp_want(cfg, fsdp_mesh))
        progress(out)
        out["serve"] = _tp_serve(fsdp_mesh, dev, cfg, gen=SR_ROWS_GEN)
        progress(out)
    dist.barrier()
    cfg = sizes["fsdp_tp"]
    out["tp"] = _tp_cell(fsdp_tp_mesh, None, dev, cfg, fcfg, out_dir, "fsdp_tp", None,
                         steps=FSDP_TP_STEPS)
    out["tp"]["want"] = _fsdp_want(cfg, fsdp_tp_mesh)
    progress(out)
    dist.barrier()
    cfg = sizes["fsdp_pods"]
    out["pods_collective"] = _tp_pods_collective(pods_data_mesh, dev, cfg, fcfg)
    progress(out)
    dist.barrier()
    tokens = synthetic_tokens(DATA_SEED, TP_BATCH * (TP_SEQ + 1) * FSDP_PODS_STEPS,
                              cfg.vocab_size)
    gen = token_batches(tokens, TP_BATCH, TP_SEQ, device=dev)
    out["pods_train"] = _tp_pods_train(pods_data_mesh, dev, cfg,
                                       [next(gen)[0] for _ in range(FSDP_PODS_STEPS)])
    out["pods_train"]["want"] = _fsdp_want(cfg, pods_data_mesh)
    return out


def fsdp_checks(reports: list, sizes: dict | None = None) -> None:
    """Print the fsdp phase's numbers and hold them to the contract."""
    sizes = sizes or {}
    full = sizes.get("fsdp_layers") == 16
    for rep in reports:
        r, f = rep["rank"], rep.get("fsdp")
        if f is None:
            continue
        if "train" in f:
            want = f["want"]
            _tp_cell_checks(r, "j", f"olmo-1b {sizes.get('fsdp_layers')} of 16 layers at full "
                            "width", f, "the gather's backward keeps its own slice, no "
                            "reduce-scatter", "m", TP_SAVE_BYTES if full else None,
                            part="fsdp", over=f"{FSDP_RANKS} data ranks")
            tr = f["train"]
            print(f"rank {r}, fsdp (j) params, m and v held: {tr['state_bytes']} B (want "
                  f"{want['state_bytes']}; {FSDP_STATE_BYTES} at 16 layers); per step "
                  "all-gather / reduce-scatter "
                  + "; ".join(f"{s['wire'].get('all_gather', 0)} / "
                              f"{s['wire'].get('reduce_scatter', 0)} B" for s in tr["steps"])
                  + f" (want {want['gather_bytes']} each; {FSDP_GATHER_BYTES} at 16 layers)")
            check(tr["state_bytes"] == want["state_bytes"]
                  and (not full or want["state_bytes"] == FSDP_STATE_BYTES),
                  "(j) a data rank's params and Adam moments are not its shards' bytes")
            for s in tr["steps"]:
                check(s["wire"].get("all_gather", 0) == want["gather_bytes"]
                      and s["wire"].get("reduce_scatter", 0) == want["gather_bytes"]
                      and (not full or want["gather_bytes"] == FSDP_GATHER_BYTES),
                      "(j) a step did not gather each data-cut weight and reduce-scatter "
                      "its gradient exactly once")
            # (n) is (o): a batch of 4 over the 2 data ranks, 2 rows each
            _tp_serve_checks(r, "n/o", "olmo-1b, 2 rows a rank,", f["serve"], part="fsdp",
                             half_cache=True)
            one = [q["fsdp"]["serve"]["one_process"]["cache_bytes"] for q in reports
                   if "one_process" in (q.get("fsdp") or {}).get("serve", {})]
            check(one and 2 * f["serve"]["cache_bytes"] == one[0],
                  f"(o) rank {r}'s cache is not half of one process's")
        t = f["tp"]
        for s in t["train"]["steps"]:
            print(f"rank {r}, fsdp (k) olmo-1b {t['layers']} of 16 layers over (2, 2) data x "
                  f"model, {TP_BATCH} x {TP_SEQ}: {s['ms']:.1f} ms ({s['tok_s']:.0f} tok/s) loss "
                  f"{s['loss']:.6f}, {s['gloo_ms']:.1f} ms in gloo calls, wire "
                  f"{json.dumps(s['wire'])}")
        print(f"rank {r}, fsdp (k) params, m and v held: {t['train']['state_bytes']} B (want "
              f"{t['want']['state_bytes']}); peak {t['train']['peak_gib']:.2f} GiB; QAT codes "
              f"of the shards: {t['codes']['differing']} of {t['codes']['codes']} differ, "
              f"{t['codes']['ties']} ties, {t['codes']['left']} left")
        check(t["train"]["state_bytes"] == t["want"]["state_bytes"],
              "(k) an FSDP x TP rank's params and Adam moments are not its shards' bytes")
        check(t["codes"]["differing"] == t["codes"]["ties"] and t["codes"]["left"] == 0,
              "(k) a shard's QAT code differs from the whole leaf's away from a tie")
        if "single" in t:
            g = t["single"]
            print(f"rank {r}, fsdp (k) FSDP x TP vs one process, {len(g['losses'])} steps: "
                  f"one-process losses {g['losses']}; max loss rel gap {g['loss_rel_gap']:.3e} "
                  f"(limit {TP_LOSS_RTOL:g}); params worst leaf ‖Δ‖/‖p‖ {g['param_rel_l2']:.3e} "
                  f"(limit {MD_PARAM_RTOL_L2:g})")
            check(g["loss_rel_gap"] <= TP_LOSS_RTOL and g["param_rel_l2"] <= MD_PARAM_RTOL_L2,
                  "(k) FSDP x TP training disagrees with one process")
        c = f["pods_collective"]
        _tp_pods_collective_checks(r, "l", f"olmo-1b {sizes.get('fsdp_pods_layers', '?')} "
                                   "layers", c, part="fsdp", what="pods x data")
        pt = f["pods_train"]
        w = pt["want"]["gather_bytes"]
        print(f"rank {r}, fsdp (l) olmo-1b {sizes.get('fsdp_pods_layers', '?')} of 16 layers, "
              f"{TP_BATCH} x {TP_SEQ} over mesh (2, 2, 1): steps "
              + "; ".join(f"{s['ms']:.1f} ms loss {s['loss']:.6f} launches "
                          f"{json.dumps(s['launches'])} wire {json.dumps(s['wire'])}"
                          for s in pt["steps"])
              + f"; peak {pt['peak_gib']:.2f} GiB (all-gather want {w} of weights + "
              f"{c['want_gather_bytes']} of codes and w_q)")
        for s in pt["steps"]:
            check(s["launches"]["quantize_pack"] == 1 and s["launches"]["aggregate"] == 2,
                  "(l) a pods x data step launched other than 1 quantize_pack and 2 aggregate")
            check(s["wire"].get("all_gather", 0) == w + c["want_gather_bytes"]
                  and s["wire"].get("reduce_scatter", 0) == w,
                  "(l) a pods x data step's all-gather or reduce-scatter bytes are not its "
                  "weights' and the collective's")


# --------------------------------------------------------------------------
# The reference's bf16 production train cell over the mesh.
# --------------------------------------------------------------------------

# (t) TP (1, 2), (u) FSDP (2, 1) and (v) pods x model (2, 1, 2): olmo-1b at
# its published widths cut to 4 of 16 layers (the script's time), 2 steps
BF16_MESH_LAYERS = 4
BF16_MESH_PODS_LAYERS = 4
BF16_MESH_STEPS = 2
# (t) and (u) against one process's bf16 steps from the same state: the
# largest loss gap over the steps, and the worst leaf's ‖Δparams‖ over the
# one-process update ‖params − start‖ (a bf16 update of 1e-4 moves a weight
# by whole ulps, so the params' own norm would hide it)
BF16_MESH_LOSS_RTOL = 2.0 ** -13
BF16_MESH_UPDATE_L2 = 0.25


def bf16_mesh_cfg(n_layers: int | None = None, base=None):
    """olmo-1b (or ``base``, a config) as ``launch.dryrun.build_cell``
    builds it for a mesh: bf16 params and compute, remat "full", the batch
    constrained to "data", EP over "model" (the a2a MoE, int8 wire)."""
    import dataclasses

    cfg = base if base is not None else bf16_train_cell(n_layers)[0]
    return dataclasses.replace(cfg, param_dtype="bfloat16", compute_dtype="bfloat16",
                               remat="full", mesh_batch_axes=("data",), mesh_ep_axis="model",
                               moe_impl="a2a", moe_wire="int8")


def bf16_mesh_train(pods: bool = False) -> tuple:
    """build_cell's (TrainerConfig, lr): QAT, olmo-1b's 2 microbatches,
    adam(1e-4); with ``pods`` the ternary cross-pod sync with error
    feedback."""
    import dataclasses

    tcfg = bf16_train_cell(1)[1]
    return dataclasses.replace(tcfg, pod_compression=pods, error_feedback=pods), BF16_TRAIN_LR


def bf16_mesh_rank(rank: int, dev, fcfg, sizes: dict, pair, tp_mesh, fsdp_mesh, pods_mesh,
                   out_dir: str, progress=lambda out: None) -> dict:
    """The bf16_mesh phase on one rank of the multidevice spawn: (t) the
    bf16 cell over the pair's "model" axis and (u) over its "data" axis,
    each against one process and a planted fault (FTTQ statistics per
    shard; the FSDP gather's backward keeping its own slice), (u) with its
    ternary save from the data shards; then (v) pods x model on all four
    ranks, 2 compressed bf16 steps, each step's sync held to the plain
    version. ``progress(out)`` is called after each part."""
    import torch.distributed as dist

    from repro_torch.data.synthetic import synthetic_tokens, token_batches
    from repro_torch.launch.train import DATA_SEED

    out = {}
    if tp_mesh.member:
        cfg, train = sizes["bf16"], bf16_mesh_train()
        out["t"] = _tp_cell(tp_mesh, pair, dev, cfg, fcfg, out_dir, "bf16_t", _fault_shard_stats,
                            steps=BF16_MESH_STEPS, train=train)
        progress(out)
        dist.barrier(group=pair)
        out["u"] = _tp_cell(fsdp_mesh, pair, dev, cfg, fcfg, out_dir, "bf16_u", _fault_own_slice,
                            save=True, steps=BF16_MESH_STEPS, train=train)
        out["u"]["want"] = _fsdp_want(cfg, fsdp_mesh, train[0].microbatches)
        progress(out)
    dist.barrier()
    _free()
    cfg, train = sizes["bf16_pods"], bf16_mesh_train(pods=True)
    tokens = synthetic_tokens(DATA_SEED, TP_BATCH * (TP_SEQ + 1) * BF16_MESH_STEPS,
                              cfg.vocab_size)
    gen = token_batches(tokens, TP_BATCH, TP_SEQ, device=dev)
    out["v"] = _tp_pods_train(pods_mesh, dev, cfg,
                              [next(gen)[0] for _ in range(BF16_MESH_STEPS)], train=train,
                              check_sync=True)
    progress(out)
    return out


def bf16_mesh_checks(reports: list, sizes: dict | None = None) -> None:
    """Print the bf16_mesh phase's numbers, then hold them to the contract:
    (t) and (u) their codes (equal but at ties, none after moving them),
    exactly one bf16 qat_backward launch per quantized leaf shard per
    microbatch per step and rank and no fp32 one, the bf16 dtypes, the run
    within BF16_MESH_LOSS_RTOL and BF16_MESH_UPDATE_L2 of one process and
    the planted fault past both; (u) its all-gather and reduce-scatter bytes
    a step and its save (one quantize_pack launch on the rank that writes
    it, none on the other, the one-process save's
    bytes, the codes and scales of the plain version, the records' scales;
    its peak is held in the dryrun phase, ``bf16_mesh_peak_check``); (v)
    per step and rank 1 quantize_pack and 2 aggregate
    launches, the all-gather 0.25 B a shard coordinate plus 4 B a w_q, and
    the sync against the plain version as (d) holds it."""
    sizes = sizes or {}
    failures = []

    def hold(cond, msg):
        if not cond:
            failures.append(msg)

    for rep in reports:
        r, b = rep["rank"], rep.get("bf16_mesh")
        if b is None:
            continue
        for tag, what, over in (("t", "TP (1, 2)", f"{TP_RANKS} model ranks"),
                                ("u", "FSDP (2, 1)", f"{FSDP_RANKS} data ranks")):
            if tag not in b:
                continue
            cell = b[tag]
            c = cell["codes"]
            print(f"rank {r}, bf16_mesh ({tag}) olmo-1b {cell['layers']} of 16 layers, bf16 "
                  f"cell, {what}: {cell['wall_s']:.1f} s for the cell; QAT codes of the "
                  f"seed-0 shards vs the whole leaves: {c['differing']} of {c['codes']} differ, "
                  f"{c['ties']} of them ties at Δ; {c['moved']} weights moved off Δ, {c['left']} "
                  "differing after")
            hold(c["differing"] == c["ties"] and c["left"] == 0,
                 f"({tag}) a shard's QAT code differs from the whole leaf's away from a tie")
            for name in ("train", "fault"):
                run = cell[name]
                want = run["quantized_leaves"] * 2 * len(run["steps"])
                print(f"rank {r}, bf16_mesh ({tag}) {TP_BATCH} x {TP_SEQ} over {over} ({name}): "
                      "steps " + "; ".join(
                          f"{s['ms']:.1f} ms{' traced' if s['traced'] else ''} "
                          f"({s['tok_s']:.0f} tok/s) loss {s['loss']:.6f}, {s['gloo_ms']:.1f} ms "
                          "in gloo calls" + (f", {s['device_ms']:.1f} ms of device kernels"
                                             if "device_ms" in s else "")
                          for s in run["steps"])
                      + f"; peak {run['peak_gib']:.2f} GiB ({run['held_bytes'] / 2 ** 30:.2f} "
                      f"GiB held before); param dtypes {run['dtypes']}; launches "
                      f"{json.dumps(run['launches'])} (qat_backward_bf16 want {want}: "
                      f"{run['quantized_leaves']} quantized leaf shards x 2 microbatches x "
                      f"{len(run['steps'])} steps); wire {json.dumps(run['wire'])}")
                hold(run["launches"]["qat_backward_bf16"] == want
                     and run["launches"]["qat_backward"] == 0,
                     f"({tag}, {name}) qat_backward_bf16 launched "
                     f"{run['launches']['qat_backward_bf16']} times (want {want}), the fp32 "
                     f"entry {run['launches']['qat_backward']} (want 0)")
                hold(run["dtypes"] == ["torch.bfloat16"], f"({tag}) params not bf16")
            if tag == "u":
                w = cell["want"]
                steps = len(cell["train"]["steps"])
                print(f"rank {r}, bf16_mesh (u) state bytes {cell['train']['state_bytes']} "
                      f"(want {w['state_bytes']}); wire over {steps} steps "
                      f"{json.dumps(cell['train']['wire'])} (all-gather want "
                      f"{w['gather_bytes'] * steps}: the data-cut weights twice a microbatch "
                      f"under remat full; reduce-scatter want {w['scatter_bytes'] * steps})")
                hold(cell["train"]["state_bytes"] == w["state_bytes"],
                     "(u) a rank's bf16 state bytes are not its shards'")
                hold(cell["train"]["wire"].get("all_gather", 0) == w["gather_bytes"] * steps
                     and cell["train"]["wire"].get("reduce_scatter", 0)
                     == w["scatter_bytes"] * steps,
                     "(u) the FSDP all-gather or reduce-scatter bytes are not the closed form")
                sv = cell["train"].get("save")
                if sv is not None:
                    print(f"rank {r}, bf16_mesh (u) ternary save from the data shards: "
                          f"{sv['s']:.2f} s, launches {json.dumps(sv['launches'])}"
                          + (f", {sv['bytes']} B, sha256 {sv['sha256']}; {sv['segment_dtype']} "
                             f"segments, {sv['code_bytes_differing']} of {sv['code_bytes']} code "
                             f"bytes differ from the plain version, scales within rtol "
                             f"{sv['scale_rtol']:.2e}, the {sv['records']} records' scales "
                             f"within rtol {sv['record_scale_rtol']:.2e} of the plain ones"
                             if "sha256" in sv else ""))
                    # the mesh's first rank encodes and writes the gathered leaves
                    want = 1 if "sha256" in sv else 0
                    hold(sv["launches"]["quantize_pack"] == want,
                         f"(u) the bf16 save from the shards launched quantize_pack "
                         f"{sv['launches']['quantize_pack']} times on this rank, want {want}")
                    if "sha256" in sv:
                        hold(sv["sha256"] == cell["single"]["save_sha256"],
                             "(u) the bf16 save from the shards differs from the one-process "
                             "save")
                        hold(sv["segment_dtype"] == "torch.bfloat16"
                             and sv["code_bytes_differing"] == 0 and sv["scale_rtol"] <= 1e-6
                             and sv["record_scale_rtol"] <= 1e-6,
                             "(u) the bf16 save's codes or scales differ from the plain "
                             "version's")
            if "single" in cell:
                for name, g in (("sharded run", cell["single"]),
                                ("planted fault", cell["fault"]["gaps"])):
                    print(f"rank {r}, bf16_mesh ({tag}) {name} vs one process, "
                          f"{len(cell['train']['steps'])} steps: one-process losses "
                          f"{cell['single']['losses']}; max loss rel gap "
                          f"{g['loss_rel_gap']:.3e} (limit {BF16_MESH_LOSS_RTOL:.3e}); params "
                          f"worst leaf ‖Δ‖/‖update‖ {g['update_rel_l2']:.3e} (limit "
                          f"{BF16_MESH_UPDATE_L2:g}), ‖Δ‖/‖p‖ {g['param_rel_l2']:.3e}, max |Δ| / "
                          f"max |p| {g['param_rel_gap']:.3e}")
                g, f = cell["single"], cell["fault"]["gaps"]
                hold(g["loss_rel_gap"] <= BF16_MESH_LOSS_RTOL
                     and g["update_rel_l2"] <= BF16_MESH_UPDATE_L2,
                     f"({tag}) bf16 {what} training disagrees with one process")
                hold(f["loss_rel_gap"] > BF16_MESH_LOSS_RTOL
                     and f["update_rel_l2"] > BF16_MESH_UPDATE_L2,
                     f"({tag}) a limit of the bf16 checks does not catch the planted fault")
        v = b["v"]
        print(f"rank {r}, bf16_mesh (v) olmo-1b {sizes.get('bf16_pods_layers', '?')} of 16 "
              f"layers, bf16 cell, {TP_BATCH} x {TP_SEQ} over mesh (2, 1, 2): param dtypes "
              f"{v['dtypes']}; peak {v['peak_gib']:.2f} GiB; steps " + "; ".join(
                  f"{s['ms']:.1f} ms loss {s['loss']:.6f} launches {json.dumps(s['launches'])} "
                  f"all-gather {s['wire'].get('all_gather', 0)} B (want "
                  f"{s['want_gather_bytes']}); sync inputs {s['sync_dtypes']}, code flips "
                  f"{s['code_flips']} ({s['proven_ties']} proven ties), mean rel gap "
                  f"{s['mean_rel_gap']:.3e}, residual rel gap {s['residual_rel_gap']:.3e}"
                  for s in v["steps"]))
        hold(v["dtypes"] == ["torch.bfloat16"], "(v) params not bf16")
        for s in v["steps"]:
            hold(s["launches"]["quantize_pack"] == 1 and s["launches"]["aggregate"] == 2
                 and s["launches"]["qat_backward"] == 0,
                 "(v) a bf16 pods x model step launched other than 1 quantize_pack and 2 "
                 "aggregate, or the fp32 QAT backward")
            hold(s["wire"].get("all_gather", 0) == s["want_gather_bytes"],
                 "(v) a bf16 pods x model step's all-gather is not 0.25 B a shard coordinate "
                 "plus 4 B a w_q")
            hold(s["code_flips"] == s["proven_ties"]
                 and s["mean_rel_gap"] <= 1e-6 and s["residual_rel_gap"] <= 1e-6,
                 "(v) the bf16 pods x model sync disagrees with the plain version")
    check(not failures, "; ".join(failures))


def bf16_mesh_peak_check(est: dict, reports: list) -> None:
    """The dry-run's estimates of (t) and (u) against each rank's measured
    peak over what it held before the run: (u) within DRYRUN_PEAK_REL,
    (t) printed beside it."""
    for rep_ in reports:
        b = rep_.get("bf16_mesh") or {}
        for tag in ("t", "u"):
            if tag not in b:
                continue
            tr = b[tag]["train"]
            measured = tr["peak_bytes"] - tr["held_bytes"]
            e = est[f"bf16_{tag}"]
            rel = e["memory"]["peak_estimate_bytes"] / measured - 1
            print(f"dryrun: bf16_mesh ({tag}) rank {rep_['rank']}: params, m and v "
                  f"{sum(e['state_parts'][k] for k in ('params', 'm', 'v'))} B estimated, "
                  f"{tr['state_bytes']} B measured; peak estimate "
                  f"{e['memory']['peak_estimate_bytes'] / 2 ** 30:.2f} GiB, measured "
                  f"{measured / 2 ** 30:.2f} GiB over the {tr['held_bytes'] / 2 ** 30:.2f} GiB "
                  f"held before: {100 * rel:+.1f}%"
                  + (f" (limit ±{100 * DRYRUN_PEAK_REL:.0f}%)" if tag == "u" else " (printed)")
                  + f"; collectives {json.dumps(e['collective'])}")
            if tag == "u":
                check(abs(rel) <= DRYRUN_PEAK_REL,
                      "the dry-run's bf16 FSDP (u) peak estimate is off the measured peak")
                check(sum(e["state_parts"][k] for k in ("params", "m", "v")) == tr["state_bytes"],
                      "the dry-run's bf16 FSDP (u) state bytes are not the measured ones")


# --------------------------------------------------------------------------
# Serving rows and sequence-cut caches over the batch axes.
# --------------------------------------------------------------------------

# (p): olmo-1b at its published widths cut to SR_LONG_LAYERS of 16 layers,
# batch 1, its cache's sequence over the 2 data ranks; the 2,044-token
# prompt fills rank 0's first 2,044 of 2,048 slots and the decode's fifth
# step writes rank 1's first slot, position 2,048 (6 steps: the depth and
# the steps cut from 16 to make room for (r), (s) and the bf16_train phase
# in the script's time; the depth from 8 to 4 for the bf16_mesh phase)
SR_LONG_PROMPT, SR_LONG_GEN, SR_LONG_SLOTS = 2044, 6, 4096
SR_LONG_LAYERS = 4
# (o) = the fsdp part's (n): 4 decode steps (cut from 8 for the same reason)
SR_ROWS_GEN = 4
# (q): granite-20b (MQA) cut to 4 of 52 layers, batch 2 on (1, 2), its
# cache's sequence over "model"
SR_MQA_LAYERS = 4
SR_MQA_PROMPTS, SR_MQA_PROMPT, SR_MQA_GEN = 2, 64, 8


def serve_rows_rank(rank: int, dev, sizes: dict, fsdp_mesh, tp_mesh,
                    progress=lambda out: None) -> dict:
    """The serve_rows part on ranks 0 and 1 of the spawn: (p) olmo-1b batch 1
    with its cache's sequence over "data" (mesh (2, 1)), (q) granite-20b's
    MQA with its cache's sequence over "model" (mesh (1, 2)); each against
    one process (``_tp_serve``)."""
    out = {}
    if fsdp_mesh.member:
        out["p"] = _tp_serve(fsdp_mesh, dev, sizes["serve_long"], prompts=1,
                             prompt=SR_LONG_PROMPT, gen=SR_LONG_GEN, max_seq=SR_LONG_SLOTS)
        progress(out)
    if tp_mesh.member:
        out["q"] = _tp_serve(tp_mesh, dev, sizes["serve_mqa"], prompts=SR_MQA_PROMPTS,
                             prompt=SR_MQA_PROMPT, gen=SR_MQA_GEN)
        progress(out)
    return out


def serve_rows_checks(reports: list, sizes: dict | None = None) -> None:
    """Print (p) and (q) and hold them to one process: logits, tokens, and
    every rank's cache exactly half of one process's."""
    sizes = sizes or {}
    one = {}
    for rep in reports:
        sr = rep.get("serve_rows") or {}
        for tag in ("p", "q"):
            if "one_process" in sr.get(tag, {}):
                one[tag] = sr[tag]["one_process"]["cache_bytes"]
    for rep in reports:
        r, sr = rep["rank"], rep.get("serve_rows") or {}
        if "p" in sr:
            p = sr["p"]
            _tp_serve_checks(r, "p", f"olmo-1b {sizes.get('serve_long_layers', '?')} of 16 "
                             "layers, batch 1, the cache's sequence over 2 data ranks,", p,
                             part="serve_rows", half_cache=True)
            cross = SR_LONG_SLOTS // 2 - SR_LONG_PROMPT     # the first step on rank 1's slots
            print(f"rank {r}, serve_rows (p) decode step ms: "
                  + ", ".join(f"{ms:.1f}" + (" [last on rank 0's slots]" if i == cross - 1
                                             else " [first on rank 1's slots]" if i == cross
                                             else "") for i, ms in enumerate(p["step_ms"]))
                  + (", one process: " + ", ".join(f"{ms:.1f}" for ms in
                                                   p["one_process"]["step_ms"])
                     if "one_process" in p else ""))
        if "q" in sr:
            _tp_serve_checks(r, "q", f"granite-20b {sizes.get('serve_mqa_layers', '?')} of 52 "
                             "layers (MQA), the cache's sequence over 2 model ranks,", sr["q"],
                             part="serve_rows", half_cache=True)
        for tag in ("p", "q"):
            if tag in sr:
                check(tag in one and 2 * sr[tag]["cache_bytes"] == one[tag],
                      f"({tag}) rank {r}'s cache is not half of one process's")


# --------------------------------------------------------------------------
# More "model" ranks than query heads: sixteen ranks on the card.
# --------------------------------------------------------------------------

# (s) gemma3-4b at its published widths (d 2,560, 8 query and 4 kv heads of
# width 256, vocab 262,144) cut to 6 of 34 layers, so that its one global
# layer (index 5) follows five sliding-window ones, over a (1, 16) data x
# model mesh: each rank's wq columns are half a query head, its wk/wv
# columns a quarter of a kv head, and the cache's sequence is cut over
# "model" (4 kv heads for 16 ranks)
MH_RANKS = 16
MH_LAYERS = 6
# 2 decode steps, cut from 8 to make room for the bf16_train phase
MH_PROMPTS, MH_PROMPT, MH_GEN, MH_SLOTS = 2, 64, 2, 128
MH_TIMEOUT_S = 600


def _scatter_tree(whole, cfg, mesh, dev):
    """This rank's shards of a params-shaped tree of ``cfg`` that the
    mesh's first rank holds whole (``whole``; None on the others), in
    ``param_shapes``' order: one gloo scatter of host copies per leaf cut
    over "model", one broadcast per whole leaf. No rank but the first ever
    holds a whole leaf."""
    import torch
    import torch.distributed as dist

    from repro_torch.models.transformer import param_shapes
    from repro_torch.parallel.tensor import param_shards
    from repro_torch.tree import flatten_with_path, path_str, tree_map_with_path

    sh = param_shards(cfg, mesh)
    src = {path_str(p): t for p, t in flatten_with_path(whole)} if whole is not None else {}
    group, root = mesh.group("model"), mesh.ranks[0]

    def one(path, shape):
        name = path_str(path)
        buf = torch.empty(shape, dtype=cfg.pdtype())
        cut = sh.cuts.get(name, ())
        if cut:
            (ax, d), = cut
            parts = ([c.contiguous().cpu() for c in src[name].chunk(ax.size, d)]
                     if name in src else None)
            dist.scatter(buf, parts, src=root, group=group)
        else:
            if name in src:
                buf.copy_(src[name])
            dist.broadcast(buf, src=root, group=group)
        return buf.to(dev)

    return tree_map_with_path(one, param_shapes(cfg, mesh), is_leaf=lambda x: isinstance(x, tuple))


def _shard_code_flips(whole, shards, cfg, fcfg, mesh) -> dict:
    """The QAT codes of this rank's shards from the statistics the shards
    reduce over "model" against those from the whole leaves' (the first
    rank's, ``whole``, broadcast), over every quantizable leaf that "model"
    cuts: the codes, the differing ones, and how many of those are ties
    (|θ_s| within 1e-6 of Δ); summed over the ranks on the first rank."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import fttq
    from repro_torch.parallel.tensor import param_shards
    from repro_torch.tree import flatten_with_path, path_str

    sh = param_shards(cfg, mesh)
    src = {path_str(p): t for p, t in flatten_with_path(whole)} if whole is not None else {}
    group, root = mesh.group("model"), mesh.ranks[0]
    counts = torch.zeros(3, dtype=torch.float64)
    for path, shard in flatten_with_path(shards):
        name = path_str(path)
        if not fttq.is_quantizable(path, shard, fcfg) or name not in sh.cuts:
            continue
        n_rows = shard.shape[0] if shard.ndim >= 3 else 1
        rows = shard.reshape(n_rows, -1)
        (denom, delta), = fttq.leaf_row_stats([rows], fcfg.t_k, [sh.axes(name)])
        stats = torch.empty((2, n_rows, 1), dtype=rows.dtype)
        if name in src:
            (d_w, t_w), = fttq.leaf_row_stats([src[name].reshape(n_rows, -1)], fcfg.t_k, [()])
            stats.copy_(torch.stack([d_w, t_w]))
        dist.broadcast(stats, src=root, group=group)
        d_w, t_w = stats.to(rows.device)
        diff = fttq.scaled_codes(rows, denom, delta) != fttq.scaled_codes(rows, d_w, t_w)
        gap = ((rows / d_w).abs() - t_w).abs()
        counts += torch.tensor([diff.numel(), int(diff.sum()),
                                int((gap <= 1e-6 * t_w.expand_as(gap))[diff].sum())],
                               dtype=torch.float64)
    dist.reduce(counts, dst=root, group=group)
    return dict(zip(("codes", "differing", "ties"), (int(x) for x in counts)))


def midhead_rank(rank: int, world: int, rdv: str, out_dir: str, device: str, cfg,
                 spawned: float) -> None:
    """One of the sixteen ranks of (s): joins the gloo group; the first
    rank draws gemma3-4b's seed-0 params once, on the card, and hands every
    rank its shards; then (a) ``launch/steps.py``'s prefill and decode with
    the cache's sequence over "model", against one process on the first
    rank (``_tp_serve``), and (b) the QAT step's first gradients over the
    mesh, each rank's moved to the host, the card freed, then one process's
    on the first rank from the same params, scattered as shards and held
    leaf by leaf over the whole leaves. Writes its report to ``out_dir``."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.core.fttq import FTTQConfig, init_wq_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adam
    from repro_torch.parallel.tensor import param_shards
    from repro_torch.train import TrainerConfig, init_train_state, make_grad_fn

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=MH_TIMEOUT_S))
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.empty(1, device=dev)
    dist.barrier()
    report = {"rank": rank, "ready_s": time.time() - spawned}
    mesh = make_mesh((1, world), ("data", "model"), device=device)
    first = rank == mesh.ranks[0]
    fcfg = FTTQConfig()
    t0 = time.perf_counter()
    whole = init_params(cfg, seed=0, device=dev) if first else None
    shards = _scatter_tree(whole, cfg, mesh, dev)
    report["handout_s"] = time.perf_counter() - t0
    report["codes"] = _shard_code_flips(whole, shards, cfg, fcfg, mesh)
    del whole
    _free()
    report["serve"] = _tp_serve(mesh, dev, cfg, prompts=MH_PROMPTS, prompt=MH_PROMPT,
                                gen=MH_GEN, max_seq=MH_SLOTS, shards=shards)
    _free()
    toks = torch.randint(0, cfg.vocab_size, (MH_PROMPTS, MH_PROMPT + 1),
                         generator=torch.Generator(dev).manual_seed(3), device=dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tcfg = TrainerConfig(fttq=fcfg)
    sh = param_shards(cfg, mesh)
    state = init_train_state(cfg, tcfg, adam(TRAIN_LR), params=shards, device=dev)
    state.wq = init_wq_tree(shards, fcfg, sh)
    _sync(dev)
    t0 = time.perf_counter()
    loss, _, grads, _ = make_grad_fn(cfg, tcfg, mesh)(state, batch)
    _sync(dev)
    report["grad_ms"] = (time.perf_counter() - t0) * 1e3
    report["loss"] = float(loss)
    grads = _host_tree(grads)
    del state, shards
    _free()
    dist.barrier()
    ref = None
    if first:
        whole = init_params(cfg, seed=0, device=dev)
        state = init_train_state(cfg, tcfg, adam(TRAIN_LR), params=whole, device=dev)
        del whole
        _sync(dev)
        t0 = time.perf_counter()
        loss1, _, ref, _ = make_grad_fn(cfg, tcfg)(state, batch)
        _sync(dev)
        report["one_process"] = {"grad_ms": (time.perf_counter() - t0) * 1e3,
                                 "loss": float(loss1)}
        del state
    ref_shards = _scatter_tree(ref, cfg, mesh, torch.device("cpu"))
    del ref
    _free()
    gaps = _leaf_gaps(grads, ref_shards, sh)
    if first:
        worst = max(gaps, key=gaps.get)
        report["one_process"].update(
            loss_rel_gap=abs(report["loss"] - report["one_process"]["loss"])
            / abs(report["one_process"]["loss"]), worst_leaf=worst, worst_rel_l2=gaps[worst])
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()


def midhead_phase(device: str = "cuda:0", cfg=None, world: int = MH_RANKS) -> dict:
    """(s): ``world`` ranks spawned on the one card over gloo (a file
    rendezvous in a temporary directory), each running ``midhead_rank``. A
    rank that fails or does not finish in time fails the phase; every
    process is stopped."""
    import multiprocessing as mp
    import tempfile

    from repro_torch.configs import get_config

    cfg = cfg or get_config("gemma3-4b", n_layers=MH_LAYERS)
    ctx = mp.get_context("spawn")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        spawned = time.time()
        procs = [ctx.Process(target=midhead_rank,
                             args=(r, world, os.path.join(tmp, "rdv"), tmp, device, cfg,
                                   spawned)) for r in range(world)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + MH_TIMEOUT_S
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
            codes = [p.exitcode for p in procs]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        reports = []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.json")
            if os.path.exists(path):
                with open(path) as f:
                    reports.append(json.load(f))
        check(all(c == 0 for c in codes), f"a midhead rank failed or hung: exit codes {codes}")
    return {"reports": reports, "wall_s": time.perf_counter() - t0, "world": world,
            "layers": cfg.n_layers}


def midhead_checks(mh: dict) -> None:
    """Print (s) and hold it: every rank's logits within TP_LOGITS_REL of
    one process's, the same tokens, each rank's cache 1/world of one
    process's bytes; the first step's loss within TP_LOSS_RTOL and worst
    leaf ‖Δg‖/‖g‖ within MD_PARAM_RTOL_L2 of one process."""
    reports, world = mh["reports"], mh["world"]
    check(len(reports) == world, f"(s) {len(reports)} of {world} ranks reported")
    first = reports[0]
    one = first["serve"]["one_process"]
    print(f"midhead (s) gemma3-4b {mh['layers']} of 34 layers at full width over {world} model "
          f"ranks: {mh['wall_s']:.1f} s for the spawn; ranks ready "
          f"{min(r['ready_s'] for r in reports):.1f}-{max(r['ready_s'] for r in reports):.1f} s "
          f"after the spawn; params drawn once and handed out in {first['handout_s']:.1f} s")
    _tp_serve_checks(0, "s", f"gemma3-4b {mh['layers']} of 34 layers over {world} model ranks "
                     "(half a query head a rank), the cache's sequence over 'model',",
                     first["serve"], part="midhead")
    for r in reports:
        print(f"rank {r['rank']}, midhead (s) cache {r['serve']['cache_bytes']} B, prefill "
              f"{r['serve']['prefill_ms']:.1f} ms, decode steps "
              + ", ".join(f"{ms:.1f}" for ms in r["serve"]["step_ms"])
              + f" ms; first gradients {r['grad_ms']:.1f} ms, loss {r['loss']:.7f}")
        check(world * r["serve"]["cache_bytes"] == one["cache_bytes"],
              f"(s) rank {r['rank']}'s cache is not 1/{world} of one process's")
    c = first["codes"]
    print(f"midhead (s) QAT codes of the seed-0 shards from the statistics the shards reduce "
          f"vs the whole leaves': {c['differing']} of {c['codes']} differ, {c['ties']} of them "
          "ties at Δ (left in place)")
    check(c["differing"] == c["ties"], "(s) a shard's QAT code differs from the whole leaf's "
                                       "away from a tie at Δ")
    g = first["one_process"]
    print(f"midhead (s) the first QAT step's gradients over {world} ranks vs one process "
          f"({g['grad_ms']:.1f} ms): loss {first['loss']:.7f} vs {g['loss']:.7f}, rel gap "
          f"{g['loss_rel_gap']:.3e} (limit {TP_LOSS_RTOL:g}); worst leaf ‖Δg‖/‖g‖ "
          f"{g['worst_rel_l2']:.3e} ({g['worst_leaf']}; limit {MD_PARAM_RTOL_L2:g})")
    check(g["loss_rel_gap"] <= TP_LOSS_RTOL and g["worst_rel_l2"] <= MD_PARAM_RTOL_L2,
          "(s) the mid-head tensor-parallel step disagrees with one process")


# --------------------------------------------------------------------------
# The dry-run's estimate of three train cells, against their measurement.
# --------------------------------------------------------------------------

DRYRUN_PEAK_REL = 0.2        # the one-device peak estimate against the measured peak

_DRYRUN_CODE = """
import json, sys
sys.path.insert(0, {src!r})
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import TrainKind, estimate_step
from repro_torch.train import TrainerConfig
from repro_torch.launch.dryrun import MICROBATCHES
out = {{}}
fp32 = (get_config("olmo-1b"), TrainKind(TrainerConfig(), lr={lr!r}), ({b}, {s}))
bf16 = (get_config("olmo-1b", param_dtype="bfloat16", compute_dtype="bfloat16", remat="full"),
        TrainKind(TrainerConfig(qat=True, microbatches=MICROBATCHES["olmo-1b"]), lr={bf16_lr!r}),
        ({bf16_b}, {bf16_s}))
mesh_cfg = get_config("olmo-1b", n_layers={bf16_mesh_layers}, param_dtype="bfloat16",
                      compute_dtype="bfloat16", remat="full", mesh_batch_axes=("data",),
                      mesh_ep_axis="model", moe_impl="a2a", moe_wire="int8")
bf16_mesh = (mesh_cfg, bf16[1], ({tp_b}, {tp_s}))
for name, (cfg, kind, shape_bs), shape, axes in (
        ("one_device", fp32, (1,), ("data",)), ("bf16_train", bf16, (1,), ("data",)),
        ("fsdp_j", (get_config("olmo-1b", n_layers={fsdp_layers}),) + fp32[1:], (2, 1),
         ("data", "model")), ("bf16_t", bf16_mesh, (1, 2), ("data", "model")),
        ("bf16_u", bf16_mesh, (2, 1), ("data", "model"))):
    r = estimate_step(cfg, kind, shape_bs, shape, axes)
    out[name] = {{"memory": r["memory"], "state_parts": r["state_parts"],
                  "flops": r["hlo"]["flops_per_device"],
                  "collective": r["hlo"]["collective_breakdown"], "seconds": r["seconds"]}}
print(json.dumps(out))
"""


def dryrun_start():
    """Start, in a process of its own (one process holds one default group),
    ``launch.dryrun.estimate_step`` on olmo-1b's one-device train cell (fp32,
    8 x 512, remat "none": the train phase's first run) and on the fsdp
    part's (j) (the same over a (2, 1) data x model mesh of a "fake" group):
    rank 0's state bytes, peak estimate, FLOPs and collectives. It runs on
    the CPU beside the card's phases; ``dryrun_finish`` reads it."""
    import subprocess

    b, s = TRAIN_RUNS[0][:2]
    code = _DRYRUN_CODE.format(src=SRC, lr=TRAIN_LR, b=b, s=s, bf16_lr=BF16_TRAIN_LR,
                               bf16_b=BF16_TRAIN_BATCH, bf16_s=BF16_TRAIN_SEQ,
                               fsdp_layers=FSDP_OLMO_LAYERS, bf16_mesh_layers=BF16_MESH_LAYERS,
                               tp_b=TP_BATCH, tp_s=TP_SEQ)
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def dryrun_estimates(proc) -> dict:
    """The estimates ``dryrun_start``'s process printed."""
    try:
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0, f"the dry-run estimate failed: {stderr[-3000:]}")
    return json.loads(stdout.strip().splitlines()[-1])


def dryrun_finish(proc, train: dict, md: dict, bf16_train: dict) -> dict:
    """The estimates of ``dryrun_start`` against the train phase's first run,
    the bf16_train phase's run, (j) and the bf16_mesh phase's (t) and (u):
    the params' and Adam moments' bytes exactly, each one-device peak and
    (u)'s within ``DRYRUN_PEAK_REL`` of the run's peak over what was held
    before it; (j)'s and (t)'s peaks printed beside their measurements,
    unchecked (two fp32 ranks' peaks moved by up to 7 GiB between runs)."""
    est = dryrun_estimates(proc)
    run = train["full_width"]["runs"][0]
    one = est["one_device"]
    mine = lambda e: e["state_parts"]["params"] + e["state_parts"]["m"] + e["state_parts"]["v"]
    measured = run["peak_bytes"] - run["held_bytes"]
    rel = one["memory"]["peak_estimate_bytes"] / measured - 1
    print(f"dryrun: olmo-1b one-device train cell ({run['batch']} x {run['seq']}, remat "
          f"{run['remat']}, fp32): params, m and v {mine(one)} B estimated, "
          f"{run['state_bytes']} B measured; peak estimate "
          f"{one['memory']['peak_estimate_bytes'] / 2 ** 30:.2f} GiB (arguments "
          f"{one['memory']['argument_bytes_per_device'] / 2 ** 30:.2f} + step "
          f"{one['memory']['temp_bytes_per_device'] / 2 ** 30:.2f}), measured "
          f"{measured / 2 ** 30:.2f} GiB (max_memory_allocated {run['peak_gib']:.2f} GiB less "
          f"{run['held_gib']:.2f} GiB earlier phases held): {100 * rel:+.1f}% (limit "
          f"±{100 * DRYRUN_PEAK_REL:.0f}%); {one['flops']:.4e} FLOPs counted; estimated in "
          f"{one['seconds']:.1f} s")
    check(mine(one) == run["state_bytes"],
          "the dry-run's one-device state bytes are not the measured ones")
    check(abs(rel) <= DRYRUN_PEAK_REL,
          "the dry-run's one-device peak estimate is off the measured peak")
    run, one = bf16_train["full_width"], est["bf16_train"]
    measured = run["peak_bytes"] - run["held_bytes"]
    rel = one["memory"]["peak_estimate_bytes"] / measured - 1
    print(f"dryrun: olmo-1b bf16 train cell ({run['batch']} x {run['seq']}, microbatches "
          f"{run['microbatches']}, remat {run['remat']}): params, m and v {mine(one)} B "
          f"estimated, {run['state_bytes']} B measured; peak estimate "
          f"{one['memory']['peak_estimate_bytes'] / 2 ** 30:.2f} GiB (arguments "
          f"{one['memory']['argument_bytes_per_device'] / 2 ** 30:.2f} + step "
          f"{one['memory']['temp_bytes_per_device'] / 2 ** 30:.2f}), measured "
          f"{measured / 2 ** 30:.2f} GiB: {100 * rel:+.1f}% (limit "
          f"±{100 * DRYRUN_PEAK_REL:.0f}%); {one['flops']:.4e} FLOPs counted; estimated in "
          f"{one['seconds']:.1f} s")
    check(mine(one) == run["state_bytes"],
          "the dry-run's bf16 state bytes are not the measured ones")
    check(abs(rel) <= DRYRUN_PEAK_REL,
          "the dry-run's bf16 train cell's peak estimate is off the measured peak")
    j = est["fsdp_j"]
    got = [rep["fsdp"]["train"] for rep in md["reports"]
           if "train" in (rep.get("fsdp") or {})]
    for r, tr in enumerate(got):
        print(f"dryrun: fsdp (j) rank {r}: params, m and v {mine(j)} B estimated, "
              f"{tr['state_bytes']} B measured ({FSDP_STATE_BYTES} at 16 layers); peak "
              f"estimate {j['memory']['peak_estimate_bytes'] / 2 ** 30:.2f} GiB, measured "
              f"{tr['peak_gib']:.2f} GiB (not held: two ranks' peaks move between runs); "
              f"collectives {json.dumps(j['collective'])}; estimated in {j['seconds']:.1f} s")
        check(mine(j) == tr["state_bytes"]
              and (FSDP_OLMO_LAYERS != 16 or tr["state_bytes"] == FSDP_STATE_BYTES),
              "the dry-run's (j) state bytes are not the measured ones")
    check(len(got) == FSDP_RANKS, "the fsdp part's (j) reports are missing")
    bf16_mesh_peak_check(est, md["reports"])
    return est


def multidevice_rank(rank: int, world: int, rdv: str, out_dir: str, device: str,
                     sizes: dict) -> None:
    """One rank of the multidevice phase (a spawned process): joins the gloo
    group through ``rdv``; ranks 0 and 1 run (a) the collective, (c) the
    fan-in, (d) the MoE and (b) training, then the tensor_parallel phase's
    (a)-(c) on their "model" axis; all ranks run its (d), pods x model; then
    the fsdp phase's (j), (m) and (n) on ranks 0 and 1 and its (k) and (l)
    on all. It writes its report to ``out_dir``."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.core.fttq import FTTQConfig
    from repro_torch.launch.mesh import AXES, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=MD_TIMEOUT_S))
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    pair_ranks = list(range(MD_RANKS))
    pair = dist.new_group(pair_ranks)
    mesh = make_mesh((MD_RANKS, 1, 1), AXES, ranks=pair_ranks, device=device)
    mesh_data = make_mesh((MD_RANKS,), ("data",), ranks=pair_ranks, device=device)
    mesh_ep = make_mesh((1, MD_RANKS), ("data", "model"), ranks=pair_ranks, device=device)
    # (data, model): no "pod" axis, whose compressed sync the reference runs even at size 1
    tp_mesh = make_mesh((1, TP_RANKS), ("data", "model"), ranks=pair_ranks, device=device)
    pods_mesh = (make_mesh((2, 1, 2), AXES, device=device) if world == 4 else None)
    fsdp_mesh = make_mesh((FSDP_RANKS, 1), ("data", "model"), ranks=pair_ranks, device=device)
    fsdp_tp_mesh = (make_mesh((2, 2), ("data", "model"), device=device) if world == 4 else None)
    pods_data_mesh = (make_mesh((2, 2, 1), AXES, device=device) if world == 4 else None)
    parts = sizes["parts"]
    report = {"rank": rank, "device": str(dev)}
    path = os.path.join(out_dir, f"rank{rank}.json")

    def save():
        with open(path, "w") as f:
            json.dump(report, f)

    t0 = time.perf_counter()
    if mesh.member and "collective" in parts:
        report["collective"] = _md_collective(mesh, dev, sizes["olmo"], FTTQConfig())
        save()
        dist.barrier(group=pair)
        report["fanin"] = _md_fanin(dev, mesh_data)
        save()
        dist.barrier(group=pair)
        report["moe"] = _md_moe(dev, mesh_ep, sizes["moe"])
        save()
        dist.barrier(group=pair)
        report["train"] = _md_train(mesh, dev, sizes["train"], sizes["batch"], sizes["seq"],
                                    sizes["steps"])
        save()
        dist.barrier(group=pair)
    if "tensor_parallel" in parts:
        def progress(tp_out):
            report["tensor_parallel"] = tp_out
            save()

        report["tensor_parallel"] = tensor_parallel_rank(rank, dev, FTTQConfig(), sizes, pair,
                                                         tp_mesh, pods_mesh, out_dir, progress)
        save()
        dist.barrier()
    if "fsdp" in parts:
        _free()            # the blocks earlier parts left in every rank's cache

        def fsdp_progress(f_out):
            report["fsdp"] = f_out
            save()

        report["fsdp"] = fsdp_rank(rank, dev, FTTQConfig(), sizes, pair, fsdp_mesh,
                                   fsdp_tp_mesh, pods_data_mesh, out_dir, fsdp_progress)
        save()
        dist.barrier()
    if "serve_rows" in parts:
        _free()

        def rows_progress(sr_out):
            report["serve_rows"] = sr_out
            save()

        report["serve_rows"] = serve_rows_rank(rank, dev, sizes, fsdp_mesh, tp_mesh,
                                               rows_progress)
        dist.barrier()
    if "bf16_mesh" in parts:
        _free()

        def bf16_progress(b_out):
            report["bf16_mesh"] = b_out
            save()

        report["bf16_mesh"] = bf16_mesh_rank(rank, dev, FTTQConfig(), sizes, pair, tp_mesh,
                                             fsdp_mesh, pods_mesh, out_dir, bf16_progress)
    report["rank_s"] = time.perf_counter() - t0
    save()
    dist.destroy_process_group()


def multidevice_phase(device: str = "cuda:0", olmo_cfg=None, moe_cfg=None, train_cfg=None,
                      batch: int = MD_BATCH, seq: int = MD_SEQ, steps: int = MD_STEPS,
                      tp_cfg=None, tp_pods_cfg=None, tp_zamba_cfg=None, tp_moe_cfg=None,
                      tp_pods_moe_cfg=None, tp_a2a_cfg=None, fsdp_cfg=None, fsdp_tp_cfg=None,
                      fsdp_pods_cfg=None,
                      serve_long_cfg=None, serve_mqa_cfg=None, bf16_cfg=None,
                      bf16_pods_cfg=None,
                      parts: tuple = ("collective", "tensor_parallel", "fsdp",
                                      "serve_rows", "bf16_mesh")) -> dict:
    """Ranks spawned on the one card over gloo (a file rendezvous in a
    temporary directory), in one spawn: on two of them (a) the collective at
    full width, (c) the client-sharded fan-in, (d) the expert-parallel MoE,
    (b) compressed multi-pod training, then the tensor_parallel phase on the
    two (its (a)-(c), (e)-(h)) and on four (its (d), (i)), then the fsdp
    phase on two (its (j), (m), (n)) and on four (its (k), (l)), the
    serve_rows phase, and the bf16_mesh phase on two (its (t), (u)) and on
    four (its (v)). ``parts`` names the parts to run. A rank that fails or does not finish in time
    fails the phase; every process is stopped."""
    import multiprocessing as mp
    import tempfile

    from repro_torch.configs import get_config

    sizes = {"olmo": olmo_cfg or get_config("olmo-1b"),
             "moe": moe_cfg or get_config("qwen3-moe-30b-a3b", n_layers=MD_MOE_LAYERS,
                                          capacity_factor=16.0, mesh_batch_axes=("data",),
                                          mesh_ep_axis="model"),
             "train": train_cfg or get_config("olmo-1b", n_layers=MD_TRAIN_LAYERS),
             "tp": tp_cfg or get_config("olmo-1b", n_layers=TP_OLMO_LAYERS),
             "tp_pods": tp_pods_cfg or get_config("olmo-1b", n_layers=TP_PODS_LAYERS),
             # remat "full": each Mamba2 layer would keep ~1.2 GB of SSD
             # intermediates for the backward, ~45 GB over 38 layers
             "tp_zamba": tp_zamba_cfg or get_config("zamba2-1.2b", remat="full",
                                                    n_layers=TP_ZAMBA_LAYERS),
             "tp_moe": tp_moe_cfg or get_config("qwen3-moe-30b-a3b", n_layers=TP_MOE_LAYERS),
             "tp_pods_moe": tp_pods_moe_cfg or get_config("qwen3-moe-30b-a3b",
                                                          n_layers=TP_PODS_MOE_LAYERS),
             "tp_a2a": tp_a2a_cfg or get_config("qwen3-moe-30b-a3b", n_layers=TP_A2A_LAYERS),
             "fsdp": fsdp_cfg or get_config("olmo-1b", n_layers=FSDP_OLMO_LAYERS),
             "fsdp_tp": fsdp_tp_cfg or get_config("olmo-1b", n_layers=FSDP_TP_LAYERS),
             "fsdp_pods": fsdp_pods_cfg or get_config("olmo-1b", n_layers=FSDP_PODS_LAYERS),
             "serve_long": serve_long_cfg or get_config("olmo-1b", n_layers=SR_LONG_LAYERS),
             "serve_mqa": serve_mqa_cfg or get_config("granite-20b", n_layers=SR_MQA_LAYERS),
             "bf16": bf16_mesh_cfg(BF16_MESH_LAYERS, base=bf16_cfg),
             "bf16_pods": bf16_mesh_cfg(BF16_MESH_PODS_LAYERS, base=bf16_pods_cfg),
             "batch": batch, "seq": seq, "steps": steps, "parts": tuple(parts)}
    world = (MD_WORLD if {"tensor_parallel", "fsdp", "serve_rows", "bf16_mesh"} & set(parts)
             else MD_RANKS)
    ctx = mp.get_context("spawn")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    # the ranks write two olmo-1b checkpoints there: keep them in the checkout's build/
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        procs = [ctx.Process(target=multidevice_rank,
                             args=(r, world, os.path.join(tmp, "rdv"), tmp, device, sizes))
                 for r in range(world)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + MD_TIMEOUT_S
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
            codes = [p.exitcode for p in procs]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        reports = []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.json")
            if os.path.exists(path):
                with open(path) as f:
                    reports.append(json.load(f))
        if any(c != 0 for c in codes):
            print(f"the ranks' reports so far: {json.dumps(reports)}")
        check(all(c == 0 for c in codes), f"a multidevice rank failed or hung: exit codes {codes}")
    wall_s = time.perf_counter() - t0
    return {"reports": reports, "wall_s": wall_s, "sizes": {
        "olmo_layers": sizes["olmo"].n_layers, "train_layers": sizes["train"].n_layers,
        "moe_layers": sizes["moe"].n_layers, "tp_layers": sizes["tp"].n_layers,
        "tp_pods_layers": sizes["tp_pods"].n_layers, "tp_zamba_layers": sizes["tp_zamba"].n_layers,
        "tp_moe_layers": sizes["tp_moe"].n_layers,
        "tp_pods_moe_layers": sizes["tp_pods_moe"].n_layers,
        "tp_a2a_layers": sizes["tp_a2a"].n_layers,
        "fsdp_layers": sizes["fsdp"].n_layers, "fsdp_tp_layers": sizes["fsdp_tp"].n_layers,
        "fsdp_pods_layers": sizes["fsdp_pods"].n_layers,
        "serve_long_layers": sizes["serve_long"].n_layers,
        "serve_mqa_layers": sizes["serve_mqa"].n_layers,
        "bf16_layers": sizes["bf16"].n_layers, "bf16_pods_layers": sizes["bf16_pods"].n_layers,
        "batch": batch, "seq": seq, "steps": steps, "world": world}}


def multidevice_checks(md: dict) -> None:
    """Print the multidevice phase's numbers and hold them to the contract."""
    reports = md["reports"]
    for rep in reports:
        if "collective" not in rep:
            continue
        r, c = rep["rank"], rep["collective"]
        print(f"rank {r} ({rep['device']}), (a) ternary_allreduce_tree over {c['elements']} "
              f"elements ({c['compressed_elements']} compressed in {c['compressed_leaves']} "
              f"leaves): wall {c['wall_ms']:.1f} ms, traced {c['traced_wall_ms']:.1f} ms with "
              f"{c['device_ms']:.3f} ms of device time; launches quantize_pack "
              f"{c['launches']['quantize_pack']}, aggregate {c['launches']['aggregate']}; "
              f"wire received {json.dumps(c['wire'])} (all-gather want "
              f"{c['want_gather_bytes']} = 0.25 B x {c['compressed_elements']} + w_q); exact "
              f"fp32 all-reduce {c['exact_wall_ms']:.1f} ms, {json.dumps(c['exact_wire'])}; "
              f"code flips {c['code_flips']} ({c['proven_ties']} proven ties at Δ), mean rel "
              f"gap {c['mean_rel_gap']:.3e}, residual rel gap {c['residual_rel_gap']:.3e}")
        for name, q in c.get("quantize_pack_alone", {}).items():
            print(f"rank {r}, (a) the collective's quantize_pack launch alone, {name} leaves "
                  f"({q['segments']} segments, {q['elements']} elements): {q['ms']:.4f} ms "
                  f"eager, plain {q['plain_ms']:.4f} ms, bound {q['bound_ms']:.4f} ms "
                  f"({q['bound_by']})")
        check(c["launches"]["quantize_pack"] == 1,
              "the collective launched quantize_pack other than once per rank")
        check(c["launches"]["aggregate"] == 2, "the collective launched aggregate other than "
                                                "twice (mean and residual) per rank")
        check(c["wire"].get("all_gather", 0) == c["want_gather_bytes"],
              "the collective's all-gather bytes are not 0.25 B a coordinate plus w_q")
        check(c["code_flips"] == c["proven_ties"], "a code differs from the plain version "
                                                   "where Δ is not a tie")
        check(c["mean_rel_gap"] <= 1e-6 and c["residual_rel_gap"] <= 1e-6,
              "the collective's mean or residual disagrees with the plain version")
        f = rep["fanin"]
        print(f"rank {r}, (c) sharded fan-in over {f['segments']} segments, "
              f"{MD_FANIN_UPLOADS // MD_RANKS} of {MD_FANIN_UPLOADS} uploads: launches "
              f"{json.dumps(f['launches'])}; sum rel gap {f['sum_rel_gap']:.3e}, vote rel gap "
              f"{f['vote_rel_gap']:.3e} against the one-launch fold of all {MD_FANIN_UPLOADS}")
        check(f["launches"]["aggregate"] == 1 and f["launches"]["vote"] == 1,
              "the sharded fold launched other than one aggregate and one vote per rank")
        check(f["sum_rel_gap"] <= 1e-6 and f["vote_rel_gap"] <= 1e-6,
              "the sharded fold disagrees with the one-launch fold")
        mo = rep["moe"]
        print(f"rank {r}, (d) qwen3-moe ({md['sizes']['moe_layers']} layers, EP {MD_RANKS}): "
              f"scatter {mo['scatter']['ms']:.1f} ms, a2a {mo['a2a']['ms']:.1f} ms "
              f"({mo['a2a']['a2a_bytes']} B received), int8 wire {mo['a2a_int8']['ms']:.1f} ms "
              f"({mo['a2a_int8']['a2a_bytes']} B); a2a vs scatter rel gap "
              f"{mo['a2a_rel_gap']:.3e} (limit 1e-5), int8 rel L2 {mo['int8_rel_l2']:.3e} "
              "(limit 5e-2)")
        check(mo["a2a_rel_gap"] <= 1e-5, "the a2a MoE disagrees with the scatter dispatch")
        check(mo["int8_rel_l2"] < 0.05, "the int8 a2a wire is off by 5% or more")
        tr = rep["train"]
        for name in ("compressed", "exact"):
            run = tr[name]
            print(f"rank {r}, (b) olmo-1b {tr['layers']} of 16 layers at full width, "
                  f"{tr['batch']} x {tr['seq']} over {MD_RANKS} pods, {name}: steps "
                  + "; ".join(f"{s['ms']:.1f} ms loss {s['loss']:.6f}" for s in run["steps"])
                  + f"; peak {run['peak_gib']:.2f} GiB; launches {json.dumps(run['launches'])};"
                  f" wire {json.dumps(run['wire'])}")
        check(tr["compressed"]["launches"]["quantize_pack"] == len(tr["compressed"]["steps"]),
              "compressed training launched quantize_pack other than once per step")
        if "emulation" in tr:
            for name, what in (("emulation", "compressed run vs its one-process emulation"),
                               ("single", "exact run vs one process on the full batch"),
                               ("fault", "planted fault (no gradient sync) vs one process "
                                         "on the full batch")):
                g = tr[name]
                print(f"rank {r}: {what}: one-process losses {g['losses']}; max loss rel gap "
                      f"{g['loss_rel_gap']:.3e} (limit {MD_LOSS_RTOL:g}); params after "
                      f"{len(g['losses'])} steps, worst leaf ‖Δ‖/‖p‖ {g['param_rel_l2']:.3e} "
                      f"(limit {MD_PARAM_RTOL_L2:g}), max |Δ| / max |p| "
                      f"{g['param_rel_gap']:.3e} (not held: Adam's sign-like steps move a few "
                      "weights by up to 2·lr on summation order alone)")
            for name in ("emulation", "single"):
                g = tr[name]
                check(g["loss_rel_gap"] <= MD_LOSS_RTOL
                      and g["param_rel_l2"] <= MD_PARAM_RTOL_L2,
                      f"multi-pod training disagrees with its reference ({name})")
            f = tr["fault"]
            check(f["loss_rel_gap"] > MD_LOSS_RTOL and f["param_rel_l2"] > MD_PARAM_RTOL_L2,
                  "a limit of the multi-pod checks does not catch the planted fault")
    if "collective" in reports[0]:
        check([s["loss"] for s in reports[0]["train"]["compressed"]["steps"]]
              == [s["loss"] for s in reports[1]["train"]["compressed"]["steps"]],
              "the two pods logged different losses")
    tensor_parallel_checks(reports, md["sizes"])
    fsdp_checks(reports, md["sizes"])
    serve_rows_checks(reports, md["sizes"])
    print(f"multidevice phase: {md['wall_s']:.1f} s")


SELECTABLE = ("bf16_mesh", "bf16_train", "multidevice", "midhead")
BF16_MESH_TITLE = (
    "bf16_mesh: the reference's bf16 production train cell over the mesh (in the multidevice "
    f"spawn), olmo-1b {BF16_MESH_LAYERS} of 16 layers at full width: (t) over (1, 2) data x "
    "model, (u) over (2, 1) with its ternary save, each vs one process and a planted fault; "
    f"(v) pods x model on (2, 1, 2), {BF16_MESH_PODS_LAYERS} layers, the sync vs the plain "
    "version")


def selected_phases(argv: list) -> list:
    """The phases ``--phase NAME`` (repeatable) names, each one of
    SELECTABLE; none: every phase."""
    import argparse

    ap = argparse.ArgumentParser(description="Smoke test of the port on one GPU; with --phase, "
                                             "the device and build phases and the named ones")
    ap.add_argument("--phase", action="append", default=[], choices=SELECTABLE)
    return ap.parse_args(argv).phase


def run_selected(names: list, dev, card: str, dry) -> None:
    """The phases ``names`` alone, after device and build (a developer's
    quick run; every other phase skipped, and said so)."""
    import torch

    from repro_torch.core.fttq import FTTQConfig

    print(f"chip_smoke: phases selected {names}; skipped: every other phase but device and "
          "build")
    device = f"cuda:{torch.cuda.current_device()}"
    if "bf16_train" in names:
        phase("bf16_train")
        bf16_train_phase(dev, FTTQConfig(), card)
    parts = (("collective", "tensor_parallel", "fsdp", "serve_rows")
             if "multidevice" in names else ()) + (("bf16_mesh",) if "bf16_mesh" in names
                                                   else ())
    if parts:
        phase(f"multidevice parts {list(parts)}")
        md = multidevice_phase(device, parts=parts)
        if "multidevice" in names:
            multidevice_checks(md)
        if "bf16_mesh" in names:
            phase(BF16_MESH_TITLE)
            bf16_mesh_checks(md["reports"], md["sizes"])
            phase("dryrun: the bf16_mesh cells' estimates")
            bf16_mesh_peak_check(dryrun_estimates(dry), md["reports"])
    if "midhead" in names:
        phase("midhead")
        midhead_checks(midhead_phase(device))


def main(argv: list | None = None) -> int:
    import torch

    names = selected_phases(sys.argv[1:] if argv is None else argv)
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
    # the dry-run's estimates run on the CPU beside the card's phases
    dry = dryrun_start()
    atexit.register(lambda: dry.poll() is None and dry.kill())
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
    if names:
        del params
        _free()
        run_selected(names, dev, card, dry)
        print(card)
        print(json.dumps({"kernels": [], "selected_phases": names}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}))
        return 0

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
    for m, k, n in MATMUL_SHAPES + ZOO_MATMUL_SHAPES:
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

    phase("checks: XLA's subnormal rule in the FTTQ statistics and error-feedback residuals "
          "(the card's bits against the CPU's)")
    subnormal_rule_checks(dev)

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

    phase("bf16_serve: olmo-1b --ternary --packed --dtype bfloat16 at full width (bf16 "
          "weights and activations)")
    bf16 = bf16_serve_phase(dev, fcfg, {
        "wire_bytes": wire_bytes, "deploy_s": t_deploy, "prefill_ms": t_prefill * 1e3,
        "decode_tok_s": BATCH * (GEN - 1) / t_decode, "per_forward": per_forward})

    phase("serve_loop: ServeEngine on olmo-1b at full width under run_closed_loop "
          "(cache 16 MiB and 1 GiB; 5 and 2,000 QPS)")
    t0 = time.perf_counter()
    sloop = serve_loop_phase(dev, cfg, params, fcfg)
    sloop["phase_s"] = time.perf_counter() - t0
    print(f"serve_loop phase: {sloop['phase_s']:.2f} s")

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
    qp_trace = encode_trace(qp_rows, qp_scal)
    check(qp_trace["device_kernels"] == 1, "one deploy encode launched "
          f"{qp_trace['device_kernels']} quantize_pack device kernels (want one)")
    print(f"quantize_pack, all {len(qp_rows)} quantized leaves ({n_quant} weights), eager: one "
          f"call {qp_ms:.4f} ms ({len(qp_rows)} one-segment calls: {qp_old_ms:.4f} ms), plain "
          f"{qp_plain_ms:.4f} ms, bound {qp_bound:.4f} ms ({qp_by}, {qp_bytes} B); traced: "
          f"device {qp_trace['device_ms']:.4f} ms ({qp_trace['kernel_names']}), eager "
          f"{qp_trace['eager_ms']:.4f} ms, the segment table alone "
          f"{qp_trace['table_host_ms']:.4f} ms of host time")
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
    del cache, logits, prof

    phase("zoo: every family through launch/serve.py (gemma3-4b, granite-20b 4 of 52 layers, "
          "llama-3.2-vision-11b 5 of 40, hubert-xlarge, qwen3-moe 2 of 48, deepseek-moe 2 of "
          "28, mamba2-370m, zamba2-1.2b)")
    t0 = time.perf_counter()
    zoo = zoo_phase(dev, fcfg)
    zoo_s = time.perf_counter() - t0
    print(f"zoo phase: {zoo_s:.2f} s")

    phase("train: the CLI with a resume (10m preset), olmo-1b at full width (8 x 512; 8 x "
          "4,096 with microbatches 4 and remat full), card vs CPU, every family reduced")
    del params, served, ref_params, layers, blocks, dense_blocks, qp_rows, qp_scal
    del qp_bytes_checked, qp_scales_checked, quantizable
    _free()
    train = train_phase(dev, fcfg)
    qat_t = qat_backward_checks(dev)

    phase("bf16_train: the reference's production train cell on one card, olmo-1b at full "
          f"width (bf16 params and compute, remat full, QAT, adam(1e-4), microbatches 2, "
          f"{BF16_TRAIN_BATCH} x {BF16_TRAIN_SEQ}, {BF16_TRAIN_STEPS} steps), its ternary save, "
          f"card vs CPU at {TRAIN_CHECK_LAYERS} layers, the bf16 QAT backward's kernel")
    _free()
    bf16_train = bf16_train_phase(dev, fcfg, card)

    phase("multidevice: two ranks on the card over gloo (a) ternary_allreduce_tree over "
          "olmo-1b's gradient tree, (c) the sharded fan-in, (d) the a2a MoE on qwen3-moe 2 of "
          f"48 layers, (b) compressed and exact 2-pod training of olmo-1b {MD_TRAIN_LAYERS} of "
          f"16 layers; then tensor_parallel: (a) olmo-1b {TP_OLMO_LAYERS} of 16 layers trained over 2 model "
          "ranks vs one process and a planted fault, (b) its ternary save, (c) prefill and "
          f"decode; (e) zamba2-1.2b {TP_ZAMBA_LAYERS} of 38 layers and (f) qwen3-moe-30b-a3b "
          f"{TP_MOE_LAYERS} of 48 layers trained the same way, (g) the latter's ternary save, "
          f"(h) zamba2's prefill and decode; (d) pods x model on 4 ranks, olmo-1b "
          f"{TP_PODS_LAYERS} of 16 layers, (i) qwen3-moe {TP_PODS_MOE_LAYERS} of 48; then fsdp: "
          f"(j) olmo-1b {FSDP_OLMO_LAYERS} of 16 layers trained over 2 data ranks (params and Adam moments "
          "cut over 'data', per-layer all-gather, reduce-scattered gradients) vs one process "
          "and a planted fault, (m) its ternary save, (n) prefill and decode; (k) olmo-1b "
          f"{FSDP_TP_LAYERS} of 16 layers over (2, 2) data x model vs one process; (l) pods x "
          f"data on (2, 2, 1), olmo-1b {FSDP_PODS_LAYERS} of 16 layers; then serve_rows: (o) "
          f"is (n), 2 rows a rank; (p) olmo-1b {SR_LONG_LAYERS} of 16 layers, batch 1, a "
          f"{SR_LONG_SLOTS}-slot cache's sequence over 2 data ranks, a {SR_LONG_PROMPT}-token "
          f"prompt and {SR_LONG_GEN} steps; (q) granite-20b {SR_MQA_LAYERS} of 52 layers (MQA), "
          "the cache's sequence over 2 model ranks; (r) qwen3-moe-30b-a3b "
          f"{TP_A2A_LAYERS} of 48 layers, the all-to-all MoE under 'model' vs the scatter "
          "dispatch and a planted fault; then bf16_mesh (its checks below)")
    _free()
    md = multidevice_phase(f"cuda:{torch.cuda.current_device()}")
    multidevice_checks(md)
    md_reports = md["reports"]

    phase(BF16_MESH_TITLE)
    bf16_mesh_checks(md_reports, md["sizes"])

    phase(f"midhead: (s) gemma3-4b {MH_LAYERS} of 34 layers at full width over {MH_RANKS} "
          "model ranks on the card over gloo (half a query head a rank): prefill and decode "
          "with the cache's sequence over 'model', and the first QAT step's gradients, "
          "against one process")
    _free()
    mh = midhead_phase(f"cuda:{torch.cuda.current_device()}")
    midhead_checks(mh)
    md["midhead"] = mh

    phase("dryrun: launch/dryrun.py's estimate of the one-device olmo-1b train cell, of the "
          "bf16 train cell and of fsdp (j), against their measurements")
    dryrun_finish(dry, train, md, bf16_train)

    def tp_launches(rep: dict, name: str) -> dict:
        """A rank's launches of ``name`` on each tensor_parallel path."""
        tp = rep["tensor_parallel"]
        out = {"pods_model_collective": tp["pods_collective"]["launches"][name],
               "pods_model_steps": [s["launches"][name] for s in tp["pods_train"]["steps"]],
               "pods_model_moe_collective": tp["pods_moe_collective"]["launches"][name]}
        if "train" in tp:
            out.update(train=tp["train"]["launches"][name],
                       ternary_save=tp["train"]["save"]["launches"][name],
                       zamba2_train=tp["zamba2"]["train"]["launches"][name],
                       moe_train=tp["moe"]["train"]["launches"][name],
                       moe_ternary_save=tp["moe"]["train"]["save"]["launches"][name])
        return out

    def bf16_mesh_launches(name: str) -> dict:
        """Each rank's launches of ``name`` on the bf16_mesh paths: (t) and
        (u) over their runs, (u)'s save, (v) a step."""
        out = {}
        for rep in md_reports:
            b = rep.get("bf16_mesh") or {}
            got = {f"{tag}_{run}": b[tag][run]["launches"][name]
                   for tag in ("t", "u") if tag in b for run in ("train", "fault")}
            if "u" in b:
                got["u_ternary_save"] = b["u"]["train"]["save"]["launches"][name]
            got["v_steps"] = [s_["launches"][name] for s_ in b["v"]["steps"]]
            out[f"rank{rep['rank']}"] = got
        return out

    def fsdp_launches(rep: dict, name: str) -> dict:
        """A rank's launches of ``name`` on each fsdp path."""
        f = rep["fsdp"]
        out = {"fsdp_tp_train": f["tp"]["train"]["launches"][name],
               "pods_data_collective": f["pods_collective"]["launches"][name],
               "pods_data_steps": [s["launches"][name] for s in f["pods_train"]["steps"]]}
        if "train" in f:
            out.update(train=f["train"]["launches"][name],
                       ternary_save=f["train"]["save"]["launches"][name])
        return out

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

    phase(f"fed trace: one round of 1 client at E = {FED_TRACE_EPOCHS}, B = 64 under "
          "torch.profiler")
    federated_trace(dev, setup)

    bf16_decode = bf16["timings"]["ternary_matmul_decode"]
    bf16_qp = bf16["timings"]["quantize_pack"]
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
                                    for label, run in sock["runs"].items()},
         "serve_loop_launches": {cap: 1 for cap in sloop["engines"]},
         "zoo_launches": {arch: row["launches"]["quantize_pack"] for arch, row in zoo.items()},
         "train_launches": {"ternary_save":
                            train["full_width"]["ternary_checkpoint"]["launches"]["quantize_pack"]},
         "train": train,
         "device_ms": qp_trace["device_ms"], "trace": qp_trace,
         "multidevice_launches": {
             f"rank{r['rank']}": {"collective": r["collective"]["launches"]["quantize_pack"],
                                  "train_compressed": r["train"]["compressed"]["launches"][
                                      "quantize_pack"]} for r in md_reports if "collective" in r},
         "tensor_parallel_launches": {
             f"rank{r['rank']}": tp_launches(r, "quantize_pack") for r in md_reports},
         "fsdp_launches": {
             f"rank{r['rank']}": fsdp_launches(r, "quantize_pack") for r in md_reports},
         "bf16_mesh_launches": bf16_mesh_launches("quantize_pack"),
         "multidevice": md},
        {"name": "quantize_pack_bf16", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/quantize_pack_bf16.cu",
         "replaces": "src/repro/kernels/quantize_pack.py:83",
         "launches": bf16["launches"]["quantize_pack"],
         "max_abs_err": bf16["checks"]["quantize_pack_max_abs_err"],
         "ms": bf16_qp["device_ms"], "plain_ms": bf16_qp["plain_ms"],
         "bound_ms": bf16_qp["bound_ms"], "bound_by": bf16_qp["bound_by"],
         "library_ms": None, "eager_ms": bf16_qp["eager_ms"],
         "table_host_ms": bf16_qp["table_host_ms"], "bytes": bf16_qp["bytes"],
         "sum_rel": bf16["checks"]["quantize_pack_sum_rel"],
         "scale_rel": bf16["checks"]["quantize_pack_scale_rel"],
         "patterns": bf16["checks"]["quantize_pack_patterns"],
         "bf16_mesh_save": {f"rank{r['rank']}": r["bf16_mesh"]["u"]["train"]["save"]
                            for r in md_reports if "u" in r.get("bf16_mesh", {})},
         "layouts": bf16["checks"]["quantize_pack_layouts"],
         "subnormals": bf16["checks"]["subnormals"]},
        {"name": "ternary_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ternary_matmul.cu",
         "replaces": "src/repro/kernels/ternary_matmul.py:34",
         "launches": tm_launches, "max_abs_err": tm_err, "ms": decode_t["ms"],
         "plain_ms": decode_t["plain_ms"], "bound_ms": decode_t["bound_ms"],
         "bound_by": decode_t["bound_by"], "library_ms": decode_t["library_ms"],
         "eager_ms": decode_t["eager_ms"], "prefill": prefill_t, "per_shape": per_shape,
         "serve_loop_launches": {cap: {qps: run["launches"]["ternary_matmul"]
                                       for qps, run in row["runs"].items()}
                                 for cap, row in sloop["engines"].items()},
         "zoo_launches": {arch: row["launches"]["ternary_matmul"] for arch, row in zoo.items()},
         "serve_loop": sloop, "zoo": zoo},
        {"name": "ternary_matmul_bf16", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ternary_matmul_bf16.cu",
         "replaces": "src/repro/kernels/ternary_matmul.py:34",
         "launches": bf16["launches"]["ternary_matmul"],
         "max_abs_err": bf16["checks"]["matmul_max_abs_err"],
         "ms": bf16_decode["ms"], "plain_ms": bf16_decode["plain_ms"],
         "bound_ms": bf16_decode["bound_ms"], "bound_by": bf16_decode["bound_by"],
         "library_ms": bf16_decode["library_ms"], "eager_ms": bf16_decode["eager_ms"],
         "per_forward": bf16["ternary_matmul_per_forward"], "decode": bf16_decode,
         "prefill": bf16["timings"]["ternary_matmul_prefill"],
         "serve": {k: bf16[k] for k in ("wire_bytes", "deploy_s", "logits_ratio",
                                        "prefill_ms", "decode_tok_s")}},
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
         "multidevice_launches": {
             f"rank{r['rank']}": {"collective": r["collective"]["launches"]["aggregate"],
                                  "fanin": r["fanin"]["launches"]["aggregate"],
                                  "train_compressed": r["train"]["compressed"]["launches"][
                                      "aggregate"]} for r in md_reports if "collective" in r},
         "tensor_parallel_launches": {
             f"rank{r['rank']}": tp_launches(r, "aggregate") for r in md_reports},
         "fsdp_launches": {
             f"rank{r['rank']}": fsdp_launches(r, "aggregate") for r in md_reports},
         "bf16_mesh_launches": bf16_mesh_launches("aggregate"),
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
         "multidevice_launches": {f"rank{r['rank']}": r["fanin"]["launches"]["vote"]
                                  for r in md_reports if "fanin" in r},
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
        {"name": "qat_backward", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/qat_backward.cu",
         "replaces": "src/repro/core/fttq.py:136",
         "launches": train["full_width"]["qat_backward_launches"],
         "max_abs_err": qat_t["max_abs_err"], "ms": qat_t["ms"], "plain_ms": qat_t["plain_ms"],
         "bound_ms": qat_t["bound_ms"], "bound_by": qat_t["bound_by"], "library_ms": None},
        {"name": "qat_backward_bf16", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/qat_backward.cu",
         "replaces": "src/repro/core/fttq.py:136",
         "launches": bf16_train["full_width"]["launches"]["qat_backward_bf16"],
         "max_abs_err": max(bf16_train["qat_backward_bf16"]["max_abs_err"],
                            bf16_train["full_width"]["cotangent_check"]["max_abs_err"]),
         "ms": bf16_train["qat_backward_bf16"]["ms"],
         "plain_ms": bf16_train["qat_backward_bf16"]["plain_ms"],
         "bound_ms": bf16_train["qat_backward_bf16"]["bound_ms"],
         "bound_by": bf16_train["qat_backward_bf16"]["bound_by"], "library_ms": None,
         "bf16_mesh_launches": bf16_mesh_launches("qat_backward_bf16"),
         "bf16_train": bf16_train},
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
