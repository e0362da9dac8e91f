"""Batched serving front end over the packed-ternary artifact, under load
(port of ``repro.launch.serve_loop``).

``launch.serve`` answers one probe; this module is the long-lived front end
an edge runs:

- **Request batching.** A closed loop coalesces every request that arrived
  by the time the previous forward finished, up to ``max_batch``, into ONE
  forward, so every weight matmul of the batch is one pass of the 2-bit
  ``ternary_matmul`` kernel.
- **LRU dequant cache.** The engine keeps its non-matmul wire leaves
  (fp16-downcast embeddings, norms and biases, non-matmul ternary leaves)
  in wire form on its device and materializes them dense on demand through
  ``LRUDequantCache``, a byte-bounded cache: serving memory is the packed
  weights plus the cache's capacity, not the dense model. A tight budget
  degrades to a decode per forward, never to a refusal.

The matmul weights are ``PackedTernary`` (the 2-bit kernel layout, never
dequantized), as in ``launch.serve --packed``. The engine serves the
families whose 2-D/3-D ternary leaves are all matmul weights (dense, vlm,
audio); moe, ssm and hybrid route theirs elsewhere and are refused.

    PYTHONPATH=src python -m repro_torch.launch.serve_loop --device cpu \\
        --requests 64 --qps 200 --max-batch 8
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from collections import OrderedDict
from typing import Any

import numpy as np
import torch

from repro_torch.comm.wire import decode_update, encode_update
from repro_torch.core.compression import (
    CodecSpec, compress_pytree, decode_wire_leaf, is_wire_leaf,
)
from repro_torch.core.fttq import FTTQConfig
from repro_torch.core.ternary import TernaryTensor
from repro_torch.device import resolve_device
from repro_torch.kernels.repack import repack_to_kernel_layout
from repro_torch.launch.serve import PACKED_FAMILIES
from repro_torch.tree import flatten_with_path, tree_map

Pytree = Any


# --------------------------------------------------------------------------
# LRU dequant cache.
# --------------------------------------------------------------------------


class LRUDequantCache:
    """Byte-bounded LRU over dense materializations of wire leaves.

    ``get(key, wire_leaf)`` returns the dense tensor on ``device``, decoding
    on a miss and evicting least-recently-used entries until the live bytes
    fit ``capacity_bytes``. A leaf larger than the whole capacity is
    decoded, returned and dropped at once (counted as an eviction).
    ``capacity_bytes=0`` retains nothing (every get is a miss)."""

    def __init__(self, capacity_bytes: int, device: str | torch.device = "cpu"):
        if capacity_bytes < 0:
            raise ValueError(f"capacity_bytes must be ≥ 0, got {capacity_bytes}")
        self.capacity_bytes = int(capacity_bytes)
        self.device = torch.device(device)
        self._entries: OrderedDict[str, tuple[torch.Tensor, int]] = OrderedDict()
        self.live_bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: str, wire_leaf) -> torch.Tensor:
        hit = self._entries.get(key)
        if hit is not None:
            self._entries.move_to_end(key)
            self.hits += 1
            return hit[0]
        self.misses += 1
        dense = decode_wire_leaf(wire_leaf, self.device)
        nbytes = dense.numel() * dense.element_size()
        self._entries[key] = (dense, nbytes)
        self.live_bytes += nbytes
        while self.live_bytes > self.capacity_bytes and self._entries:
            _k, (_v, nb) = self._entries.popitem(last=False)
            self.live_bytes -= nb
            self.evictions += 1
        return dense

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "capacity_bytes": self.capacity_bytes,
            "live_bytes": self.live_bytes,
            "entries": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "hit_rate": (self.hits / total) if total else 0.0,
        }


# --------------------------------------------------------------------------
# The serving engine.
# --------------------------------------------------------------------------


def keystr(path) -> str:
    """A tree path as ``jax.tree_util.keystr`` writes it: ``['embed']['table']``."""
    return "".join(f"[{key!r}]" if kind == "d" else f"[{key}]" for kind, key in path)


def _on_device(wire_leaf, device: torch.device):
    """The wire leaf with its payload tensors moved to ``device``."""
    fields = {f.name: getattr(wire_leaf, f.name) for f in dataclasses.fields(wire_leaf)}
    moved = {k: v.to(device) if isinstance(v, torch.Tensor) else v for k, v in fields.items()}
    return dataclasses.replace(wire_leaf, **moved)


@dataclasses.dataclass
class _Lazy:
    """A wire leaf the engine materializes through the dequant cache."""

    key: str
    wire: Any


class ServeEngine:
    """Long-lived packed-ternary inference engine with lazy wire leaves.

    The deploy artifact round-trips the wire codec (compress → serialize →
    decode, CRC checked); 2-D/3-D ternary records repack into the 2-bit
    kernel layout on ``device``, every other wire leaf stays in wire form
    there and is materialized through the LRU cache at forward time."""

    def __init__(self, model_cfg, params: Pytree, *, fttq: FTTQConfig | None = None,
                 residual: str = "fp16", max_batch: int = 8,
                 cache_capacity_bytes: int = 1 << 24,
                 device: str | torch.device = "cuda"):
        if max_batch < 1:
            raise ValueError(f"max_batch must be ≥ 1, got {max_batch}")
        if model_cfg.family not in PACKED_FAMILIES:
            raise ValueError(
                f"ServeEngine repacks every 2-D/3-D ternary leaf for the matmul kernel; "
                f"family {model_cfg.family!r} routes those weights elsewhere (moe/ssm) — "
                "serve it with launch.serve --ternary")
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.max_batch = int(max_batch)
        self.cache = LRUDequantCache(cache_capacity_bytes, self.device)
        fttq = fttq if fttq is not None else FTTQConfig()

        wire_tree, _ = compress_pytree(
            params, CodecSpec(kind="ternary", residual=residual, fttq=fttq))
        blob = encode_update(wire_tree)
        self.wire_bytes = len(blob)
        decoded = decode_update(blob)

        # matmul ternary → PackedTernary (2-bit, resident); every other wire
        # leaf stays lazy behind the dequant cache
        self.packed_weight_bytes = 0
        self.lazy_wire_bytes_dense = 0   # dense size the cache may hold
        self._template: list = []        # PackedTernary | _Lazy | dense tensor
        self._lazy_keys: list[str] = []
        for path, leaf in flatten_with_path(decoded, is_leaf=is_wire_leaf):
            if isinstance(leaf, TernaryTensor) and len(leaf.shape) in (2, 3):
                p = repack_to_kernel_layout(leaf, self.device)
                self.packed_weight_bytes += (p.packed.numel()
                                             + p.w_q.numel() * p.w_q.element_size())
                self._template.append(p)
            elif is_wire_leaf(leaf):
                key = keystr(path)
                wire = _on_device(leaf, self.device)
                dense = decode_wire_leaf(wire, self.device)
                self.lazy_wire_bytes_dense += dense.numel() * dense.element_size()
                del dense
                self._lazy_keys.append(key)
                self._template.append(_Lazy(key, wire))
            else:
                self._template.append(leaf.to(self.device))
        self._skeleton = tree_map(lambda _: 0, decoded, is_leaf=is_wire_leaf)
        self.forwards = 0
        self.requests_served = 0

    def resolve_params(self) -> Pytree:
        """The servable tree for ONE forward: lazy wire leaves go through
        the LRU cache (hot leaves stay resident), the rest pass through."""
        leaves = iter([self.cache.get(x.key, x.wire) if isinstance(x, _Lazy) else x
                       for x in self._template])
        return tree_map(lambda _: next(leaves), self._skeleton)

    def forward(self, tokens) -> torch.Tensor:
        """One batched forward through the packed kernels; returns logits
        once the device has finished them."""
        from repro_torch.models.transformer import forward as model_forward

        tokens = torch.as_tensor(tokens, device=self.device)
        b = int(tokens.shape[0])
        if b > self.max_batch:
            raise ValueError(f"batch {b} exceeds max_batch {self.max_batch}")
        params = self.resolve_params()
        logits, _cache, _aux = model_forward(self.model_cfg, params, tokens)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.forwards += 1
        self.requests_served += b
        return logits

    def stats(self) -> dict:
        return {
            "wire_bytes": self.wire_bytes,
            "packed_weight_bytes": self.packed_weight_bytes,
            "lazy_wire_bytes_dense": self.lazy_wire_bytes_dense,
            "max_batch": self.max_batch,
            "forwards": self.forwards,
            "requests_served": self.requests_served,
            "cache": self.cache.stats(),
        }


# --------------------------------------------------------------------------
# Closed-loop load generation.
# --------------------------------------------------------------------------


@dataclasses.dataclass
class LoadReport:
    """One (offered QPS, max_batch) point of the latency surface."""

    offered_qps: float
    achieved_qps: float
    n_requests: int
    max_batch: int
    p50_ms: float
    p99_ms: float
    mean_ms: float
    mean_batch: float
    wall_s: float               # busy wall-clock of the serving loop
    cache: dict

    def row(self) -> dict:
        return dataclasses.asdict(self)


def run_closed_loop(engine: ServeEngine, *, n_requests: int, offered_qps: float,
                    prompt_len: int = 8, seed: int = 0) -> LoadReport:
    """Drive the engine with a Poisson arrival schedule, coalescing what
    arrived while the previous forward ran (up to ``max_batch``) into the
    next one.

    The arrival clock is virtual (a schedule from ``seed``, drawn as the
    reference draws it, so both packages offer the same load); service times
    are measured forward wall times. One warm-up forward at batch 1 runs
    first."""
    if n_requests < 1 or offered_qps <= 0:
        raise ValueError("need n_requests ≥ 1 and offered_qps > 0")
    rng = np.random.default_rng(seed)
    inter = rng.exponential(1.0 / offered_qps, size=n_requests)
    arrivals = np.cumsum(inter)
    vocab = int(engine.model_cfg.vocab_size)
    prompts = rng.integers(0, vocab, size=(n_requests, prompt_len))

    engine.forward(prompts[:1])

    now = 0.0
    busy_s = 0.0
    done = 0
    latencies = np.empty(n_requests)
    batch_sizes = []
    while done < n_requests:
        if arrivals[done] > now:
            now = float(arrivals[done])      # idle until the next arrival
        take = done + 1
        while (take < n_requests and take - done < engine.max_batch
               and arrivals[take] <= now):
            take += 1
        batch = prompts[done:take]
        t0 = time.perf_counter()
        engine.forward(batch)
        dt = time.perf_counter() - t0
        busy_s += dt
        now += dt
        latencies[done:take] = now - arrivals[done:take]
        batch_sizes.append(take - done)
        done = take

    lat_ms = latencies * 1e3
    return LoadReport(
        offered_qps=float(offered_qps),
        achieved_qps=float(n_requests / now),
        n_requests=int(n_requests),
        max_batch=engine.max_batch,
        p50_ms=float(np.percentile(lat_ms, 50)),
        p99_ms=float(np.percentile(lat_ms, 99)),
        mean_ms=float(lat_ms.mean()),
        mean_batch=float(np.mean(batch_sizes)),
        wall_s=float(busy_s),
        cache=engine.cache.stats(),
    )


def demo_model(d_model: int = 32, n_layers: int = 2, vocab: int = 64,
               device: str | torch.device = "cuda"):
    """The tiny dense LM the CLI demo serves (random weights, seed 0)."""
    from repro_torch.models.transformer import ModelConfig, init_params

    cfg = ModelConfig(name="serve-demo", family="dense", n_layers=n_layers,
                      d_model=d_model, vocab_size=vocab, n_heads=4,
                      n_kv_heads=2, d_ff=2 * d_model)
    return cfg, init_params(cfg, seed=0, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Closed-loop load against the packed-ternary serve engine")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--qps", type=float, default=200.0)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=32)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--cache-bytes", type=int, default=1 << 24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg, params = demo_model(args.d_model, args.layers, device=dev)
    engine = ServeEngine(cfg, params, max_batch=args.max_batch,
                         cache_capacity_bytes=args.cache_bytes, device=dev)
    report = run_closed_loop(engine, n_requests=args.requests, offered_qps=args.qps,
                             prompt_len=args.prompt_len, seed=args.seed)
    print(json.dumps({"device": str(dev), "engine": engine.stats(), "load": report.row()},
                     indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
