"""Shared by the serving-rows parity tests: the reference's GSPMD prefill
and decode steps on a (data, model) mesh of forced host devices (params by
its ``param_specs``, the batch's rows over "data" where they divide, the
cache placed by its ``cache_specs``, axes of type Auto), and the port's
steps on four ``gloo`` CPU ranks on the same mesh shapes from the same
params and prompts. A run is (arch, mesh shape, batch): batch 4 cuts the
rows, batch 1 the cache's sequence over "data" (and "model" where the kv
heads do not divide over it). The prompt of ``S`` tokens goes in as
``CHUNKS`` chunks into a ``MAX``-slot cache, then ``GEN`` greedy steps, so
a rank's slots start empty, fill, and the writes cross from one rank's
slots into the next."""

import concurrent.futures

import numpy as np

from _torch_dist import REPO, run_jax, run_ranks

SHAPES = [(2, 1), (1, 2), (2, 2), (4, 1)]
BATCHES = [4, 1]
S, MAX, GEN, CHUNKS = 6, 16, 7, 2

_REFERENCE = """
import os, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
import repro.configs as JC
from repro.compat import set_mesh
from repro.launch.steps import make_decode_step, make_prefill_step
from repro.models.transformer import init_params
from repro.parallel.sharding import cache_specs, param_specs

tm = jax.tree_util.tree_map
out = {}
for key, (arch, ov) in ARCHS.items():
    cfg = JC.get_reduced(arch, **ov)
    params = init_params(cfg, jax.random.PRNGKey(0))
    out[key] = {"params": tm(np.asarray, params)}
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (max(BATCHES), S)).astype(np.int32)
    out[key]["prompts"] = prompts
    for shape in SHAPES:
        mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
        placed = tm(lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp)), params,
                    param_specs(cfg, mesh))
        for b in BATCHES:
            cut = b % shape[0] == 0 and b >= shape[0]
            rows = NamedSharding(mesh, P("data") if cut else P())
            cspecs = cache_specs(cfg, mesh, batch_sharded=cut)
            csh = {k: NamedSharding(mesh, sp) for k, sp in cspecs.items()}
            toks = jax.device_put(jnp.asarray(prompts[:b]), rows)
            with set_mesh(mesh):
                pre = jax.jit(make_prefill_step(cfg, MAX, chunks=CHUNKS),
                              out_shardings=(rows, csh))
                dec = jax.jit(make_decode_step(cfg), out_shardings=(rows, csh))
                logits, cache = pre(placed, {"tokens": toks})
                steps, tokens = [np.asarray(logits)], []
                for i in range(GEN):
                    tok = jnp.argmax(logits, -1).astype(jnp.int32)
                    tokens.append(np.asarray(tok))
                    logits, cache = dec(placed, {"tokens": tok, "cache": cache,
                                                 "pos": jnp.int32(S + i)})
                    steps.append(np.asarray(logits))
            out[key][(shape, b)] = {
                "logits": steps, "tokens": tokens,
                "shard_shapes": {k: tuple(csh[k].shard_shape(v.shape))
                                 for k, v in cache.items()}}
pickle.dump(out, open(OUT, "wb"))
"""


def both(archs, tmp, timeout: float = 150, shapes=SHAPES, batches=BATCHES,
         overrides: dict | None = None):
    """{(key, shape, batch): (the reference's {logits, tokens,
    shard_shapes}, the port's ranks' results in rank order: None off the
    mesh, else {logits (rank 0: gathered), tokens, cache shapes})} for
    every key of ``archs`` on every (data, model) mesh shape of ``shapes``
    and batch of ``batches``: a key is an arch, or with ``overrides``
    ({key: (arch, ModelConfig overrides)}) that arch's reduced config with
    those fields."""
    configs = {a: (overrides or {}).get(a, (a, {})) for a in archs}
    ref = {}
    # one reference process per arch, side by side: XLA compiles on one core
    with concurrent.futures.ThreadPoolExecutor() as pool:
        for part in pool.map(lambda a: run_jax(
                f"ARCHS = {{{a!r}: {configs[a]!r}}}\nSHAPES = {shapes!r}\n"
                f"BATCHES = {batches!r}\nS = {S}\nMAX = {MAX}\nGEN = {GEN}\n"
                f"CHUNKS = {CHUNKS}\n" + _REFERENCE, 4, tmp), archs):
            ref.update(part)
    runs = [{"key": a, "arch": configs[a][0], "overrides": configs[a][1], "shape": shape,
             "batch": b} for a in archs for shape in shapes for b in batches]
    got = run_ranks("serve_rows", 4, tmp, timeout=timeout, runs=runs,
                    params={a: ref[a]["params"] for a in archs},
                    prompts={a: ref[a]["prompts"] for a in archs},
                    max_seq=MAX, gen=GEN, chunks=CHUNKS)
    return {(r["key"], r["shape"], r["batch"]): (ref[r["key"]][(r["shape"], r["batch"])],
                                                 [rank[i] for rank in got])
            for i, r in enumerate(runs)}


def check_logits(result):
    """Prefill and every decode step's logits, gathered over the rows,
    within 1e-5 of max |logits| of the reference's, with the same greedy
    tokens; every rank of the mesh has the same gathered logits."""
    want, ranks = result
    got = ranks[0]
    assert len(got["logits"]) == len(want["logits"]) == 1 + GEN
    for a, b in zip(got["logits"], want["logits"]):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    for a, b in zip(got["tokens"], want["tokens"]):
        np.testing.assert_array_equal(a, b)
    for r in ranks[1:]:
        if r is not None:
            for a, b in zip(r["logits"], got["logits"]):
                np.testing.assert_array_equal(a, b)


def check_cache(result, shape):
    """Every rank's cache leaf shapes equal the reference's shard shapes:
    the KV caches and the SSM states (conv window and SSD state), which
    "model" cuts by channels and heads where they divide."""
    want, ranks = result
    for r in ranks:
        if r is None:
            continue
        assert set(r["cache"]) == set(want["shard_shapes"])
        for k, got in r["cache"].items():
            ref = want["shard_shapes"][k]
            assert got == ref, (k, got, ref, shape)
