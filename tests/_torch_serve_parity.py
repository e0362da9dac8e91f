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
for arch in ARCHS:
    cfg = JC.get_reduced(arch)
    params = init_params(cfg, jax.random.PRNGKey(0))
    out[arch] = {"params": tm(np.asarray, params)}
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (max(BATCHES), S)).astype(np.int32)
    out[arch]["prompts"] = prompts
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
            out[arch][(shape, b)] = {
                "logits": steps, "tokens": tokens,
                "shard_shapes": {k: tuple(csh[k].shard_shape(v.shape))
                                 for k, v in cache.items()}}
pickle.dump(out, open(OUT, "wb"))
"""


def both(archs, tmp, timeout: float = 150):
    """{(arch, shape, batch): (the reference's {logits, tokens,
    shard_shapes}, the port's ranks' results in rank order: None off the
    mesh, else {logits (rank 0: gathered), tokens, cache shapes})}."""
    ref = {}
    # one reference process per arch, side by side: XLA compiles on one core
    with concurrent.futures.ThreadPoolExecutor() as pool:
        for part in pool.map(lambda a: run_jax(
                f"ARCHS = [{a!r}]\nSHAPES = {SHAPES!r}\nBATCHES = {BATCHES!r}\nS = {S}\n"
                f"MAX = {MAX}\nGEN = {GEN}\nCHUNKS = {CHUNKS}\n" + _REFERENCE, 4, tmp),
                archs):
            ref.update(part)
    runs = [{"arch": a, "shape": shape, "batch": b} for a in archs for shape in SHAPES
            for b in BATCHES]
    got = run_ranks("serve_rows", 4, tmp, timeout=timeout, runs=runs,
                    params={a: ref[a]["params"] for a in archs},
                    prompts={a: ref[a]["prompts"] for a in archs},
                    max_seq=MAX, gen=GEN, chunks=CHUNKS)
    return {(r["arch"], r["shape"], r["batch"]): (ref[r["arch"]][(r["shape"], r["batch"])],
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


WHOLE_OVER_MODEL = ("conv", "ssd")


def check_cache(result, shape):
    """Every rank's cache leaf shapes equal the reference's shard shapes,
    except the SSM states (``WHOLE_OVER_MODEL``), which the port keeps
    whole over "model" (its Mamba2 computes whole heads) and cuts by rows
    only."""
    want, ranks = result
    for r in ranks:
        if r is None:
            continue
        assert set(r["cache"]) == set(want["shard_shapes"])
        for k, got in r["cache"].items():
            ref = want["shard_shapes"][k]
            if k in WHOLE_OVER_MODEL and shape[1] > 1:
                assert got[:2] == ref[:2]        # stacked layers, rows
            else:
                assert got == ref, (k, got, ref)
