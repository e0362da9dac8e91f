"""The ternary-compressed collectives and the client-sharded fan-in of the
port, on ``gloo`` CPU ranks, against the reference run in a subprocess
whose JAX sees two forced host devices (mesh ``(2,)`` over ``"pod"``, as
``tests/test_parallel.py`` runs it), on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import run_jax, run_ranks
from repro.parallel.collectives import _quantize_lastdim
from repro_torch.kernels.aggregate import fanin_table, packed_weighted_sum, \
    packed_weighted_sum_segments
from repro_torch.kernels.vote import packed_vote_counts, packed_vote_counts_segments
from repro_torch.launch.mesh import describe, make_mesh, make_production_mesh
from repro_torch.parallel.collectives import (
    compressed_bytes_per_element, pods_mean_plain, quantize_lastdim_plain, ternary_allreduce,
    ternary_allreduce_tree,
)

torch.set_num_threads(1)

P_PODS, STEPS = 2, 3
# "head" packs to 3 bytes, so the gathered rows are restaged to 4-byte
# aligned segments before the fold; "odd" (last dim 6) and "bias" take the
# exact mean
SHAPES = {"dense": {"w": (16, 32)}, "conv": {"kernel": (3, 4, 8)}, "head": {"w": (3, 4)},
          "odd": {"w": (8, 6)}, "bias": (32,)}
N_COMP, N_COMP_LEAVES, N_EXACT = 16 * 32 + 3 * 4 * 8 + 3 * 4, 3, 8 * 6 + 32


def _tree(rng):
    def leaf(shape):
        return rng.normal(size=shape).astype(np.float32)
    return {"dense": {"w": leaf(SHAPES["dense"]["w"])},
            "conv": {"kernel": leaf(SHAPES["conv"]["kernel"])},
            "head": {"w": leaf(SHAPES["head"]["w"])},
            "odd": {"w": leaf(SHAPES["odd"]["w"])}, "bias": leaf(SHAPES["bias"])}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    single = rng.normal(size=(P_PODS, 64, 32)).astype(np.float32)
    steps = [[_tree(rng) for _ in range(P_PODS)] for _ in range(STEPS)]
    return single, steps


_REFERENCE = """
import pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.parallel.collectives import ternary_allreduce, ternary_allreduce_tree
single, steps = pickle.load(open(IN, "rb"))
mesh = jax.make_mesh((2,), ("pod",))
tm = jax.tree_util.tree_map

def one(x):
    out, _ = ternary_allreduce(x[0], "pod", residual=None)
    return out

def tree(g, r):
    s, nr = ternary_allreduce_tree(tm(lambda a: a[0], g), "pod",
                                   residuals=tm(lambda a: a[0], r), error_feedback=True)
    return s, tm(lambda a: a[None], nr)

run1 = jax.jit(shard_map(one, mesh=mesh, in_specs=P("pod"), out_specs=P(),
                         axis_names={"pod"}, check_vma=False))
run = jax.jit(shard_map(tree, mesh=mesh, in_specs=(P("pod"), P("pod")),
                        out_specs=(P(), P("pod")), axis_names={"pod"}, check_vma=False))
out = {"single": np.asarray(run1(jnp.asarray(single))), "steps": []}
res = tm(lambda a: jnp.zeros((2,) + a.shape, jnp.float32), steps[0][0])
for step in steps:
    g = tm(lambda *pods: jnp.stack(pods), *step)
    synced, res = run(g, res)
    out["steps"].append({"synced": tm(np.asarray, synced), "res": tm(np.asarray, res)})
pickle.dump(out, open(OUT, "wb"))
"""


@pytest.fixture(scope="module")
def both(inputs, tmp_path_factory):
    """(the reference's results, each port rank's results)."""
    import pickle

    tmp = tmp_path_factory.mktemp("collectives")
    path = tmp / "in.pkl"
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    ref = run_jax(f"IN = {str(path)!r}\n" + _REFERENCE, 2, tmp)
    single, steps = inputs
    ranks = run_ranks("collectives", P_PODS, tmp, single=single, steps=steps)
    return ref, ranks


def _close(got, want, what: str):
    """Within 1e-6 of the reference's largest |value| (a flipped code
    would move an element by w_q / P, far more)."""
    scale = max(float(np.abs(want).max()), 1e-30)
    gap = float(np.abs(got - want).max())
    assert gap <= 1e-6 * scale, f"{what}: {gap} vs {scale}"


def _leaves(tree):
    return [tree["bias"], tree["conv"]["kernel"], tree["dense"]["w"], tree["head"]["w"],
            tree["odd"]["w"]]


def test_ternary_allreduce_matches_reference(both):
    """One (64, 32) tensor per pod: every rank's mean equals the
    reference's within 1e-6 of its largest value (w_q comes from the
    kernel's moments, Σ|x/denom|·denom / (n + 1e-8), where the reference
    sums |x| and adds 1e-12, so not bit for bit), and the ranks agree bit
    for bit."""
    ref, ranks = both
    for r in ranks:
        _close(r["single"], ref["single"], "single mean")
        np.testing.assert_array_equal(r["single"], ranks[0]["single"])


@pytest.mark.parametrize("step", range(STEPS))
def test_ternary_allreduce_tree_with_error_feedback_matches_reference(both, step):
    """The tree form over 3 steps of error feedback: the synced gradients
    (compressed leaves and exact ones) and every pod's new residuals
    within 1e-6 of their largest |value|."""
    ref, ranks = both
    want = ref["steps"][step]
    for k, r in enumerate(ranks):
        got = r["steps"][step]
        for a, b in zip(_leaves(got["synced"]), _leaves(want["synced"])):
            _close(a, b, f"step {step} synced")
        for a, b in zip(_leaves(got["res"]), _leaves(want["res"])):
            _close(a, b[k], f"step {step} residual of pod {k}")


@pytest.mark.parametrize("step", range(STEPS))
def test_kernel_path_equals_the_plain_version(both, step):
    """The kernel path and ``ternary_allreduce_tree_plain`` on the same
    ranks and the same inputs each step (the kernel path's residuals),
    within fp32 rounding of the scale."""
    _, ranks = both
    for r in ranks:
        got, plain = r["steps"][step], r["plain"][step]
        for a, b in zip(_leaves(got["synced"]) + _leaves(got["res"]),
                        _leaves(plain["synced"]) + _leaves(plain["res"])):
            _close(a, b, "kernel vs plain")


def test_wire_bytes_are_a_quarter_byte_a_coordinate(both):
    """At P = 2 a rank receives 0.25 B per compressed coordinate, 4 B per
    w_q and, for the exact leaves, one fp32 all-reduce."""
    _, ranks = both
    for r in ranks:
        wire = r["steps"][0]["wire"]
        assert wire["all_gather"] == (N_COMP * compressed_bytes_per_element(P_PODS)
                                      + 4 * N_COMP_LEAVES)
        assert wire["all_reduce"] == 4 * N_EXACT
        assert r["single_wire"]["all_gather"] == 64 * 32 // 4 + 4
    assert compressed_bytes_per_element(1) == 0.0


def test_plain_quantize_lastdim_matches_reference():
    """The plain version's quantizer against the reference's
    ``_quantize_lastdim``: packed bytes bit for bit, w_q and the
    reconstruction within fp32 order."""
    rng = np.random.default_rng(3)
    for shape in [(64, 32), (3, 4, 8), (4,)]:
        x = rng.normal(size=shape).astype(np.float32)
        p_ref, w_ref, r_ref = _quantize_lastdim(jnp.asarray(x), 0.7)
        p, w, r = quantize_lastdim_plain(torch.from_numpy(x), 0.7)
        np.testing.assert_array_equal(p.numpy(), np.asarray(p_ref))
        np.testing.assert_allclose(float(w), float(w_ref), rtol=1e-6)
        np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), rtol=1e-6, atol=1e-7)


def test_one_process_tree_and_plain_pods_mean(inputs):
    """Without a group (one pod) the tree form is the compressed value of
    the pod's own gradients; ``pods_mean_plain`` over P trees in one
    process is the plain version the card's emulation uses, and with one
    pod the two agree."""
    _, steps = inputs
    grads = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else
                 {n: torch.from_numpy(a) for n, a in v.items()}) for k, v in steps[0][0].items()}
    synced, res = ternary_allreduce_tree(grads, None)
    plain, plain_res = pods_mean_plain([grads])
    for a, b in zip(_leaves(synced) + _leaves(res), _leaves(plain) + _leaves(plain_res[0])):
        _close(a.numpy(), b.numpy(), "one pod")
    np.testing.assert_array_equal(synced["bias"].numpy(), grads["bias"].numpy())
    with pytest.raises(ValueError):
        ternary_allreduce(torch.ones(4, 6), None)


def test_mesh_description_and_one_process_mesh():
    assert describe(make_production_mesh(multi_pod=True)) == {
        "axes": {"pod": 2, "data": 16, "model": 16}, "n_devices": 512}
    assert describe(make_production_mesh()) == {"axes": {"data": 16, "model": 16},
                                                "n_devices": 256}
    mesh = make_mesh((1, 1, 1), ("pod", "data", "model"), device="cpu")
    assert mesh.coords == {"pod": 0, "data": 0, "model": 0}
    assert mesh.group("pod") is None and mesh.size("model") == 1
    with pytest.raises(RuntimeError):                # needs torch.distributed
        make_mesh((2,), ("pod",), ranks=[0, 1], device="cpu")
    with pytest.raises(ValueError):                  # one process fills no (2,) mesh
        make_mesh((2,), ("pod",), device="cpu")
    with pytest.raises(ValueError):
        make_mesh((1, 1), ("pod",), device="cpu")


def _fanin_inputs():
    rng = np.random.default_rng(0)
    st = rng.integers(0, 3, size=(16, 32, 128), dtype=np.uint8)
    for j in range(1, 4):
        st |= rng.integers(0, 3, st.shape, dtype=np.uint8) << (2 * j)
    co = rng.normal(size=(16,)).astype(np.float32)
    nbytes, n_out = [37, 144, 1, 300], [147, 576, 3, 1200]
    table = fanin_table(nbytes, n_out)
    staged = rng.integers(0, 256, size=(16, table.row_bytes), dtype=np.uint8)
    seg_coeffs = rng.normal(size=(16, len(nbytes))).astype(np.float32)
    return dict(stacked=st, coeffs=co, staged=staged, seg_coeffs=seg_coeffs, nbytes=nbytes,
                n_out=n_out, c_odd=5)


def test_sharded_fanin_equals_the_one_process_fold(tmp_path):
    """The client axis sharded over a (2,) "data" mesh: each rank folds 8
    of 16 clients in one launch and one all-reduce merges the partials;
    sum and vote, stacked and segment forms, equal the one-process fold
    of all 16 within fp32 order, on both ranks; 5 clients (not divisible)
    fold whole on each rank, bit for bit."""
    kw = _fanin_inputs()
    ranks = run_ranks("fanin", 2, tmp_path, **kw)
    st, co = torch.from_numpy(kw["stacked"]), torch.from_numpy(kw["coeffs"])
    sg, sc = torch.from_numpy(kw["staged"]), torch.from_numpy(kw["seg_coeffs"])
    table = fanin_table(kw["nbytes"], kw["n_out"])
    want = {"sum": packed_weighted_sum(st, co), "vote": packed_vote_counts(st, co),
            "sum_segments": packed_weighted_sum_segments(sg, sc, table),
            "vote_segments": packed_vote_counts_segments(sg, co, table)}
    for r in ranks:
        for k, w in want.items():
            np.testing.assert_allclose(r[k], w.numpy(), rtol=1e-6, atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(r["sum_odd"], packed_weighted_sum(st[:5], co[:5]).numpy())
        np.testing.assert_array_equal(r["sum"], ranks[0]["sum"])
