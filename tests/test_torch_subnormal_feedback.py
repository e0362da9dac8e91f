"""XLA's subnormal rule in error feedback, port against reference.

With error feedback a client's encode corrects each leaf by the residual it
carries, x = leaf + residual, and keeps x − decode(wire) for the next
encode. XLA forms both with subnormals flushed (a subnormal operand reads as
zero, a subnormal result comes out as zero); the port forms them with
``dtypes.xla_op``. Here every registered codec, as the kind codec and as the
residual codec, encodes the same tree three times, carrying the residual,
against ``repro.core.compression.compress_pytree``; and the two-pod
compressed sync (``ternary_allreduce_tree``) runs three steps on two such
trees against the reference's under ``shard_map``.

The tree's leaves: a (64, 32) weight whose first 16 rows are subnormal, an
all-subnormal bias, an all-subnormal (16, 32) weight, and a (16, 32) weight
of values within six steps of 2^-126 on either side. The wire bytes are
sha256-identical and every residual bit-identical, except where a scale
comes from sums that run in another order than XLA's (the ternary codec's
tile moments, the sync's w_q): there the codes are exact, each residual
whose codes have all been zero so far (where it is the corrected input
itself) is exact, and the rest is within 1e-6 of the reference's scale a
step.
"""

import hashlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import run_jax, run_ranks
from _torch_subnormal_cases import TINY, feedback_tree as _tree
from repro.comm import encode_update as jencode_update
from repro.core import compression as jcomp
from repro.core import ternary as jternary
from repro_torch.comm import encode_update
from repro_torch.core import CodecSpec, available_codecs, compress_pytree
from repro_torch.core.compression import is_wire_leaf
from repro_torch.core.ternary import TernaryTensor
from repro_torch.tree import flatten_with_path, path_str

torch.set_num_threads(1)

ROUNDS = 3
PAIRS = [(k, r) for k in available_codecs() for r in available_codecs()
         if (k, r) != ("none", "none")]


def test_the_tree_holds_what_it_should():
    tree = _tree()
    sub = lambda a: (np.abs(a) < TINY) & (a != 0)  # noqa: E731
    assert sub(tree["layer"]["w"][:16]).all() and not sub(tree["layer"]["w"][16:]).any()
    assert sub(tree["layer"]["bias"]).all() and sub(tree["sub"]["w"]).all()
    edge = tree["edge"]["w"]
    assert 0 < sub(edge).sum() < edge.size and (np.abs(edge) <= TINY + 6 * 2.0 ** -149).all()


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _codes(leaf) -> np.ndarray:
    """A ternary wire leaf's codes in {-1, 0, 1}, flat."""
    n = int(np.prod(leaf.shape))
    packed = _np(leaf.packed).reshape(-1)
    return np.stack([(packed >> s) & 3 for s in (0, 2, 4, 6)], 1).reshape(-1)[:n] \
        .astype(np.int8) - 1


def _hold_leaf(got, want, got_res, want_res, exact, step, what):
    """One leaf's wire and residual, as the module docstring sets out.
    ``exact`` marks the positions whose codes were 0 at every earlier step
    (their residual, the corrected input itself, is exact so far; None for
    a leaf that is not ternary-coded). Returns it for the next step."""
    if not isinstance(got, TernaryTensor):
        assert not isinstance(want, jternary.TernaryTensor), what
        _bits_equal(got_res, want_res, what)
        return None
    codes = _codes(got)
    np.testing.assert_array_equal(codes, _codes(want), err_msg=what)
    w, jw = _np(got.w_q), np.asarray(want.w_q)
    if not codes.any():
        _bits_equal(w, jw, what + " scale")
    else:
        np.testing.assert_allclose(w, jw, rtol=1e-6, err_msg=what)
    exact = (codes == 0) & (True if exact is None else exact)
    r, jr = _np(got_res).reshape(-1), np.asarray(want_res).reshape(-1)
    _bits_equal(r[exact], jr[exact], what + " residual where every code so far is 0")
    # elsewhere r − jr sums the scales' gaps, each within 1e-6 of a scale
    np.testing.assert_allclose(r[~exact], jr[~exact], rtol=1e-6,
                               atol=1e-6 * (step + 1) * float(np.abs(jw).max()), err_msg=what)
    return exact


def _bits_equal(got, want, what):
    if got is None:
        assert want is None, what
        return
    got, want = np.atleast_1d(_np(got)), np.atleast_1d(np.asarray(want))
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8), err_msg=what)


@pytest.mark.parametrize("kind,residual", PAIRS)
def test_codec_error_feedback_matches_reference(kind, residual):
    """Three encodes with error feedback: where neither codec is ternary the
    whole wire buffer is sha256-identical and every residual bit-identical;
    a ternary leaf as ``_hold_leaf`` holds it."""
    tree = _tree()
    spec = CodecSpec(kind=kind, residual=residual, topk_fraction=0.3, error_feedback=True)
    jspec = jcomp.CodecSpec(kind=kind, residual=residual, topk_fraction=0.3,
                            error_feedback=True)
    res = jres = None
    exact = {}
    for step in range(ROUNDS):
        wire, res = compress_pytree(jax.tree_util.tree_map(torch.from_numpy, tree), spec,
                                    residual=res)
        jwire, jres = jcomp.compress_pytree(jax.tree_util.tree_map(jnp.asarray, tree), jspec,
                                            residual=jres)
        if "ternary" not in (kind, residual):
            blob, jblob = encode_update(wire), jencode_update(jwire)
            assert hashlib.sha256(blob).digest() == hashlib.sha256(jblob).digest(), step
        flat = flatten_with_path(wire, is_leaf=is_wire_leaf)
        jflat = jax.tree_util.tree_leaves(jwire, is_leaf=jcomp.is_wire_leaf)
        rflat = [r for _, r in flatten_with_path(res)]
        jrflat = jax.tree_util.tree_leaves(jres)
        assert len(flat) == len(jflat) == len(rflat) == len(jrflat)
        for (path, got), want, r, jr in zip(flat, jflat, rflat, jrflat):
            name = path_str(path)
            exact[name] = _hold_leaf(got, want, r, jr, exact.get(name), step,
                                     f"{kind}/{residual} step {step} {name}")


def test_codec_residual_of_a_subnormal_leaf_stays_zero():
    """The case that grew before the rule: with ternary codes and error
    feedback on an all-subnormal leaf, the residual is read as zeros, so
    every code stays 0 and the residual stays 0 (the port once summed
    subnormal residuals until a code turned nonzero)."""
    leaf = (np.random.default_rng(3).normal(size=(16, 32)) * 1e-39).astype(np.float32)
    spec = CodecSpec(kind="ternary", error_feedback=True)
    res = None
    for _ in range(6):
        wire, res = compress_pytree({"w": torch.from_numpy(leaf)}, spec, residual=res)
        assert not _codes(wire["w"]).any() and float(wire["w"].w_q) == 0.0
        assert not bool(res["w"].any())


# --------------------------------------------------------------------------
# The two-pod compressed sync.
# --------------------------------------------------------------------------

P_PODS = 2
COMPRESSED = ("edge/w", "layer/w", "sub/w")

_REFERENCE = """
import pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.parallel.collectives import _quantize_lastdim, ternary_allreduce_tree
steps = pickle.load(open(IN, "rb"))
mesh = jax.make_mesh((2,), ("pod",))
tm = jax.tree_util.tree_map

def tree(g, r):
    g, r = tm(lambda a: a[0], g), tm(lambda a: a[0], r)
    s, nr = ternary_allreduce_tree(g, "pod", residuals=r, error_feedback=True)
    packed = {k: _quantize_lastdim(g[k]["w"].astype(jnp.float32) + r[k]["w"], 0.7)[0]
              for k in ("edge", "layer", "sub")}
    return s, tm(lambda a: a[None], nr), tm(lambda a: a[None], packed)

run = jax.jit(shard_map(tree, mesh=mesh, in_specs=(P("pod"), P("pod")),
                        out_specs=(P(), P("pod"), P("pod")), axis_names={"pod"},
                        check_vma=False))
out = []
res = tm(lambda a: jnp.zeros((2,) + a.shape, jnp.float32), steps[0][0])
for step in steps:
    g = tm(lambda *pods: jnp.stack(pods), *step)
    synced, res, packed = run(g, res)
    out.append({"synced": tm(np.asarray, synced), "res": tm(np.asarray, res),
                "packed": tm(np.asarray, packed)})
pickle.dump(out, open(OUT, "wb"))
"""


def ref_inputs() -> list:
    """Each step's gradient tree of each pod."""
    return [[_tree(10 * step + pod) for pod in range(P_PODS)] for step in range(ROUNDS)]


@pytest.fixture(scope="module")
def sync(tmp_path_factory):
    """(the reference's steps, each port rank's steps)."""
    steps = ref_inputs()
    tmp = tmp_path_factory.mktemp("subnormal_sync")
    path = tmp / "in.pkl"
    with open(path, "wb") as f:
        pickle.dump(steps, f)
    ref = run_jax(f"IN = {str(path)!r}\n" + _REFERENCE, P_PODS, tmp)
    ranks = run_ranks("subnormal_sync", P_PODS, tmp, steps=steps)
    return ref, ranks


def _leaf(tree, name):
    a, b = name.split("/")
    return tree[a][b]


def test_two_pod_sync_codes_and_residuals_match_reference(sync):
    """Three steps with error feedback: each pod's packed codes of its
    corrected gradient (the bytes it all-gathers) byte for byte; its new
    residuals exact where its codes have all been 0 so far (on the
    subnormal leaves, zeros), within 1e-6 of the leaf's largest |x| a step
    elsewhere (w_q comes from sums in another order than XLA's); the
    exact-mean bias's residual zero; the synced means within 1e-6 of their
    largest |value|, or zeros where the reference's are all zero (the
    subnormal bias, whose mean XLA flushes)."""
    ref, ranks = sync
    exact = {}
    for step, want in enumerate(ref):
        for k, r in enumerate(ranks):
            got = r[step]
            for name in COMPRESSED:
                what = f"step {step} {name} pod {k}"
                packed = got["packed"][name]
                np.testing.assert_array_equal(packed, want["packed"][name.split("/")[0]][k],
                                              err_msg=what)
                codes = np.stack([(packed >> s) & 3 for s in (0, 2, 4, 6)], -1).reshape(-1)
                ok = exact[name, k] = (codes == 1) & exact.get((name, k), True)
                res, jres = _leaf(got["res"], name).reshape(-1), _leaf(want["res"], name)[k]
                jres = jres.reshape(-1)
                _bits_equal(res[ok], jres[ok], what)
                x = _leaf(ref_inputs()[step][k], name)
                np.testing.assert_allclose(res[~ok], jres[~ok], rtol=0,
                                           atol=1e-6 * (step + 1) * float(np.abs(x).max()),
                                           err_msg=what)
            _bits_equal(got["res"]["layer"]["bias"], want["res"]["layer"]["bias"][k], "bias")
            for name in COMPRESSED + ("layer/bias",):
                s, js = _leaf(got["synced"], name), _leaf(want["synced"], name)
                scale = float(np.abs(js).max())
                if scale == 0.0:   # zeros (of either sign: the all-reduce's sum picks it)
                    np.testing.assert_array_equal(s, js, err_msg=f"step {step} {name}")
                else:
                    assert float(np.abs(s - js).max()) <= 1e-6 * scale, (step, name)
