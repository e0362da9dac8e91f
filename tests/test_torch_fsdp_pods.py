"""Pods × FSDP: the compressed cross-pod sync on data shards, on four
``gloo`` CPU ranks (mesh (2, 2, 1) over ("pod", "data", "model")), against
the reference in a subprocess whose JAX sees four forced host devices, with
``tests/test_torch_tensor_parallel_pods.py``'s reference code and dense
config on that mesh: its ``ternary_allreduce_tree`` inside ``shard_map``
manual over "pod", whose max and mean are the whole leaf's, and its
compressed multi-pod train step with the params and moments placed by its
sharding rules (each pod's "data" axis of 2 cuts them)."""

import numpy as np
import pytest

from _torch_dist import run_jax, run_ranks
from test_torch_tensor_parallel_pods import CFG, LR, STEPS, _REFERENCE, _close, _leaves

MESH = (2, 2, 1)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the reference's results, the four ranks' results) of the dense config."""
    tmp = tmp_path_factory.mktemp("fsdp-pods")
    ref = run_jax(f"CFGS = {{'dense': {CFG!r}}}\nSTEPS = {STEPS}\nLR = {LR}\nMESH = {MESH}\n"
                  + _REFERENCE, 4, tmp, timeout=300)["dense"]
    return ref, run_ranks("tp_pods", 4, tmp, timeout=150, cfg=CFG, state=ref["state"],
                          batch=ref["batch"], lr=LR, steps=STEPS, trees=ref["trees"],
                          mesh_shape=MESH)


@pytest.mark.parametrize("step", range(STEPS))
def test_collective_on_data_shards_matches_reference(both, step):
    """Each step of error feedback: every rank's mean (its data shards,
    gathered over "data") within 1e-6 of each leaf's largest |value| of the
    reference's, its pod's residuals too (ranks 0-1 pod 0, 2-3 pod 1), and
    the kernel path within 1e-6 of the plain version on the same shards."""
    ref, ranks = both
    want = ref["collective"][step]
    for rank, r in enumerate(ranks):
        got, plain = r["collective"][step], r["plain"][step]
        for a, b in zip(_leaves(got["synced"]), _leaves(want["synced"])):
            _close(a, b, 1e-6)
        for a, b in zip(_leaves(got["res"]), _leaves(want["res"])):
            _close(a, b[rank // 2], 1e-6)
        for part in ("synced", "res"):
            for a, b in zip(_leaves(got[part]), _leaves(plain[part])):
                _close(a, b, 1e-6)


def test_gathered_bytes_are_a_quarter_byte_a_data_shard_coordinate(both):
    """A rank receives from the other pod 0.25 B per compressed coordinate
    of its data shards plus 4 B per w_q: every attention and MLP leaf is cut
    in half on D over "data"."""
    _, ranks = both
    whole = 2 * (64 * 64 + 2 * 64 * 32 + 64 * 64 + 3 * 64 * 128)
    for r in ranks:
        for step in r["collective"]:
            assert step["wire"]["all_gather"] == whole // 2 // 4 + 4 * 7


def test_compressed_training_on_data_shards_matches_reference(both):
    """Three compressed steps over (2, 2, 1) from the reference's state, to
    the pods x model test's tolerances: losses within rtol 1e-5, the params
    within 2e-4 of each leaf's largest, the w_q within rtol 1e-4, the
    residuals gathered over pods and data shards within 1e-4; all four
    ranks alike."""
    ref, ranks = both
    want = ref["train"]
    for r in ranks:
        got = r["train"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        for a, b in zip(_leaves(got["params"]), _leaves(want["params"])):
            _close(a, b, 2e-4)
        for a, b in zip(_leaves(got["wq"]), _leaves(want["wq"])):
            np.testing.assert_allclose(a, b, rtol=1e-4)
        for a, b in zip(_leaves(got["residuals"]), _leaves(want["residuals"])):
            _close(a, b, 1e-4)
    for r in ranks[1:]:
        for a, b in zip(_leaves(r["train"]["params"]), _leaves(ranks[0]["train"]["params"])):
            np.testing.assert_array_equal(a, b)
