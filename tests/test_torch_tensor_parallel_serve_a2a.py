"""Serving through the all-to-all MoE under a "model" axis: the prefill
(2 chunks) and 7 greedy decode steps of ``launch.steps`` with
``moe_impl="a2a"`` (EP over "model") on ``gloo`` CPU ranks, from the
seed-0 params' shards, against one process with the scatter dispatch at
drop-free capacity (``capacity_factor`` 16): qwen3-moe-30b-a3b and
deepseek-moe-16b, reduced, on (data, model) mesh (2, 2) with batch 4 (a
rank's rows) and 1 (every rank the whole batch), and on (1, 4) with
batch 1, where a decode step's T_loc·k = 2 copies are fewer than the
n_ep = 4 ranks they are sent to (every queue of C_send = 8 slots holds at
most one)."""

import numpy as np
import pytest

from _torch_dist import run_ranks

ARCHS = ["qwen3-moe-30b-a3b", "deepseek-moe-16b"]
RUNS = [((2, 2), 4), ((2, 2), 1), ((1, 4), 1)]
S, MAX, GEN, CHUNKS = 6, 16, 7, 2


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """{(arch, shape, batch): rank 0's {"a2a", "one"} results}."""
    prompts = np.random.default_rng(0).integers(0, 128, (4, S))
    runs = [{"arch": a, "overrides": {"capacity_factor": 16.0}, "shape": shape, "batch": b}
            for a in ARCHS for shape, b in RUNS]
    got = run_ranks("a2a_serve", 4, tmp_path_factory.mktemp("a2a-serve"), timeout=150,
                    runs=runs, prompts=prompts, max_seq=MAX, gen=GEN, chunks=CHUNKS)
    return {(r["arch"], r["shape"], r["batch"]): got[0][i] for i, r in enumerate(runs)}


@pytest.mark.parametrize("shape,batch", RUNS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_one_process(served, arch, shape, batch):
    """Every step's logits, gathered over the rows, within 1e-5 of max
    |logits| of one process's, with the same greedy tokens."""
    got = served[(arch, shape, batch)]
    a2a, one = got["a2a"], got["one"]
    assert len(a2a["logits"]) == len(one["logits"]) == 1 + GEN
    for a, b in zip(a2a["logits"], one["logits"]):
        assert a.shape == b.shape == (batch, 1, 128)
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    for a, b in zip(a2a["tokens"], one["tokens"]):
        np.testing.assert_array_equal(a, b)
