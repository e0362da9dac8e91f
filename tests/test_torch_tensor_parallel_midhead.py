"""Tensor parallelism with more "model" ranks than query heads: a rank's
``wq`` columns cut a query head, so q is gathered over "model", the rank
computes the whole heads its columns touch and keeps its own output
columns for the row-parallel ``wo`` (``models.attention``). gemma3-4b,
reduced (d 64, head width 16, 6 layers: five sliding-window layers and a
global one), on the (data, model) mesh (1, 4) with 2 query heads and 1 kv
head (a rank holds half a query head and a quarter of the kv head) and
with 2 and 2 (half heads of both): one train step against the reference's
GSPMD step from the same state (``_torch_tp_parity.py``), every leaf's
gradient against one process, and prefill and decode with the cache's
sequence over "model" against the reference's GSPMD steps
(``_torch_serve_parity.py``); then the layouts of the production mesh and
why RoPE must not run on a column shard."""

import numpy as np
import pytest
import torch

import _torch_serve_parity as SP
import _torch_tp_parity as P
from _torch_dist import run_ranks
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.attention import head_layout
from repro_torch.models.common import apply_rope
from repro_torch.parallel.tensor import MeshAxis

HEADS = {"h2kv1": {"n_heads": 2, "n_kv_heads": 1}, "h2kv2": {"n_heads": 2, "n_kv_heads": 2}}
MESH = (1, 4)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    return P.both(["gemma3-4b"], tmp_path_factory.mktemp("midhead-step"), shapes=[],
                  variants={k: (["gemma3-4b"], [MESH], {}, ov) for k, ov in HEADS.items()})


@pytest.fixture(scope="module")
def grads(tmp_path_factory):
    """{heads: rank 0's {"tp", "one"} (loss, gradients)}."""
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 256, (2, 12))
    runs = [{"arch": "gemma3-4b", "shape": MESH, "axes": ("data", "model"), "overrides": ov,
             "variants": {"tp": ({}, False)}} for ov in HEADS.values()]
    got = run_ranks("tp_grads", 4, tmp_path_factory.mktemp("midhead-grads"), timeout=120,
                    runs=runs, tokens=tokens, labels=np.roll(tokens, -1, 1))
    return dict(zip(HEADS, got[0]))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return SP.both(list(HEADS), tmp_path_factory.mktemp("midhead-serve"), shapes=[MESH],
                   overrides={k: ("gemma3-4b", ov) for k, ov in HEADS.items()})


@pytest.mark.parametrize("heads", HEADS)
def test_step_matches_reference_gspmd(steps, heads):
    P.check_reference(steps, "gemma3-4b", MESH, heads)


@pytest.mark.parametrize("heads", HEADS)
def test_gradients_match_one_process(grads, heads):
    """The loss within rtol 2e-6 and every leaf's gradient, gathered
    whole, within 1e-5 of its largest |value| of one process's."""
    (loss, g), (loss1, g1) = grads[heads]["tp"], grads[heads]["one"]
    np.testing.assert_allclose(loss, loss1, rtol=2e-6)
    for name, b in g1.items():
        assert np.abs(g[name] - b).max() <= 1e-5 * max(np.abs(b).max(), 1e-30), name


@pytest.mark.parametrize("batch", SP.BATCHES)
@pytest.mark.parametrize("heads", HEADS)
def test_prefill_and_decode_match_reference_gspmd(served, heads, batch):
    """Prefill in 2 chunks and 7 greedy steps through the local and global
    layers, the cache's sequence over "model": logits within 1e-5 of max
    |logits| of the reference's, the same tokens, and every rank's cache
    the reference's shard."""
    SP.check_logits(served[(heads, MESH, batch)])
    SP.check_cache(served[(heads, MESH, batch)], MESH)


def test_gemma3_on_sixteen_ranks_cuts_each_head_in_half():
    """gemma3-4b (8 query heads, 4 kv heads of width 256) over 16 "model"
    ranks: rank j holds wq columns [128 j, 128 (j + 1)), half of query head
    j // 2, and reads kv head j // 4 from the gathered wk/wv."""
    for j in range(16):
        lay = head_layout(8, 4, 256, MeshAxis(None, 16, j))
        assert (lay.col_lo, lay.col_hi, lay.split) == (128 * j, 128 * (j + 1), True)
        assert (lay.q_lo, lay.q_hi, lay.kv_lo, lay.kv_hi, lay.kv) == (
            j // 2, j // 2 + 1, j // 4, j // 4 + 1, "gather")


def test_every_production_layout_is_expressed():
    """No arch of the zoo reaches ``head_layout``'s refusal on the
    production meshes' 16 "model" ranks; a grouping the rule cannot
    express (3 query heads a rank over two kv heads) is refused, naming
    it."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        if cfg.n_heads:
            for j in range(16):
                head_layout(cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                            MeshAxis(None, 16, j))
    with pytest.raises(NotImplementedError, match=r"query heads \[0, 3\) do not group evenly"):
        head_layout(6, 3, 4, MeshAxis(None, 2, 0))


def test_rope_on_a_column_shard_differs():
    """RoPE rotates dim i with dim i + hd/2, so half a head holds no
    complete pair: rotating a column shard is not the shard of the rotated
    head, which is why q is gathered over "model" before RoPE."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 5, 1, 16), generator=g)
    pos = torch.arange(5)[None]
    whole = apply_rope(q, pos, 10000.0)
    for half in (slice(0, 8), slice(8, 16)):
        shard = apply_rope(q[..., half], pos, 10000.0)
        assert (shard - whole[..., half]).abs().max() > 1e-2
