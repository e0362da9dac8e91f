"""Serving over the mesh's batch axes for the hybrid and MoE families, as
``test_torch_serve_rows.py`` does for the dense ones: zamba2-1.2b (its
shared attention block's cache cut as the KV rule says, its SSM states
by rows and, over "model", by conv channels and SSD heads) and qwen3-moe-30b-a3b (the MoE routing the ranks' rows
as one batch), reduced, on (data, model) meshes (2, 1), (1, 2), (2, 2)
and (4, 1) of ``gloo`` CPU ranks against the reference's GSPMD steps.
Batch 4 cuts the rows over "data"; batch 1 cuts the cache's sequence over
"data", or ("data", "model"). Every rank's cache leaves are the
reference's shard shapes."""

import pytest

import _torch_serve_parity as P

ARCHS = ["zamba2-1.2b", "qwen3-moe-30b-a3b"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return P.both(ARCHS, tmp_path_factory.mktemp("serve-rows-families"))


@pytest.mark.parametrize("batch", P.BATCHES)
@pytest.mark.parametrize("shape", P.SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_reference_gspmd(results, arch, shape, batch):
    P.check_logits(results[(arch, shape, batch)])


@pytest.mark.parametrize("batch", P.BATCHES)
@pytest.mark.parametrize("shape", P.SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_is_the_reference_shard(results, arch, shape, batch):
    P.check_cache(results[(arch, shape, batch)], shape)
