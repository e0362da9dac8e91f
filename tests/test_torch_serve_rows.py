"""Serving over the mesh's batch axes: the port's prefill and decode steps
on (data, model) meshes (2, 1), (1, 2), (2, 2) and (4, 1) of ``gloo`` CPU
ranks against the reference's GSPMD steps on the same mesh shapes
(``_torch_serve_parity.py``), for olmo-1b, granite-20b (MQA: the
sequence over "model") and gemma3-4b (sliding window), all reduced
(zamba2-1.2b and qwen3-moe-30b-a3b: ``test_torch_serve_rows_families.py``). Batch 4 cuts the rows over "data"; batch 1 cuts the cache's
sequence over "data", or ("data", "model"). Every rank's cache leaves are
the reference's shard shapes, except the SSM states."""

import pytest

import _torch_serve_parity as P

ARCHS = ["olmo-1b", "granite-20b", "gemma3-4b"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return P.both(ARCHS, tmp_path_factory.mktemp("serve-rows"))


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
