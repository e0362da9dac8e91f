"""The all-to-all MoE on the compressed pods × model mesh (2, 1, 2):
qwen3-moe-30b-a3b, reduced, at drop-free capacity (``capacity_factor``
16), three compressed QAT steps of the port with ``moe_impl="a2a"`` (EP
over "model") against the reference's compressed multi-pod step, whose
body is manual over "pod" and GSPMD inside with the scatter dispatch
(``test_torch_tensor_parallel_pods.py``'s reference and rank case, and its
tolerances). The pods' batch axes are "data" alone, so the load loss is
each pod's."""

import dataclasses

import numpy as np
import pytest

import test_torch_tensor_parallel_pods as pods
from _torch_dist import run_jax, run_ranks
from repro_torch.configs import get_reduced

CFG = dataclasses.asdict(get_reduced("qwen3-moe-30b-a3b", capacity_factor=16.0))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the reference's results, the four ranks' results)."""
    tmp = tmp_path_factory.mktemp("tp-pods-a2a")
    ref = run_jax(f"CFGS = {{'moe': {CFG!r}}}\nSTEPS = {pods.STEPS}\nLR = {pods.LR}\n"
                  "MESH = (2, 1, 2)\n" + pods._REFERENCE, 4, tmp, timeout=300)["moe"]
    return ref, run_ranks("tp_pods", 4, tmp / "ranks", timeout=150, cfg=CFG,
                          state=ref["state"], batch=ref["batch"], lr=pods.LR,
                          steps=pods.STEPS, trees=ref["trees"][:1],
                          port={"moe_impl": "a2a", "mesh_ep_axis": "model"})


def test_compressed_a2a_training_matches_reference(run):
    """Three compressed steps from the reference's state: losses within
    rtol 1e-5, params within 2e-4 of each leaf's largest |value|, w_q
    within rtol 1e-4, residuals within 1e-4; all four ranks alike."""
    ref, ranks = run
    want = ref["train"]
    for r in ranks:
        got = r["train"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        for a, b in zip(pods._leaves(got["params"]), pods._leaves(want["params"])):
            pods._close(a, b, 2e-4)
        for a, b in zip(pods._leaves(got["wq"]), pods._leaves(want["wq"])):
            np.testing.assert_allclose(a, b, rtol=1e-4)
        for a, b in zip(pods._leaves(got["residuals"]), pods._leaves(want["residuals"])):
            pods._close(a, b, 1e-4)
    for r in ranks[1:]:
        for a, b in zip(pods._leaves(r["train"]["params"]),
                        pods._leaves(ranks[0]["train"]["params"])):
            np.testing.assert_array_equal(a, b)
