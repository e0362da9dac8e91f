"""One bf16 train step per family over the "model" axis, part two (part
one is ``test_torch_bf16_mesh_families_a.py``): zamba2-1.2b (the hybrid's
shared block), llama-3.2-vision-11b (the vlm's gated cross layers, the
gates opened to 0.5) and hubert-xlarge (the audio encoder), reduced, in
the reference's production cell, 2 microbatches of 2 rows, on a (1, 2)
data x model mesh of ``gloo`` CPU ranks, against the reference's GSPMD
step on that mesh (compiled with ``_torch_train_parity.PER_OP``) and the
port's one-device step (``_torch_tp_parity.py``)."""

import pytest

import _torch_tp_parity as P
from _torch_train_parity import BF16, BF16_LR

ARCHS = ["zamba2-1.2b", "llama-3.2-vision-11b", "hubert-xlarge"]
CELL = dict(BF16, mesh_batch_axes=("data",))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return P.both(ARCHS, tmp_path_factory.mktemp("bf16-mesh-fam-b"), [(1, 2)], rows=4,
                  tcfg={"qat": True, "microbatches": 2}, overrides=CELL, lr=BF16_LR,
                  reference_one=True, timeout=240)


@pytest.mark.parametrize("arch", ARCHS)
def test_step_matches_reference_gspmd(results, arch):
    P.check_reference_bf16(results, arch, (1, 2))


@pytest.mark.parametrize("arch", ARCHS)
def test_step_matches_one_device(results, arch):
    P.check_one_device_bf16(results, arch, (1, 2))


def test_every_rank_holds_its_local_shapes(results):
    assert all(r[6] for r in results.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_shard_codes_are_the_whole_leaf_codes(results, arch):
    codes = results[(arch, (1, 2))][9]["codes"]
    assert codes and all(bad == 0 for _, bad in codes.values()), codes
