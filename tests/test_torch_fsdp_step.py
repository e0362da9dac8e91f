"""One FSDP train step over the mesh's "data" axis, (data, model) meshes
(2, 1) and (4, 1): olmo-1b (dense), qwen3-moe-30b-a3b (router and expert
stacks cut on D) and zamba2-1.2b (Mamba2 projections and the hybrid's
shared block), all reduced, and olmo-1b on (2, 1) with remat "full" and 2
microbatches. The port's step on ``gloo`` CPU ranks, from the state's data
shards, against the reference's GSPMD step on the same mesh shape (params
and Adam moments placed by its specs) and against the port's one-device
step, from the same state and a batch of 4 rows (``_torch_tp_parity.py``);
every rank's new params and moments have their local shapes."""

import pytest

import _torch_tp_parity as P

ARCHS = ["olmo-1b", "qwen3-moe-30b-a3b", "zamba2-1.2b"]
SHAPES = [(2, 1), (4, 1)]
REMAT = {"remat": (["olmo-1b"], [(2, 1)], {"microbatches": 2}, {"remat": "full"})}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return P.both(ARCHS, tmp_path_factory.mktemp("fsdp-step"), SHAPES, rows=4, variants=REMAT)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_step_matches_reference_gspmd(results, arch, shape):
    P.check_reference(results, arch, shape)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_step_matches_one_device(results, arch, shape):
    P.check_one_device(results, arch, shape)


@pytest.mark.parametrize("check", [P.check_reference, P.check_one_device])
def test_remat_full_with_microbatches(results, check):
    """remat "full" (each layer's gather runs again in the backward) and 2
    microbatches (each chunk's gathers and reduce-scatters) on (2, 1)."""
    check(results, "olmo-1b", (2, 1), "remat")


def test_every_rank_holds_its_local_shapes(results):
    """After the step each rank's params and Adam moments are its shards:
    ``param_shapes(cfg, mesh)``, not the whole leaves."""
    assert all(r[6] for r in results.values())
