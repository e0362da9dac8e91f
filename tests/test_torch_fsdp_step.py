"""One FSDP train step over the mesh's "data" axis, (data, model) meshes
(2, 1) and (4, 1): olmo-1b (dense), qwen3-moe-30b-a3b (router and expert
stacks cut on D) and zamba2-1.2b (Mamba2 projections and the hybrid's
shared block), all reduced, olmo-1b on (2, 1) with remat "full" and 2
microbatches, and qwen3-moe-30b-a3b on (2, 1) with 2 microbatches (each
rank's microbatch i is its share of the reference's global microbatch i,
which the MoE routes as one batch). The port's step on ``gloo`` CPU ranks, from the state's data
shards, against the reference's GSPMD step on the same mesh shape (params
and Adam moments placed by its specs) and against the port's one-device
step, from the same state and a batch of 4 rows (``_torch_tp_parity.py``);
every rank's new params and moments have their local shapes."""

import pytest

import _torch_tp_parity as P

ARCHS = ["olmo-1b", "qwen3-moe-30b-a3b", "zamba2-1.2b"]
SHAPES = [(2, 1), (4, 1)]
REMAT = {"remat": (["olmo-1b"], [(2, 1)], {"microbatches": 2}, {"remat": "full"}),
         "moe_micro": (["qwen3-moe-30b-a3b"], [(2, 1)], {"microbatches": 2}, {})}


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


@pytest.mark.parametrize("check", [P.check_reference, P.check_one_device])
def test_moe_microbatches_split_the_global_rows(results, check):
    """qwen3-moe with 2 microbatches on (2, 1): microbatch i is the global
    rows [i·B/2, (i+1)·B/2), half on each rank, routed as one batch
    (capacity, queue slots and load loss), as the reference's split of the
    global batch gives it; a rank's contiguous block split in two gave
    another grouping (loss rel 1.13e-3, aux 2.67 against 3.09)."""
    check(results, "qwen3-moe-30b-a3b", (2, 1), "moe_micro")


def test_every_rank_holds_its_local_shapes(results):
    """After the step each rank's params and Adam moments are its shards:
    ``param_shapes(cfg, mesh)``, not the whole leaves."""
    assert all(r[6] for r in results.values())
