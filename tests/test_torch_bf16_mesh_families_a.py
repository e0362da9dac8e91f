"""One bf16 train step per family over the "model" axis, part one: the
reference's production cell (``repro.launch.dryrun.build_cell``: bf16
params and compute, remat "full", QAT, adam(1e-4), the batch constrained to
"data"), reduced, 2 microbatches of 2 rows, on a (1, 2) data x model mesh
of ``gloo`` CPU ranks, against the reference's GSPMD step on that mesh
(compiled with ``_torch_train_parity.PER_OP``) and the port's one-device
step (``_torch_tp_parity.py``): gemma3-4b (sliding windows), mamba2-370m
(the SSM family) and qwen3-moe-30b-a3b through the all-to-all MoE with EP
over "model" (``moe_impl="a2a"``), with a bf16 wire and with build_cell's
int8 wire. The MoE runs at drop-free capacity (``capacity_factor`` 16),
where the reference's scatter dispatch (its a2a fails on JAX 0.9, ROADMAP
Queue 3) routes every token as the a2a does; at the default capacity the
two drop different tokens."""

import pytest

import _torch_tp_parity as P
from _torch_train_parity import BF16, BF16_LR

ARCHS = ["gemma3-4b", "mamba2-370m"]
MOE = "qwen3-moe-30b-a3b"
CELL = dict(BF16, mesh_batch_axes=("data",))
A2A = {"moe_impl": "a2a", "mesh_ep_axis": "model"}
DROP_FREE = {"capacity_factor": 16.0}
WIRES = {w: ([MOE], [(1, 2)], {}, DROP_FREE, {**A2A, "moe_wire": w}) for w in ("bf16", "int8")}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return P.both(ARCHS, tmp_path_factory.mktemp("bf16-mesh-fam-a"), [(1, 2)], rows=4,
                  tcfg={"qat": True, "microbatches": 2}, overrides=CELL, lr=BF16_LR,
                  reference_one=True, variants=WIRES, timeout=240)


@pytest.mark.parametrize("arch", ARCHS)
def test_step_matches_reference_gspmd(results, arch):
    P.check_reference_bf16(results, arch, (1, 2))


@pytest.mark.parametrize("arch", ARCHS)
def test_step_matches_one_device(results, arch):
    P.check_one_device_bf16(results, arch, (1, 2))


@pytest.mark.parametrize("check", [P.check_reference_bf16, P.check_one_device_bf16])
def test_a2a_bf16_wire_step(results, check):
    """The a2a with a bf16 wire against the reference's scatter dispatch
    and the port's one-device step."""
    check(results, MOE, (1, 2), "bf16")


def test_a2a_int8_wire_step_matches_reference_gspmd(results):
    """build_cell's int8 wire (each slot's codes with an fp32 scale, both
    ways) against the reference's scatter dispatch: the loss within rtol
    1e-3, the fp32 int8 test's limit (measured 3.0e-4), the rest at
    ``check_reference_bf16``'s tolerances (Adam's m 3.2ε and v 5.4ε
    measured). Its one-device step has no wire, so it has no one-device
    check."""
    P.check_reference_bf16(results, MOE, (1, 2), "int8", loss_rtol=1e-3)


def test_every_rank_holds_its_local_shapes(results):
    assert all(r[6] for r in results.values())


@pytest.mark.parametrize("key", [(a, (1, 2)) for a in ARCHS] + [(MOE, (1, 2), w) for w in WIRES])
def test_shard_codes_are_the_whole_leaf_codes(results, key):
    codes = results[key][9]["codes"]
    assert codes and all(bad == 0 for _, bad in codes.values()), codes
