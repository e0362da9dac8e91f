"""olmo-1b in the reference's bf16 production train cell over the mesh
(``repro.launch.dryrun.build_cell``: bf16 params and compute, remat "full",
QAT, adam(1e-4), 2 microbatches, the batch constrained to "data" by
``mesh_batch_axes``), reduced, on (data, model) meshes (1, 2), (2, 1) and
(2, 2): two steps of the port on ``gloo`` CPU ranks from the reference's
state, each held to the reference's GSPMD step on the same mesh (compiled
with ``_torch_train_parity.PER_OP``) and to the port's one-device step
(``_torch_tp_parity.py``); every rank's state its local shapes, the
results arriving bit for bit as rank 0 gathered them, and the QAT codes of
the shards those of the whole leaves.

The "data" axis (ROADMAP Queue 3). XLA's compiled (2, 1) step shows where
a mesh step's bf16 roundings come from. With build_cell's constraint every
weight is all-gathered (``f32[64,64] all-gather``, ``f32[64,256]
all-gather``) and each row's forward is the one-device forward: the loss
is the one-device loss bit for bit in both packages. Each weight's
gradient is then each shard's partial product over its rows rounded to
bf16 and summed over "data" (``all-reduce(...), to_apply=%add.clone_
promoted`` of ``convert(convert(dot))``, f32 → bf16 → f32), the rounding
the port's reduce-scatter of each rank's bf16 gradient makes. Without the
constraint (not the production program) XLA instead cuts the activations'
D over "data" and all-reduces the q, k, v and MLP products
(``(f32[4,16,64], ...) all-reduce(%convert_bitcast_fusion.12, ...)``):
partial dot products, each rounded to bf16, summed. That is the
partitioner's choice of where to sum, a reduction-order difference that
moves the reference's first loss 6.47e-5 (2, 1) and 4.48e-5 (2, 2) from
its one-device loss, while the port's mesh step stays within 0 and 6.9e-6
of its one-device step; ``test_unconstrained_program_is_a_reduction_order
_difference`` holds the two there."""

import pytest

import _torch_dist_cases as C
import _torch_tp_parity as P
from _torch_train_parity import BF16, BF16_LR, EPS, assert_bf16_step_matches

SHAPES = [(1, 2), (2, 1), (2, 2)]
DATA = [(2, 1), (2, 2)]
CELL = dict(BF16, mesh_batch_axes=("data",))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return P.both(["olmo-1b"], tmp_path_factory.mktemp("bf16-mesh-olmo"), SHAPES, rows=4,
                  tcfg={"qat": True, "microbatches": 2}, overrides=CELL, lr=BF16_LR, steps=2,
                  reference_one=True, timeout=240,
                  variants={"unconstrained": (["olmo-1b"], DATA, {}, {"mesh_batch_axes": ()})})


@pytest.mark.parametrize("shape", SHAPES)
def test_steps_match_reference_gspmd(results, shape):
    P.check_reference_bf16(results, "olmo-1b", shape)


@pytest.mark.parametrize("shape", SHAPES)
def test_steps_match_one_device(results, shape):
    P.check_one_device_bf16(results, "olmo-1b", shape)


@pytest.mark.parametrize("shape", DATA)
def test_data_axis_first_step_is_the_one_device_step(results, shape):
    """On the meshes with a "data" axis the first step is held to the
    port's one-device step at ``assert_bf16_step_matches``'s tolerances,
    unchanged; on (2, 1), with no "model" axis, the loss bit for bit (the
    forward gathers whole weights)."""
    _, _, new, m, one, m1 = results[("olmo-1b", shape)][:6]
    assert_bf16_step_matches(P._one_np(one), m1, new, m)
    if shape[1] == 1:
        assert m["loss"] == m1["loss"]


@pytest.mark.parametrize("shape", DATA)
def test_unconstrained_program_is_a_reduction_order_difference(results, shape):
    """Without ``mesh_batch_axes`` the reference sums partial products
    over "data" (see the module docstring). Each step of the port's mesh
    step against the reference's: the loss and grad norm within twice the
    larger of the two packages' gaps between their mesh and one-device
    steps (measured first-step loss gaps: reference 6.47e-5 (2, 1) and
    4.48e-5 (2, 2), port 0 and 6.9e-6), never tighter than
    ``check_reference_bf16``'s; Adam's m and v as there."""
    key = ("olmo-1b", shape, "unconstrained")
    entry = results[key]
    for i, ((jnew, jm, new, m, one, m1), (jone, jom)) in enumerate(zip(entry[7], entry[8]), 1):
        ref_gap = P.reference_gap(jnew, jm, jone, jom)
        port_gap = {k: abs(m[k] - m1[k]) / abs(m1[k]) for k in ("loss", "grad_norm")}
        first = i == 1
        tol = {"loss_rtol": max(2.0 ** (-14 if first else -13),
                                2 * max(ref_gap["loss"], port_gap["loss"])),
               "gn_rtol": max(EPS / (4 if first else 2),
                              2 * max(ref_gap["grad_norm"], port_gap["grad_norm"]))}
        if first:
            assert_bf16_step_matches(jnew, jm, new, m, g_floor=1e-6, **tol)
            assert ref_gap["loss"] > 2.0 ** -16 and port_gap["loss"] < ref_gap["loss"]
        else:
            P.assert_bf16_later_step_matches(jnew, jm, new, m, i, **tol)


@pytest.mark.parametrize("shape", SHAPES)
def test_results_arrive_bit_for_bit(results, shape):
    """The last gathered bf16 state as rank 0 hashed it (every leaf's path,
    dtype and raw bytes) is the one the test reads back."""
    entry = results[("olmo-1b", shape)]
    assert entry[9]["digest"] == C._digest(entry[7][-1][2])


@pytest.mark.parametrize("shape", SHAPES)
def test_shard_codes_are_the_whole_leaf_codes(results, shape):
    """After two steps, the QAT forward on each rank's shards (with the
    whole leaf's statistics) gathered is one process's on the whole
    leaves, bit for bit, for every quantized leaf."""
    codes = results[("olmo-1b", shape)][9]["codes"]
    assert len(codes) >= 7
    assert all(bad == 0 for _, bad in codes.values()), codes


def test_every_rank_holds_its_local_shapes(results):
    assert all(r[6] for r in results.values())
