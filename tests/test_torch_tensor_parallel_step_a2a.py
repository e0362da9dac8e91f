"""The all-to-all MoE (``moe_impl="a2a"``, EP over "model") inside the
tensor-parallel train step: qwen3-moe-30b-a3b and deepseek-moe-16b (its
shared experts column- and row-parallel), reduced, at drop-free capacity
(``capacity_factor`` 16), each rank holding its own experts and routing
the replicated tokens. On (data, model) meshes (1, 2) and (2, 2) of
``gloo`` CPU ranks: one step against the reference's GSPMD step (scatter
dispatch on the JAX side) from the same state (``_torch_tp_parity.py``);
the loss and every leaf's gradient against the port's scatter-dispatch TP
step from the same params, also on the compressed pods × model mesh (2, 1,
2); and the same gradients without the 1/n_ep scale of the returned
copies, which must fail that limit on the expert stacks (each expert's
owner computes every copy once per source). Adam hides a 2× gradient on
one leaf, so the gradients are compared leaf by leaf, not only the step."""

import numpy as np
import pytest

import _torch_tp_parity as P
from _torch_dist import run_ranks

ARCHS = ["qwen3-moe-30b-a3b", "deepseek-moe-16b"]
DROP_FREE = {"capacity_factor": 16.0}
A2A = {"moe_impl": "a2a", "mesh_ep_axis": "model"}
MESHES = {"1x2": ((1, 2), ("data", "model")), "2x2": ((2, 2), ("data", "model")),
          "pods": ((2, 1, 2), ("pod", "data", "model"))}
VARIANTS = {"gspmd": ({}, False), "a2a": (A2A, False), "int8": ({**A2A, "moe_wire": "int8"}, False),
            "fault": (A2A, True)}
EXPERTS = ("blocks/moe/w_in", "blocks/moe/w_gate", "blocks/moe/w_out")


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    return P.both(ARCHS, tmp_path_factory.mktemp("a2a-step"), shapes=[],
                  variants={"a2a": (ARCHS, P.SHAPES, {}, DROP_FREE, A2A)})


@pytest.fixture(scope="module")
def grads(tmp_path_factory):
    """{(arch, mesh name): every rank's {variant: (loss, {leaf: gradient})},
    rank 0's with "one": one process on the whole batch}."""
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 128, (4, 8))
    runs = [{"arch": a, "shape": shape, "axes": axes, "overrides": DROP_FREE,
             "variants": VARIANTS} for a in ARCHS for shape, axes in MESHES.values()]
    got = run_ranks("tp_grads", 4, tmp_path_factory.mktemp("a2a-grads"), timeout=150,
                    runs=runs, tokens=tokens, labels=np.roll(tokens, -1, 1))
    keys = [(a, m) for a in ARCHS for m in MESHES]
    return {k: [rank[i] for rank in got if rank[i] is not None] for i, k in enumerate(keys)}


def _gap(a: dict, b: dict, names=None) -> tuple[float, str]:
    """The worst leaf's max |a − b| / max |b| (over ``names``, else all)."""
    return max((float(np.abs(a[n] - b[n]).max() / max(np.abs(b[n]).max(), 1e-30)), n)
               for n in (names or b))


@pytest.mark.parametrize("shape", P.SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_step_matches_reference_gspmd(steps, arch, shape):
    P.check_reference(steps, arch, shape, "a2a")


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_equals_the_scatter_steps(grads, arch, mesh):
    """Every rank's first-step loss within rtol 2e-6 of the scatter
    dispatch's on that rank (on the pods mesh each pod's rows)."""
    for r in grads[(arch, mesh)]:
        np.testing.assert_allclose(r["a2a"][0], r["gspmd"][0], rtol=2e-6)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_every_gradient_equals_the_scatter_steps(grads, arch, mesh):
    """Every leaf's gradient, gathered whole, within 1e-5 of its largest
    |value| of the scatter dispatch's (a 2× expert gradient is a gap of
    1); on one-pod meshes also of one process's on the whole batch."""
    for r in grads[(arch, mesh)]:
        gap, leaf = _gap(r["a2a"][1], r["gspmd"][1])
        assert gap <= 1e-5, (leaf, gap)
        if "one" in r and mesh != "pods":
            gap, leaf = _gap(r["a2a"][1], r["one"][1])
            assert gap <= 1e-5, (leaf, gap)
            np.testing.assert_allclose(r["a2a"][0], r["one"][0], rtol=2e-6)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_missing_grad_scale_fails_on_the_expert_stacks(grads, arch, mesh):
    """The planted fault, the returned copies' gradient left unscaled:
    every expert stack's gradient is off by far more than the limit (the
    loss, a forward value, is not)."""
    for r in grads[(arch, mesh)]:
        assert r["fault"][0] == r["a2a"][0]
        for leaf in EXPERTS:
            assert _gap(r["fault"][1], r["gspmd"][1], [leaf])[0] > 0.5


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_int8_wire_gradients_stay_close(grads, arch, mesh):
    """The int8 wire (each slot's codes with an fp32 scale, its backward
    quantized the same way, the same 1/n_ep scale): the loss within rtol
    1e-3 and every expert stack's gradient within 15% relative L2 of the
    scatter dispatch's (7.2% the worst measured, deepseek-moe's w_gate on
    the pods mesh, where a gradient slot's small entries round coarsely;
    the unscaled gradient would be 100% off)."""
    for r in grads[(arch, mesh)]:
        np.testing.assert_allclose(r["int8"][0], r["gspmd"][0], rtol=1e-3)
        for leaf in EXPERTS:
            a, b = r["int8"][1][leaf], r["gspmd"][1][leaf]
            assert np.linalg.norm(a - b) <= 0.15 * np.linalg.norm(b), leaf
