"""One tensor-parallel train step of qwen3-moe-30b-a3b (128-expert stacks
cut to 8, sharded by expert over "model") and deepseek-moe-16b (plus its
shared experts, column- and row-parallel) on (data, model) meshes (1, 2)
and (2, 2): the port's step on ``gloo`` CPU ranks against the reference's
GSPMD step on the same mesh shape and against the port's one-device step,
from the same state and batch (``_torch_tp_parity.py``)."""

import pytest

import _torch_tp_parity as P

ARCHS = ['qwen3-moe-30b-a3b', 'deepseek-moe-16b']


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return P.both(ARCHS, tmp_path_factory.mktemp("tp-step"))


@pytest.mark.parametrize("shape", P.SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_step_matches_reference_gspmd(results, arch, shape):
    P.check_reference(results, arch, shape)


@pytest.mark.parametrize("shape", P.SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_step_matches_one_device(results, arch, shape):
    P.check_one_device(results, arch, shape)
