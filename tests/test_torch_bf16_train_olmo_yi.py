"""One bf16 train step of the port against the reference's jitted step for
two dense archs (olmo's non-parametric LayerNorm, yi's GQA), at the reduced configs, in the reference's production train cell (bf16
params and compute, full remat, QAT, adam(1e-4); ``repro.launch.dryrun``),
from the reference's state (``train_state_from_jax``): the tolerances of
``_torch_train_parity.assert_bf16_step_matches``, and the QAT codes of
the same θ bit for bit."""

import pytest
import torch

from _torch_train_parity import assert_bf16_codes_match, assert_bf16_step_matches, bf16_steps

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", ["olmo-1b", "yi-9b"])
def test_bf16_step_matches_reference(arch):
    ((jnew, jm),), ((new, m),) = bf16_steps(arch)
    assert_bf16_step_matches(jnew, jm, new, m)
    assert_bf16_codes_match(arch)
