"""One train step of the port against the reference's jitted step, from the
same state (the reference's, carried over with ``train_state_from_jax``)
and batch, for two dense archs (olmo's non-parametric LayerNorm, yi's GQA) at the reduced configs: loss, grad norm, params, w_q
and Adam state within the tolerances of ``_torch_train_parity
.assert_step_matches``."""

import pytest
import torch

from _torch_train_parity import assert_step_matches, both_steps

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", ["olmo-1b", "yi-9b"])
def test_one_step_matches_reference(arch):
    assert_step_matches(*both_steps(arch))
