"""One train step of the port against the reference's jitted step, from the
same state (the reference's, carried over with ``train_state_from_jax``)
and batch, for the hybrid family (zamba2's shared attention block) and the vlm's cross-attention at the reduced configs: loss, grad norm, params, w_q
and Adam state within the tolerances of ``_torch_train_parity
.assert_step_matches``."""

import pytest
import torch

from _torch_train_parity import assert_step_matches, both_steps

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "llama-3.2-vision-11b"])
def test_one_step_matches_reference(arch):
    assert_step_matches(*both_steps(arch))
