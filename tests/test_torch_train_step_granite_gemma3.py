"""One train step of the port against the reference's jitted step, from the
same state (the reference's, carried over with ``train_state_from_jax``)
and batch, for two dense archs (granite's GQA, gemma3's 5:1 sliding windows) at the reduced configs: loss, grad norm, params, w_q
and Adam state within the tolerances of ``_torch_train_parity
.assert_step_matches``."""

import pytest
import torch

from _torch_train_parity import assert_step_matches, both_steps

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", ["granite-20b", "gemma3-4b"])
def test_one_step_matches_reference(arch):
    assert_step_matches(*both_steps(arch))
