"""``models.transformer.loss_fn`` of the port against the reference's on the
first five archs of the registry (the four dense archs and zamba2's hybrid)
at the reduced configs: the same params and token batch give the same loss,
ce and aux loss within rtol 2e-6. The other five are in
test_torch_train_loss_zoo.py."""

import pytest
import torch

import repro.configs as JC
from _torch_train_parity import assert_loss_fn_matches

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", JC.ARCH_IDS[:5])
def test_loss_fn_matches_reference(arch):
    assert 0 < assert_loss_fn_matches(arch) < 20
