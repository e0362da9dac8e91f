"""``models.transformer.loss_fn`` of the port against the reference's on the
last five archs of the registry (mamba2's SSD, the vlm with patch embeds,
the two MoE archs with their aux loss, hubert on frame embeds) at the
reduced configs: the same params and batch give the same loss, ce and aux
loss within rtol 2e-6."""

import pytest
import torch

import repro.configs as JC
from _torch_train_parity import assert_loss_fn_matches

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", JC.ARCH_IDS[5:])
def test_loss_fn_matches_reference(arch):
    assert 0 < assert_loss_fn_matches(arch) < 20
