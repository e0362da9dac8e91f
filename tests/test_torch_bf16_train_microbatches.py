"""Six bf16 train steps of olmo-1b with 2 microbatches, the reference's
production cell for it (``repro.launch.dryrun``'s ``MICROBATCHES``), the
port against the reference's jitted step from the reference's state on
one batch. The microbatches' gradients are accumulated in fp32
(``repro.train.trainer``'s ``local_grads``), over bf16 gradients."""

import numpy as np
import torch

from _torch_train_parity import EPS, assert_bf16_state_dtypes, assert_bf16_step_matches, \
    bf16_steps, pairs

torch.set_num_threads(1)


def test_bf16_microbatched_steps_match_reference():
    """The first step within ``assert_bf16_step_matches``'s tolerances; at
    every step the step counts and dtypes exactly, the loss within rtol
    2^-13 and the grad norm within ε/2 (measured over the six steps:
    2.9e-5 and 1.5e-3, both at step 5, as the bf16 params drift apart by
    the ulps their first steps' roundings left); after six steps Adam's m
    and v within 8ε and 16ε of each leaf's largest value (measured 7.7e-3
    and 9.7e-3)."""
    ref, port = bf16_steps("olmo-1b", steps=6, microbatches=2)
    (jnew, jm), (new, m) = ref[0], port[0]
    assert_bf16_step_matches(jnew, jm, new, m)
    for i, ((js, jm), (s, m)) in enumerate(zip(ref, port), start=1):
        assert int(s.step) == int(js.step) == i
        assert int(s.opt_state["step"]) == int(js.opt_state["step"]) == i
        assert_bf16_state_dtypes(js, s)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=2.0 ** -13)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=EPS / 2)
    js, s = ref[-1][0], port[-1][0]
    for name, tol in (("m", 8 * EPS), ("v", 16 * EPS)):
        for a, b in pairs(js.opt_state[name], s.opt_state[name]):
            assert np.abs(b - a).max() <= tol * np.abs(a).max()
