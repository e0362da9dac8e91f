"""The port's trainer (``repro_torch.train.trainer``): a step without QAT
and a microbatched step against the reference's jitted step, remat ``"full"`` and ``"dots"``
against ``"none"``, the counterparts of
``test_models_smoke::test_train_step_decreases_loss`` and
``test_system::test_qat_lm_training_learns``, and the multi-device cases
that raise, and that a step leaves no reference cycles."""

import dataclasses
import gc

import jax
import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import MeshSpec
import repro_torch.configs as TC
from _torch_train_parity import (
    assert_step_matches, batch_np, both_steps, torch_batch,
)
from repro_torch.data.synthetic import synthetic_tokens, token_batches
from repro_torch.models.transformer import ModelConfig, init_params, loss_fn
from repro_torch.optim import adam
from repro_torch.train import TrainerConfig, init_train_state, make_train_step
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)


def test_step_without_qat_matches_reference():
    jnew, jm, new, m = both_steps("olmo-1b", {"qat": False})
    assert new.wq is None and jnew.wq is None
    assert_step_matches(jnew, jm, new, m)


def test_microbatched_step_matches_reference():
    """microbatches=2 on a MoE arch: the chunks' gradients averaged in fp32,
    capacity per chunk, as the reference's scan."""
    cfg = TC.get_reduced("deepseek-moe-16b")
    assert_step_matches(*both_steps("deepseek-moe-16b", {"microbatches": 2},
                                    batch=batch_np(cfg, b=4)))


def _grads(cfg, params, batch):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    tree = tree_map(lambda _: next(it), params)
    loss, metrics = loss_fn(cfg, tree, batch)
    return loss, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", ["olmo-1b", "zamba2-1.2b", "llama-3.2-vision-11b",
                                  "qwen3-moe-30b-a3b", "mamba2-370m"])
def test_remat_gives_the_numbers_of_none(arch):
    """Recomputing each layer in the backward (remat "full") or keeping only
    its matmul outputs ("dots") changes no bit of the loss or gradients."""
    base = TC.get_reduced(arch)
    params = init_params(base, seed=0, device="cpu")
    if base.family == "vlm":
        params["cross"]["gate_attn"].fill_(0.5)
        params["cross"]["gate_mlp"].fill_(0.5)
    batch = torch_batch(batch_np(base))
    loss, grads = _grads(base, params, batch)
    for mode in ("full", "dots"):
        cfg = TC.get_reduced(arch, remat=mode)
        loss_r, grads_r = _grads(cfg, params, batch)
        assert torch.equal(loss_r, loss), mode
        for g, g_r in zip(grads, grads_r):
            assert torch.equal(g, g_r), mode


def test_remat_frees_the_layers_activations():
    """Under remat "full" the autograd graph keeps each layer's input only:
    the saved tensors shrink by more than half."""
    cfg = TC.get_reduced("olmo-1b")
    params = init_params(cfg, seed=0, device="cpu")
    batch = torch_batch(batch_np(cfg, b=2, s=64))

    def saved_bytes(c):
        total = []

        def pack(t):
            total.append(t.numel() * t.element_size())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            _grads(c, params, batch)
        return sum(total)

    none = saved_bytes(cfg)
    full = saved_bytes(TC.get_reduced("olmo-1b", remat="full"))
    assert full < none / 2, (full, none)


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_train_step_decreases_loss(arch):
    """``test_models_smoke::test_train_step_decreases_loss`` on the port:
    five QAT steps on one batch (adam 3e-3, grad clip 1) lower the loss."""
    cfg = TC.get_reduced(arch)
    tcfg = TrainerConfig(qat=True, pod_compression=False, grad_clip=1.0)
    opt = adam(3e-3)
    state = init_train_state(cfg, tcfg, opt, seed=0, device="cpu")
    step = make_train_step(cfg, tcfg, opt)
    batch = torch_batch(batch_np(cfg))
    state, m0 = step(state, batch)
    for _ in range(4):
        state, m = step(state, batch)
    assert np.isfinite(float(m["loss"]))
    assert float(m["loss"]) < float(m0["loss"])
    assert int(state.step) == 5


def test_qat_lm_training_learns():
    """``test_system::test_qat_lm_training_learns`` on the port: FTTQ QAT
    pretraining of a small LM on the synthetic stream lowers the loss."""
    cfg = ModelConfig(name="lm", family="dense", n_layers=2, d_model=64, vocab_size=64,
                      n_heads=4, n_kv_heads=2, d_ff=128)
    tcfg = TrainerConfig(qat=True, pod_compression=False)
    opt = adam(3e-3)
    state = init_train_state(cfg, tcfg, opt, seed=0, device="cpu")
    step = make_train_step(cfg, tcfg, opt)
    toks = synthetic_tokens(int(jax.random.randint(jax.random.PRNGKey(1), (), 0, 2**31 - 1)),
                            30_000, vocab=64)
    it = token_batches(toks, batch=8, seq=32, device="cpu")
    losses = []
    for _ in range(30):
        batch, _ = next(it)
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3


def test_step_leaves_its_input_state_unchanged():
    cfg = TC.get_reduced("olmo-1b")
    tcfg = TrainerConfig(pod_compression=False)
    opt = adam(3e-3)
    state = init_train_state(cfg, tcfg, opt, seed=0, device="cpu")
    before = [t.clone() for t in tree_leaves(state.params) + tree_leaves(state.wq)]
    new, _ = make_train_step(cfg, tcfg, opt)(state, torch_batch(batch_np(cfg)))
    after = tree_leaves(state.params) + tree_leaves(state.wq)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert int(state.step) == 0 and int(new.step) == 1


def test_a_step_leaves_no_reference_cycles():
    """Nothing a step made waits for the garbage collector: the tree walkers
    are no recursive closures (a closure that calls itself is a cycle that
    keeps every tensor its mapped function holds, such as the gradients and
    the old state, alive until a collection)."""
    cfg = TC.get_reduced("olmo-1b")
    tcfg, opt = TrainerConfig(), adam(3e-3)
    state = init_train_state(cfg, tcfg, opt, seed=0, device="cpu")
    batch = torch_batch(batch_np(cfg, b=2))
    step = make_train_step(cfg, tcfg, opt)
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        state, _ = step(state, batch)
        state, _ = step(state, batch)
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        tensors = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        if enabled:
            gc.enable()
    assert tensors == []


def test_multi_device_cases_raise():
    """Tensor-parallel compute (a "model" axis of size > 1) raises for the
    all-to-all MoE (``moe_impl="a2a"``, ROADMAP item 14b-iv), and needs a
    mesh of processes for every family (its trainer is
    ``tests/test_torch_tensor_parallel_step_*.py``);
    a multi-pod compressed state carries the reference's (n_pods, *shape)
    zero residuals in one process (the multi-rank trainer is
    ``tests/test_torch_multipod.py``), and none without compression."""
    cfg = TC.get_reduced("olmo-1b")
    opt = adam(1e-3)
    tp_mesh = MeshSpec((1, 1, 2), ("pod", "data", "model"))
    with pytest.raises(NotImplementedError, match="item 14b-iv"):
        make_train_step(TC.get_reduced("qwen3-moe-30b-a3b", moe_impl="a2a"), TrainerConfig(), opt,
                        mesh=tp_mesh)
    for arch in ("olmo-1b", "qwen3-moe-30b-a3b", "mamba2-370m", "zamba2-1.2b"):
        with pytest.raises(TypeError, match="mesh of processes"):
            make_train_step(TC.get_reduced(arch), TrainerConfig(), opt, mesh=tp_mesh)
    state = init_train_state(cfg, TrainerConfig(pod_compression=True), opt, device="cpu",
                             n_pods=2)
    assert state.residuals["embed"]["table"].shape == (2,) + tuple(
        state.params["embed"]["table"].shape)
    assert not state.residuals["embed"]["table"].any()
    state = init_train_state(cfg, TrainerConfig(pod_compression=False), opt, device="cpu",
                             n_pods=2)
    assert state.residuals is None
    with pytest.raises(ValueError, match="pods"):
        init_train_state(cfg, TrainerConfig(), opt, device="cpu", n_pods=2,
                         mesh=MeshSpec((1,), ("pod",)))


def test_trainer_config_matches_reference():
    """The same fields and defaults; TrainState's fields in the same order."""
    from repro.train import TrainerConfig as JTrainerConfig

    want = [(f.name, f.default) for f in dataclasses.fields(JTrainerConfig)
            if f.name != "fttq"]
    got = [(f.name, f.default) for f in dataclasses.fields(TrainerConfig) if f.name != "fttq"]
    assert got == want
    from repro.train.trainer import TrainState as JTrainState
    from repro_torch.train.trainer import TrainState

    assert ([f.name for f in dataclasses.fields(TrainState)]
            == [f.name for f in dataclasses.fields(JTrainState)])
