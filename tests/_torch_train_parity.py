"""Shared by the port's trainer parity tests: batches made with numpy, a
reference train state carried into the port, and the comparison of one
step of both packages from that state."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as JC
from repro.optim import adam as jadam
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import init_train_state as jinit_train_state
from repro.train import make_train_step as jmake_train_step
import repro_torch.configs as TC
from repro_torch.convert import train_state_from_jax
from repro_torch.optim import adam
from repro_torch.train import TrainerConfig, make_train_step
from repro_torch.tree import tree_leaves

LR = 3e-3


def batch_np(cfg, b: int = 2, s: int = 16, seed: int = 1) -> dict:
    """tokens (or audio frame embeds), labels and vlm patch embeds."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.family == "audio":
        out["embeds"] = (rng.normal(size=(b, s, cfg.d_model)) * 0.02).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    out["labels"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    if cfg.family == "vlm":
        out["vision_embeds"] = (rng.normal(size=(b, cfg.n_patches, cfg.d_model))
                                * 0.02).astype(np.float32)
    return out


def jax_batch(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def reference_state(arch: str, tcfg_kw: dict | None = None, **overrides):
    """(reference config, port config, reference TrainState) at the reduced
    config; the vlm's cross-attention gates opened to 0.5 (tanh(0) would
    silence the cross layers and their gradients)."""
    jcfg, cfg = JC.get_reduced(arch, **overrides), TC.get_reduced(arch, **overrides)
    jt = JTrainerConfig(pod_compression=False, **(tcfg_kw or {}))
    state = jinit_train_state(jcfg, jt, jadam(LR), jax.random.PRNGKey(0))
    if jcfg.family == "vlm":
        p = state.params
        p["cross"]["gate_attn"] = jnp.full_like(p["cross"]["gate_attn"], 0.5)
        p["cross"]["gate_mlp"] = jnp.full_like(p["cross"]["gate_mlp"], 0.5)
    return jcfg, cfg, state


def both_steps(arch: str, tcfg_kw: dict | None = None, batch: dict | None = None,
               **overrides):
    """One step of the reference's jitted step and of the port's from the
    same state and batch: (reference new state as numpy, its metrics, port
    new state, its metrics)."""
    jcfg, cfg, jstate = reference_state(arch, tcfg_kw, **overrides)
    b = batch if batch is not None else batch_np(cfg)
    jt = JTrainerConfig(pod_compression=False, **(tcfg_kw or {}))
    jnew, jm = jax.jit(jmake_train_step(jcfg, jt, jadam(LR)))(jstate, jax_batch(b))
    state = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate), "cpu")
    tt = TrainerConfig(pod_compression=False, **(tcfg_kw or {}))
    new, m = make_train_step(cfg, tt, adam(LR))(state, torch_batch(b))
    return jax.tree_util.tree_map(np.asarray, jnew), jm, new, m


def pairs(ref_tree, port_tree):
    ref, port = jax.tree_util.tree_leaves(ref_tree), tree_leaves(port_tree)
    assert len(ref) == len(port)
    return [(np.asarray(a), b.numpy()) for a, b in zip(ref, port)]


def assert_step_matches(jnew, jm, new, m, lr: float = LR):
    """The tolerances of one step from the same state (fp32, another
    summation order than XLA's):

    - loss, ce and aux within rtol 2e-6, the grad norm within rtol 1e-5;
    - Adam's m and v (0.1·g and 0.001·g² after one step) within 1e-5 of
      each leaf's largest |m|, |v| (plus rtol 1e-4); w_q within rtol 1e-6;
    - params within 1e-6, except where |g| < 1e-6: Adam's first update is
      lr · g / (|g| + 1e-8), which is ill-conditioned near |g| ≈ 1e-8, so
      there both updates are only held to their bound, |Δ| ≤ 2·lr;
    - the step count exactly.
    """
    for key in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=2e-6, atol=1e-7)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    assert int(new.step) == int(jnew.step) == 1
    assert int(new.opt_state["step"]) == int(jnew.opt_state["step"])
    for name in ("m", "v"):
        for a, b in pairs(jnew.opt_state[name], new.opt_state[name]):
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5 * float(np.abs(a).max()) + 1e-30)
    assert (new.wq is None) == (jnew.wq is None)
    if new.wq is not None:
        flat_j = jax.tree_util.tree_leaves(jnew.wq, is_leaf=lambda x: x is None)
        flat_p = [w for w in _leaves_with_none(new.wq)]
        assert [w is None for w in flat_j] == [w is None for w in flat_p]
        for a, b in pairs(jnew.wq, new.wq):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-9)
    for (a, b), mm in zip(pairs(jnew.params, new.params),
                          jax.tree_util.tree_leaves(jnew.opt_state["m"])):
        small = np.abs(np.asarray(mm)) < 1e-7       # |g| < 1e-6
        np.testing.assert_allclose(b[~small], a[~small], rtol=0, atol=1e-6)
        assert np.all(np.abs(b[small] - a[small]) <= 2 * lr)


def _leaves_with_none(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_none(tree[k])
    else:
        yield tree


def assert_loss_fn_matches(arch: str):
    """``loss_fn`` of both packages on the same params and batch: loss, ce
    and aux within rtol 2e-6."""
    from repro.models import transformer as jtf
    from repro_torch.convert import params_from_jax
    from repro_torch.models import transformer as tf

    jcfg, cfg = JC.get_reduced(arch), TC.get_reduced(arch)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    if jcfg.family == "vlm":
        for gate in ("gate_attn", "gate_mlp"):
            jparams["cross"][gate] = jnp.full_like(jparams["cross"][gate], 0.5)
    b = batch_np(cfg)
    jloss, jm = jax.jit(lambda p, x: jtf.loss_fn(jcfg, p, x))(jparams, jax_batch(b))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    loss, m = tf.loss_fn(cfg, params, torch_batch(b))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-6)
    np.testing.assert_allclose(float(m["ce"]), float(jm["ce"]), rtol=2e-6)
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]), rtol=2e-6, atol=1e-7)
    if cfg.family == "moe":
        assert float(m["aux"]) > 0
    return float(loss)
