"""The model zoo's caches at the reduced configs: cached one-token decode
against the prefill for every causal arch, a cached prefill (SSM states,
conv windows, shared-attention slots, MoE) and a step from it against the
reference's, and the a2a MoE dispatch on one rank."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import transformer as jtf
import repro_torch.configs as TC
from repro_torch.convert import params_from_jax
from repro_torch.models.frontends import synth_vision_patches
from repro_torch.models import transformer as tf

torch.set_num_threads(1)

B, S = 2, 8


def zoo_setup(arch, **overrides):
    """(jcfg, jparams, cfg, params, inputs for the reference, for the port)."""
    jcfg, cfg = JC.get_reduced(arch, **overrides), TC.get_reduced(arch, **overrides)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    if jcfg.family == "vlm":
        jp["cross"]["gate_attn"] = jnp.full_like(jp["cross"]["gate_attn"], 0.5)
        jp["cross"]["gate_mlp"] = jnp.full_like(jp["cross"]["gate_mlp"], 0.5)
    p = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(1)
    inputs = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        inputs = {"embeds": (rng.normal(size=(B, S, cfg.d_model)) * 0.02).astype(np.float32)}
    if cfg.family == "vlm":
        inputs["vision_embeds"] = (rng.normal(size=(B, cfg.n_patches, cfg.d_model))
                                   * 0.02).astype(np.float32)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    return jcfg, jp, cfg, p, jin, tin


def port_setup(arch, **overrides):
    """(cfg, params, tokens, vision kwargs) from the port's own seeded
    initializers, for the checks that need no reference."""
    cfg = TC.get_reduced(arch, **overrides)
    p = tf.init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    vis = {}
    if cfg.family == "vlm":
        p["cross"]["gate_attn"].fill_(0.5)
        p["cross"]["gate_mlp"].fill_(0.5)
        vis["vision_embeds"] = synth_vision_patches(gen, B, cfg.n_patches, cfg.d_model)
    return cfg, p, toks, vis


CAUSAL = [a for a in JC.ARCH_IDS if JC.get_reduced(a).causal]


@pytest.mark.parametrize("arch", CAUSAL)
def test_decode_matches_prefill(arch):
    """Cached one-token steps give the prefill's logits (MoE with capacity
    16.0, as the reference test: batched and step-wise dispatch drop other
    copies otherwise)."""
    over = {"capacity_factor": 16.0} if JC.get_reduced(arch).n_experts else {}
    cfg, p, toks, vis = port_setup(arch, **over)
    full, _, _ = tf.forward(cfg, p, toks, **vis)
    cache = tf.init_cache(cfg, B, S + 2, device="cpu")
    outs = []
    for t in range(S):
        lg, cache = tf.decode_step(cfg, p, toks[:, t:t + 1], cache, t, **vis)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=3e-3, atol=3e-3)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mamba2-370m", "zamba2-1.2b"])
def test_cached_prefill_matches_reference(arch):
    """A prefill into a cache (SSM states, conv windows, shared-attention
    slots) and one decode step from it, against the reference's."""
    jcfg, jp, cfg, p, jin, tin = zoo_setup(arch)
    jcache = jtf.init_cache(jcfg, B, S + 2)
    cache = tf.init_cache(cfg, B, S + 2, device="cpu")
    wl, jcache, _ = jtf.forward(jcfg, jp, jin["tokens"], cache=jcache, pos=0)
    gl, cache, _ = tf.forward(cfg, p, tin["tokens"], cache=cache, pos=0)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=1e-5, atol=1e-5)
    assert sorted(cache) == sorted(jcache)
    for key in cache:
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]),
                                   rtol=1e-5, atol=1e-5)
    nxt = np.argmax(np.asarray(wl)[:, -1:], axis=-1).astype(np.int32)
    wl, _ = jtf.decode_step(jcfg, jp, jnp.asarray(nxt), jcache, S)
    gl, _ = tf.decode_step(cfg, p, torch.from_numpy(nxt), cache, S)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=1e-5, atol=1e-5)


def test_a2a_moe_needs_the_multi_device_slice():
    """With an expert axis but no mesh the a2a layers run on this one rank
    (``tests/test_torch_moe_a2a.py`` runs them over a mesh): at drop-free
    capacity, the scatter dispatch's logits."""
    cfg, p, toks, _ = port_setup("qwen3-moe-30b-a3b", moe_impl="a2a", mesh_ep_axis="model",
                                 capacity_factor=16.0)
    la, _, _ = tf.forward(cfg, p, toks)
    lg, _, _ = tf.forward(dataclasses.replace(cfg, moe_impl="gspmd"), p, toks)
    assert float((la - lg).abs().max()) <= 1e-5 * float(lg.abs().max())
    # without an expert axis the dense dispatch serves, as in the reference
    cfg, p, toks, _ = port_setup("qwen3-moe-30b-a3b", moe_impl="a2a")
    tf.forward(cfg, p, toks)
