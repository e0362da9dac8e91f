"""Port vs reference over the whole model zoo at the reduced configs: the
forward's logits and aux loss from the same weights (the vlm with its
cross-attention gates opened to 0.5, since tanh(0) silences them). The
caches are in test_torch_zoo_decode.py, the deploys in
test_torch_zoo_deploy.py and test_torch_zoo_packed.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import transformer as jtf
import repro_torch.configs as TC
from repro_torch.convert import params_from_jax
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


def _forward(fn, cfg, params, inputs):
    inputs = dict(inputs)
    return fn(cfg, params, inputs.pop("tokens", None), **inputs)


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_forward_matches_reference(arch):
    jcfg, jp, cfg, p, jin, tin = zoo_setup(arch)
    want, _, waux = _forward(jtf.forward, jcfg, jp, jin)
    got, cache, aux = _forward(tf.forward, cfg, p, tin)
    assert cache is None and tuple(got.shape) == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert abs(float(aux) - float(waux)) <= 1e-6
    if cfg.family == "moe":
        assert float(aux) > 0
