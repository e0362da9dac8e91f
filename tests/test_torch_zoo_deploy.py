"""Port vs reference over the model zoo at the reduced configs, through the
wire: the dequantized ternary deploy of every arch (fp16 residuals) against
the reference's deploy — the same wire bytes and download estimate, logits
within 1e-4. The packed deploys are in test_torch_zoo_packed.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.core import FTTQConfig as JFTTQConfig
from repro.launch.serve import ternary_deploy as jternary_deploy
from repro.models import transformer as jtf
import repro_torch.configs as TC
from repro_torch.convert import params_from_jax
from repro_torch.core.fttq import FTTQConfig
from repro_torch.launch import serve
from repro_torch.models import transformer as tf

torch.set_num_threads(1)

B, S = 2, 8


def _setup(arch):
    jcfg, cfg = JC.get_reduced(arch), TC.get_reduced(arch)
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
    return jcfg, jp, cfg, p, inputs


def _logits(fn, cfg, params, inputs, to):
    kw = {k: to(v) for k, v in inputs.items()}
    return fn(cfg, params, kw.pop("tokens", None), **kw)[0]


def _jnp(a):
    return jnp.asarray(a)


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_dequantized_deploy_matches_reference(arch):
    jcfg, jp, cfg, p, inputs = _setup(arch)
    jserved, jbytes, jdl, _ = jternary_deploy(jp, JFTTQConfig(), residual="fp16")
    served, nbytes, dl, _ = serve.ternary_deploy(p, FTTQConfig(), residual="fp16",
                                                 device="cpu")
    assert nbytes == jbytes
    assert dl == pytest.approx(jdl, rel=1e-12)
    want = _logits(jtf.forward, jcfg, jserved, inputs, _jnp)
    got = _logits(tf.forward, cfg, served, inputs, torch.from_numpy)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
