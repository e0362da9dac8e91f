"""``launch/steps.py``: the prefill and decode step factories against the
reference's on the same weights (olmo-1b and hubert-xlarge reduced), a
chunked prefill against a whole one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.launch.steps import make_decode_step as jdecode, make_prefill_step as jprefill
from repro.models import transformer as jtf
import repro_torch.configs as TC
from repro_torch.convert import params_from_jax
from repro_torch.launch.steps import make_decode_step, make_prefill_step

torch.set_num_threads(1)
B, S, MAX = 2, 12, 16


@pytest.mark.parametrize("chunks", [1, 3])
def test_prefill_and_decode_match_reference(chunks):
    """Next-token logits of a (chunked) prefill and of two decode steps
    after it, within 1e-4 (fp32 summation order)."""
    jcfg, cfg = JC.get_reduced("olmo-1b"), TC.get_reduced("olmo-1b")
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jl, jcache = jprefill(jcfg, MAX, chunks)(jparams, {"tokens": jnp.asarray(toks)})
    l, cache = make_prefill_step(cfg, MAX, chunks)(params, {"tokens": torch.from_numpy(toks).long()})
    assert tuple(l.shape) == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    whole, _ = make_prefill_step(cfg, MAX)(params, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(l.numpy(), whole.numpy(), rtol=1e-5, atol=1e-5)
    jtok, tok = jnp.argmax(jl, -1).astype(jnp.int32), torch.argmax(l, -1)
    for i in range(2):
        jl, jcache = jdecode(jcfg)(jparams, {"tokens": jtok, "cache": jcache, "pos": S + i})
        l, cache = make_decode_step(cfg)(params, {"tokens": tok, "cache": cache, "pos": S + i})
        np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
        jtok, tok = jnp.argmax(jl, -1).astype(jnp.int32), torch.argmax(l, -1)


def test_encoder_prefill_matches_reference():
    """An encoder-only model's prefill is one forward with no cache."""
    jcfg, cfg = JC.get_reduced("hubert-xlarge"), TC.get_reduced("hubert-xlarge")
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    emb = (np.random.default_rng(1).normal(size=(B, S, cfg.d_model)) * 0.02).astype(np.float32)
    jl, jc = jprefill(jcfg, MAX)(jparams, {"embeds": jnp.asarray(emb)})
    l, c = make_prefill_step(cfg, MAX)(params, {"embeds": torch.from_numpy(emb)})
    assert jc is None and c is None
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
