"""The serving slice end to end, port vs reference, at olmo-1b's reduced
size: the dense forward from the same weights, the packed ternary deploy
through the wire against the JAX packed deploy (Pallas in interpret mode),
greedy decoding, and the CLI's device handling."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import olmo_1b as jax_olmo
from repro.core import FTTQConfig as JFTTQConfig
from repro.launch.serve import ternary_deploy as jternary_deploy
from repro.models import transformer as jtf
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import params_from_jax
from repro_torch.core.fttq import FTTQConfig
from repro_torch.kernels.repack import PackedTernary
from repro_torch.launch import serve
from repro_torch.models import transformer as tf
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

B, S, GEN = 2, 8, 4


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_olmo.reduced()
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    return jcfg, jparams, get_reduced("olmo-1b"), params, tokens


def _jax_generate(cfg, params, tokens):
    cache = jtf.init_cache(cfg, B, S + GEN)
    logits, cache, _ = jtf.forward(cfg, params, jnp.asarray(tokens), cache=cache, pos=0)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    out, steps = [tok], [np.asarray(logits)]
    for i in range(GEN - 1):
        logits, cache = jtf.decode_step(cfg, params, tok, cache, S + i)
        steps.append(np.asarray(logits))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1)), steps


def _torch_generate(cfg, params, tokens):
    t = torch.from_numpy(tokens.astype(np.int64))
    cache = tf.init_cache(cfg, B, S + GEN, device="cpu")
    logits, cache, _ = tf.forward(cfg, params, t, cache=cache, pos=0)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    out, steps = [tok], [logits.numpy()]
    for i in range(GEN - 1):
        logits, cache = tf.decode_step(cfg, params, tok, cache, S + i)
        steps.append(logits.numpy())
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
    return torch.cat(out, dim=1).numpy(), steps


def test_forward_logits_match_reference(setup):
    jcfg, jparams, cfg, params, tokens = setup
    ref, _, _ = jtf.forward(jcfg, jparams, jnp.asarray(tokens))
    got, _, _ = tf.forward(cfg, params, torch.from_numpy(tokens.astype(np.int64)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_cached_decode_matches_reference(setup):
    jcfg, jparams, cfg, params, tokens = setup
    jtoks, jsteps = _jax_generate(jcfg, jparams, tokens)
    toks, steps = _torch_generate(cfg, params, tokens)
    for a, b in zip(steps, jsteps):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(toks, jtoks)


def test_packed_deploy_matches_reference_packed_deploy(setup):
    """The whole slice: compress → TFW1 → decode → repack → packed forward
    and greedy decode, against the JAX packed deploy on the same weights."""
    jcfg, jparams, cfg, params, tokens = setup
    jserved, jbytes, _, _ = jternary_deploy(jparams, JFTTQConfig(), packed=True)
    served, nbytes, dl_s, link = serve.ternary_deploy(params, FTTQConfig(), packed=True,
                                                      device="cpu")
    assert nbytes == jbytes
    assert dl_s == pytest.approx(link.latency_s + nbytes / link.bandwidth_bytes_s)
    assert sum(isinstance(x, PackedTernary) for x in
               tree_leaves(served, is_leaf=lambda x: isinstance(x, PackedTernary))) == 7

    ref, _, _ = jtf.forward(jcfg, jserved, jnp.asarray(tokens))
    got, _, _ = tf.forward(cfg, served, torch.from_numpy(tokens.astype(np.int64)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)

    jtoks, _ = _jax_generate(jcfg, jserved, tokens)
    toks, _ = _torch_generate(cfg, served, tokens)
    np.testing.assert_array_equal(toks, jtoks)

    dense, _, _, _ = serve.ternary_deploy(params, FTTQConfig(), packed=False, device="cpu")
    diff, ref_max = serve.packed_logits_check(
        cfg, served, dense, torch.from_numpy(tokens.astype(np.int64)))
    assert diff / ref_max <= 1e-4


def test_generate_returns_greedy_tokens(setup):
    _, _, cfg, params, tokens = setup
    toks, t_prefill, t_decode = serve.generate(
        cfg, params, torch.from_numpy(tokens.astype(np.int64)), GEN)
    want, _ = _torch_generate(cfg, params, tokens)
    np.testing.assert_array_equal(toks.numpy(), want)
    assert t_prefill > 0 and t_decode > 0


def test_main_needs_a_card_unless_asked_for_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--ternary", "--packed"])
    serve.main(["--device", "cpu", "--ternary", "--packed", "--batch", "1",
                "--prompt-len", "4", "--gen", "3"])
    out = capsys.readouterr().out
    assert "packed-vs-dequant logits" in out and "decode: 2 steps" in out


def test_no_reduced_reaches_full_width(monkeypatch):
    """--no-reduced selects the full olmo-1b config (the reference CLI's
    --reduced flag is store_true with default True and cannot)."""
    cfg = get_config("olmo-1b")
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size) == (16, 2048, 8192, 50304)
    assert get_config("yi-9b").n_layers == 48      # every arch id is served now
    seen = {}

    def fake_init(cfg, seed, device):
        seen["cfg"] = cfg
        raise SystemExit(0)

    monkeypatch.setattr(serve, "init_params", fake_init)
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--no-reduced"])
    assert seen["cfg"] == cfg
