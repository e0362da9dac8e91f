"""Port vs reference: the blocked (flash) softmax, cross-attention and the
attention block with a cache.

The port's ``_attend_flash`` is held to the reference's ``_attend_naive``,
the function it stands in for. The reference's own ``_attend_flash`` pads
S_kv to a multiple of 1024 with keys at position −10⁹, which a global
window does not mask, so it is wrong whenever S_kv is not a multiple of
1024 on a global layer; the port masks padding by index. Where the
reference's blocked path is right (S_kv a multiple of 1024, or a sliding
window) the two blocked paths agree too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as attn

torch.set_num_threads(1)

GLOBAL = 1 << 30
TOL = 1e-5


def _qkv(sq, sk, seed=0, hkv=1, g=2, hd=8):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(1, sq, hkv, g, hd)).astype(np.float32)
    k = rng.normal(size=(1, sk, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(1, sk, hkv, hd)).astype(np.float32)
    return q, k, v


def _case(sk, k_len):
    """(q_pos, k_pos, k_len): a prefill over all S_kv keys, or a chunk of 48
    queries written at the end of a cache whose first ``k_len`` slots are
    filled (the rest unwritten and masked)."""
    if k_len is None:
        return np.arange(sk), np.arange(sk), None
    sq = 48
    return np.arange(k_len - sq, k_len), np.arange(sk), k_len


def _port(fn, q, k, v, q_pos, k_pos, **kw):
    out = fn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
             torch.from_numpy(q_pos), torch.from_numpy(k_pos), **kw)
    return out.numpy()


def _ref(fn, q, k, v, q_pos, k_pos, **kw):
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(q_pos), jnp.asarray(k_pos), **kw))


@pytest.mark.parametrize("k_len", [None, 1990])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [GLOBAL, 1024])
@pytest.mark.parametrize("sk", [2100, 3072])
def test_flash_equals_reference_naive(sk, window, causal, k_len):
    q_pos, k_pos, kl = _case(sk, k_len)
    q, k, v = _qkv(len(q_pos), sk, seed=sk + window % 7)
    kw = dict(causal=causal, window=window, k_len=kl)
    want = _ref(jattn._attend_naive, q, k, v, q_pos, k_pos, **kw)
    got = _port(attn._attend_flash, q, k, v, q_pos, k_pos, **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # the port's two paths agree as well
    np.testing.assert_allclose(_port(attn._attend_naive, q, k, v, q_pos, k_pos, **kw),
                               want, rtol=0, atol=TOL)
    if sk % jattn.FLASH_BLOCK == 0 or window != GLOBAL:
        ref_flash = _ref(jattn._attend_flash, q, k, v, q_pos, k_pos, **kw)
        np.testing.assert_allclose(got, ref_flash, rtol=0, atol=TOL)


def test_reference_flash_padding_defect_is_not_mirrored():
    """S_kv = 2,100 under a global window, causal prefill: the reference's
    blocked path is off by ~1.58 (its 948 padded keys enter every
    denominator); the port's is within 1e-5 of the naive softmax."""
    q_pos, k_pos, _ = _case(2100, None)
    q, k, v = _qkv(2100, 2100, seed=0)
    kw = dict(causal=True, window=GLOBAL)
    naive = _ref(jattn._attend_naive, q, k, v, q_pos, k_pos, **kw)
    ref_flash = _ref(jattn._attend_flash, q, k, v, q_pos, k_pos, **kw)
    got = _port(attn._attend_flash, q, k, v, q_pos, k_pos, **kw)
    assert np.abs(ref_flash - naive).max() > 1.0
    assert np.abs(got - naive).max() <= TOL


def _attn_params(seed, d=32, h=4, hkv=2, hd=8):
    jp = jattn.init_attn(jax.random.PRNGKey(seed), d, h, hkv, hd, jnp.float32)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def test_cross_attention_matches_reference():
    jp, p = _attn_params(1)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    vis = rng.normal(size=(2, 11, 32)).astype(np.float32)
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=8, rope_theta=10000.0)
    want, wcache = jattn.attention(jp, jnp.asarray(x), kv_source=jnp.asarray(vis), **kw)
    got, cache = attn.attention(p, torch.from_numpy(x), kv_source=torch.from_numpy(vis), **kw)
    assert wcache is None and cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # no causal mask and no RoPE: permuting the source permutes nothing
    perm = torch.from_numpy(vis[:, ::-1].copy())
    again, _ = attn.attention(p, torch.from_numpy(x), kv_source=perm, **kw)
    np.testing.assert_allclose(again.numpy(), got.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [GLOBAL, 1024])
def test_long_prefill_through_the_cache_matches_reference_naive(monkeypatch, window):
    """The attention block prefilling 2,100 tokens into a cache of 2,112
    slots takes the blocked path; the reference block, forced onto its
    naive softmax, gives the same output and cache."""
    jp, p = _attn_params(3, d=16, h=2, hkv=1, hd=8)
    x = np.random.default_rng(4).normal(size=(1, 2100, 16)).astype(np.float32)
    kw = dict(n_heads=2, n_kv_heads=1, head_dim=8, window=window)
    calls = []
    real_flash = attn._attend_flash
    monkeypatch.setattr(attn, "_attend_flash",
                        lambda *a, **k: (calls.append(1), real_flash(*a, **k))[1])
    kc = torch.zeros(1, 2112, 1, 8)
    vc = torch.zeros(1, 2112, 1, 8)
    got, _ = attn.attention(p, torch.from_numpy(x), cache=(kc, vc), pos=0, **kw)
    assert calls == [1]
    monkeypatch.setattr(jattn, "FLASH_THRESHOLD", 10 ** 9)
    jk = jnp.zeros((1, 2112, 1, 8))
    want, (wk, wv) = jattn.attention(jp, jnp.asarray(x), cache=(jk, jk), pos=0, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(kc.numpy(), np.asarray(wk), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(vc.numpy(), np.asarray(wv), rtol=1e-6, atol=1e-6)
