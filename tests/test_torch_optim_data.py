"""The port's global-norm clipping, learning-rate schedules and synthetic
token stream against ``repro.optim`` and ``repro.data.synthetic``: the
reference's own assertions (``test_optim_data.py``) on the port, the
clipped tree and the schedules within rtol 1e-6 of the reference's, and
the token stream and its batches bit for bit given the same seed int."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import synthetic_tokens as jsynthetic_tokens
from repro.data.synthetic import token_batches as jtoken_batches
from repro.optim import clip_by_global_norm as jclip
from repro.optim import cosine_schedule as jcosine
from repro.optim import global_norm as jglobal_norm
from repro.optim import warmup_cosine_schedule as jwarmup
from repro_torch.data.synthetic import synthetic_tokens, token_batches
from repro_torch.launch.train import DATA_SEED
from repro_torch.optim import (
    adam, clip_by_global_norm, cosine_schedule, global_norm, warmup_cosine_schedule,
)
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 10.0)}
    clipped, gn = clip_by_global_norm(g, 1.0)
    assert float(gn) == pytest.approx(20.0)
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-4)


@pytest.mark.parametrize("max_norm", [0.5, 1.0, 1e6])
def test_clip_matches_reference(max_norm):
    """A tree of several leaves in the reference's leaf order: the norm and
    every clipped leaf within rtol 1e-6 (a norm under ``max_norm`` leaves
    the tree as it is)."""
    rng = np.random.default_rng(0)
    tree = {"b": {"w": rng.normal(size=(7, 5)).astype(np.float32),
                  "u": rng.normal(size=(3,)).astype(np.float32)},
            "a": [rng.normal(size=(2, 2, 2)).astype(np.float32) * 0.1]}
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tt = {"b": {k: torch.from_numpy(v) for k, v in tree["b"].items()},
          "a": [torch.from_numpy(tree["a"][0])]}
    jc, jn = jclip(jt, max_norm)
    tc, tn = clip_by_global_norm(tt, max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(float(global_norm(tt)), float(jglobal_norm(jt)), rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(jc), tree_leaves(tc)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
    if max_norm > 100:
        for a, b in zip(tree_leaves(tt), tree_leaves(tc)):
            assert torch.equal(a, b)


def test_schedules():
    lr = warmup_cosine_schedule(1.0, warmup=10, total_steps=110)
    assert float(lr(torch.tensor(0))) < 0.2
    assert float(lr(torch.tensor(9))) == pytest.approx(1.0, rel=1e-6)
    assert float(lr(torch.tensor(109))) < 0.2
    c = cosine_schedule(2.0, 100, final_frac=0.5)
    assert float(c(torch.tensor(0))) == pytest.approx(2.0)
    assert float(c(torch.tensor(100))) == pytest.approx(1.0)


@pytest.mark.parametrize("make", [
    lambda m: m[0](3e-4, 20, 60), lambda m: m[0](1.0, 10, 110), lambda m: m[0](0.1, 0, 5),
    lambda m: m[1](2.0, 100, 0.5), lambda m: m[1](1e-3, 7),
], ids=["cli", "warmup", "no-warmup", "cosine", "cosine-short"])
def test_schedules_match_reference(make):
    """Every step from 0 past the end, on the int32 step tensor that
    ``adam`` hands its schedule: within rtol 1e-6."""
    port = make((warmup_cosine_schedule, cosine_schedule))
    ref = make((jwarmup, jcosine))
    for s in range(0, 130):
        want = float(ref(jnp.asarray(s, jnp.int32)))
        got = port(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, err_msg=str(s))


def test_adam_with_a_schedule_matches_reference():
    """adam(schedule) reads lr(step) before it counts the step: three
    updates of both packages within rtol 1e-6."""
    from repro.optim import adam as jadam

    rng = np.random.default_rng(3)
    grads = [rng.normal(size=(4, 3)).astype(np.float32) for _ in range(3)]
    jopt, opt = jadam(jwarmup(1.0, 2, 10)), adam(warmup_cosine_schedule(1.0, 2, 10))
    params = np.zeros((4, 3), np.float32)
    jstate, state = jopt.init({"w": jnp.asarray(params)}), opt.init({"w": torch.zeros(4, 3)})
    for g in grads:
        jupd, jstate = jopt.update({"w": jnp.asarray(g)}, jstate)
        upd, state = opt.update({"w": torch.from_numpy(g)}, state)
        np.testing.assert_allclose(upd["w"].numpy(), np.asarray(jupd["w"]), rtol=1e-6)
    assert int(state["step"]) == int(jstate["step"]) == 3


@pytest.mark.parametrize("key,n,vocab", [(2, 5000, 50), (1, 20_000, 8192), (7, 3000, 64)])
def test_token_stream_bit_for_bit(key, n, vocab):
    seed = int(jax.random.randint(jax.random.PRNGKey(key), (), 0, 2**31 - 1))
    want = jsynthetic_tokens(jax.random.PRNGKey(key), n, vocab=vocab)
    got = synthetic_tokens(seed, n, vocab)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_the_cli_seed_is_the_reference_clis():
    assert DATA_SEED == int(jax.random.randint(jax.random.PRNGKey(1), (), 0, 2**31 - 1))


def test_token_stream_and_batches():
    toks = synthetic_tokens(int(jax.random.randint(jax.random.PRNGKey(2), (), 0, 2**31 - 1)),
                            5000, vocab=50)
    assert toks.min() >= 0 and toks.max() < 50
    it = token_batches(toks, batch=4, seq=16, device="cpu")
    b1, cur1 = next(it)
    assert b1["tokens"].shape == (4, 16) and b1["tokens"].dtype == torch.int32
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    b2, _ = next(it)
    it2 = token_batches(toks, batch=4, seq=16, start=cur1, device="cpu")
    b2r, _ = next(it2)
    assert torch.equal(b2["tokens"], b2r["tokens"])


def test_token_batches_match_reference():
    """Batches, labels and cursors of both packages, through the wrap to
    the first batch and from a resumed cursor."""
    toks = np.arange(1000, dtype=np.int32) * 7 % 113
    for start in (0, 5):
        ref = jtoken_batches(toks, 3, 10, start=start)
        port = token_batches(toks, 3, 10, start=start, device="cpu")
        for _ in range(40):      # 1000 // 33 = 30 batches, then the wrap
            (jb, jc), (tb, tc) = next(ref), next(port)
            assert jc == tc
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
