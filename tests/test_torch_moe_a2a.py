"""The port's expert-parallel MoE (``models/moe_a2a.py``): the int8 wire's
``_q8`` and ``quantized_all_to_all`` bit for bit against the reference on
the inputs of its ``test_quantized_all_to_all_roundtrip_error`` (the
reference in a subprocess whose JAX sees four forced host devices, the
port on four ``gloo`` CPU ranks); the a2a forward at drop-free capacity
against the port's scatter dispatch ``models/moe.py`` on a (2, 2) data ×
model mesh of four ranks (the reference's own test of this fails, so the
port is held to its one-device result, which the zoo's tests tie to the
reference); the int8 wire within the reference test's 5% relative L2; and
a train step through the int8 wire that lowers the loss."""

import jax
import numpy as np
import torch

from _torch_dist import run_jax, run_ranks
from repro.models.moe_a2a import _fill_queue as jfill_queue, _q8 as jq8
from repro_torch.configs import get_reduced
from repro_torch.models import moe as tmoe
from repro_torch.models.moe_a2a import _fill_queue, _q8, moe_a2a
from repro_torch.models.transformer import forward, init_params

torch.set_num_threads(1)

_REFERENCE = """
import pickle
import jax, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.models.moe_a2a import quantized_all_to_all
mesh = jax.make_mesh((4,), ("model",))
x = jax.random.normal(jax.random.PRNGKey(0), (16, 8, 32))
out = jax.jit(shard_map(lambda x: quantized_all_to_all(x, "model"), mesh=mesh,
                        in_specs=P("model"), out_specs=P("model"), axis_names={"model"},
                        check_vma=False))(x)
pickle.dump({"x": np.asarray(x), "out": np.asarray(out)}, open(OUT, "wb"))
"""


def test_q8_bit_identical_to_reference():
    """Codes and scales of ``_q8`` on the reference test's input, and on
    values at the rounding midpoints (half to even, as ``jnp.round``),
    against the reference compiled as it runs (under ``jit``, which turns
    its division by 127 into a product with the reciprocal)."""
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (16, 8, 32)))
    ties = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 3.5, -126.5]], np.float32)
    for a in (x, ties, np.zeros((2, 4), np.float32)):
        q_ref, s_ref = jax.jit(jq8)(jax.numpy.asarray(a))
        q, s = _q8(torch.from_numpy(a))
        np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
        np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))


def test_quantized_all_to_all_bit_identical_to_reference(tmp_path):
    """Four ranks of a (4,) "model" mesh each send their (4, 8, 32) block:
    the blocks they receive equal the reference's shard_map output bit for
    bit, and every row is within the reference test's bound (half a step)
    of the input row it came from."""
    ref = run_jax(_REFERENCE, 4, tmp_path)
    ranks = run_ranks("q8_a2a", 4, tmp_path, x=ref["x"])
    out = np.concatenate([r["out"] for r in ranks])
    np.testing.assert_array_equal(out, ref["out"])
    xs, os_ = ref["x"].reshape(-1, 32), out.reshape(-1, 32)
    scale = np.abs(xs).max(-1) / 127.0
    for row, o in enumerate(os_):
        assert (np.abs(xs - o).max(-1) <= scale * 0.51 + 1e-6).any(), row


def test_a2a_forward_equals_the_scatter_dispatch_and_int8_stays_close(tmp_path):
    """qwen3-moe (reduced) on a (2, 2) data × model mesh, EP over "model",
    capacity factor 16 (drop-free): every rank's logits within 1e-5 of
    their largest |value| of ``moe.py``'s on the same rows (the combine
    adds the k copies in another order). deepseek-moe (reduced): the int8
    wire within 5% relative L2 of the plain wire, on fewer bytes."""
    tokens = np.random.default_rng(1).integers(0, 128, (4, 16)).astype(np.int32)
    ranks = run_ranks("moe_forward", 4, tmp_path, timeout=120, tokens=tokens)
    for r in ranks:
        assert r["gap"] <= 1e-5, r["gap"]
        assert r["rel_l2"] < 0.05, r["rel_l2"]
        plain, int8 = r["wire"]
        assert int8 < plain


def test_int8_wire_train_step_lowers_the_loss(tmp_path):
    """deepseek-moe (reduced) with the int8 a2a wire, EP over a 2-rank
    "data" axis (each rank its own rows and half the experts), QAT and
    adam(2e-3): the gradients flow back through the quantized all-to-all
    and five steps lower the loss, the same on both ranks."""
    rng = np.random.default_rng(2)
    kw = dict(tokens=rng.integers(0, 128, (4, 16)).astype(np.int32),
              labels=rng.integers(0, 128, (4, 16)).astype(np.int32), steps=5)
    ranks = run_ranks("moe_train", 2, tmp_path, timeout=120, **kw)
    losses = ranks[0]["losses"]
    assert losses[-1] < losses[0]
    assert ranks[1]["losses"] == losses


def test_one_rank_a2a_equals_the_scatter_dispatch():
    """With no mesh the a2a layer runs on one rank (the collectives are
    the identity) and at drop-free capacity equals ``moe.py``; a queue's
    slots follow the reference's ``_fill_queue`` (rank within its queue,
    overflow dropped)."""
    cfg = get_reduced("deepseek-moe-16b")
    params = init_params(cfg, seed=0, device="cpu")
    lp = {k: v[0] if not isinstance(v, dict) else {n: a[0] for n, a in v.items()}
          for k, v in params["blocks"]["moe"].items()}
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator().manual_seed(0))
    ref, aux_ref = tmoe.moe(lp, x, top_k=cfg.top_k, capacity_factor=16.0,
                            activation=cfg.activation)
    got, aux = moe_a2a(lp, x, top_k=cfg.top_k, n_experts=cfg.n_experts, capacity_factor=16.0,
                       activation=cfg.activation)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    torch.testing.assert_close(aux, aux_ref)
    vals = torch.arange(5.0)[:, None]
    buf, ebuf, pos, keep = _fill_queue(vals, torch.tensor([1, 0, 1, 1, 0]),
                                       torch.ones(5, dtype=torch.bool), 2, 2,
                                       extra=torch.tensor([7, 8, 9, 10, 11]))
    assert pos.tolist() == [0, 0, 1, 0, 1] and keep.tolist() == [True, True, True, False, True]
    assert buf[:, :, 0].tolist() == [[1.0, 4.0], [0.0, 2.0]]
    assert ebuf.tolist() == [[8, 11], [7, 9]]
    cfg_a = get_reduced("deepseek-moe-16b", moe_impl="a2a", mesh_ep_axis="model",
                        capacity_factor=16.0)
    cfg_g = get_reduced("deepseek-moe-16b", capacity_factor=16.0)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(3))
    la, _, _ = forward(cfg_a, params, toks)
    lg, _, _ = forward(cfg_g, params, toks)
    assert float((la - lg).abs().max()) <= 1e-5 * float(lg.abs().max())


def test_fill_queue_matches_reference_where_every_value_is_kept():
    """The send side (every copy kept): slots, keep flags, the buffer and
    the expert-index buffer equal the reference's ``_fill_queue``."""
    rng = np.random.default_rng(4)
    vals = rng.normal(size=(40, 3)).astype(np.float32)
    dest = rng.integers(0, 4, 40).astype(np.int32)
    extra = rng.integers(1, 5, 40).astype(np.int32)
    keep_all = np.ones(40, bool)
    jb, je, jp, jk = jfill_queue(jax.numpy.asarray(vals), jax.numpy.asarray(dest),
                                 jax.numpy.asarray(keep_all), 4, 8,
                                 extra=jax.numpy.asarray(extra))
    b, e, p, k = _fill_queue(torch.from_numpy(vals), torch.from_numpy(dest).long(),
                             torch.from_numpy(keep_all), 4, 8, extra=torch.from_numpy(extra))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))


def test_reference_fill_queue_defect_is_not_mirrored():
    """The reference ranks masked-out values in their queue too: on the
    receive side every empty slot goes to queue 0, so a copy for local
    expert 0 behind a source's empty slots lands past the capacity and is
    dropped, even at drop-free capacity. The port ranks kept values only."""
    vals = np.arange(6, dtype=np.float32)[:, None]
    dest = np.array([1, 0, 0, 0, 0, 1], np.int32)          # slots 1-3 are empty
    keep = np.array([True, False, False, False, True, True])
    _, _, jp, jk = jfill_queue(jax.numpy.asarray(vals), jax.numpy.asarray(dest),
                               jax.numpy.asarray(keep), 2, 2)
    _, _, p, k = _fill_queue(torch.from_numpy(vals), torch.from_numpy(dest).long(),
                             torch.from_numpy(keep), 2, 2)
    assert np.asarray(jk).tolist() == [True, False, False, False, False, True]
    assert k.tolist() == [True, False, False, False, True, True]
    assert p.tolist()[4] == 0 and int(np.asarray(jp)[4]) == 0
