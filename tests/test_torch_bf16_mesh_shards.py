"""bf16 shards outside the train step, in the reference's production cell
(bf16 params and compute, remat "full", QAT; ``repro.launch.dryrun``):

- the narrow sums over more than two ranks: a bf16 ``all_reduce_`` and
  ``reduce_scatter`` on four ``gloo`` CPU ranks against the reference's
  ``psum`` and ``psum_scatter`` on four forced host devices, bit for bit
  (XLA promotes a bf16 all-reduce to fp32 and rounds once; the port summed
  in bf16 before, rounding at every add);
- olmo-1b's bf16 state saved from its TP (1, 2) and FSDP (2, 1) shards, raw
  and ternary (the bf16 entry of ``quantize_pack`` on gathered shards):
  the one-process files byte for byte, restored to shards, and the ternary
  file restored by the reference to its own ternary save's leaves;
- ``elastic_reshard`` of a bf16 (2, 2) state onto (1, 2) and (2, 1);
- bf16 serving through ``launch/steps.py`` on (1, 2) and (2, 1)."""

import os
import pickle

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

from _torch_dist import run_jax, run_ranks
from _torch_train_parity import BF16, BF16_LR, batch_np, reference_state
from repro_torch.convert import params_from_jax
from repro_torch.train import restore_checkpoint
from repro_torch.tree import tree_leaves

# column 0: 1 then three 2^-8 (each bf16 add of 2^-8 to 1 is a tie that
# rounds back to 1; the exact sum rounds to 1 + 2^-6); column 1 the same
# terms in the other order; the rest random
_RNG = np.random.default_rng(5)
X = np.concatenate([np.array([[1.0, 2.0 ** -8], [2.0 ** -8, 2.0 ** -8], [2.0 ** -8, 2.0 ** -8],
                              [2.0 ** -8, 1.0]], np.float32),
                    _RNG.normal(size=(4, 62)).astype(np.float32)], axis=1)

_PSUM = """
import pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map

mesh = jax.make_mesh((4,), ("model",))
x = jnp.asarray(X, jnp.bfloat16)
run = lambda f, out: np.asarray(jax.jit(shard_map(f, mesh=mesh, in_specs=P("model"),
                                                 out_specs=out))(x))
pickle.dump({"all_reduce": run(lambda a: jax.lax.psum(a, "model"), P()),
             "reduce_scatter": run(lambda a: jax.lax.psum_scatter(a[0], "model", tiled=True),
                                   P("model"))}, open(OUT, "wb"))
"""


@pytest.fixture(scope="module")
def sums(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("narrow")
    ref = run_jax(f"import numpy as np\nX = np.array({X.tolist()!r}, np.float32)\n" + _PSUM, 4, tmp)
    return ref, run_ranks("narrow_sums", 4, tmp, timeout=60, x=X)


def _bits(a) -> np.ndarray:
    return np.asarray(a).astype(ml_dtypes.bfloat16).view(np.uint16)


@pytest.mark.parametrize("op", ["all_reduce", "reduce_scatter"])
def test_bf16_sums_over_four_ranks_round_once(sums, op):
    """Every rank's bf16 sum, bit for bit the reference's (which on column
    0 is 1 + 2^-6, where a sum in bf16 gives 1)."""
    ref, ranks = sums
    for rank, got in enumerate(ranks):
        n = X.shape[1] // 4
        want = ref[op].reshape(-1) if op == "all_reduce" else ref[op][rank * n:(rank + 1) * n]
        assert got[op].dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(_bits(got[op]).reshape(-1), _bits(want).reshape(-1))
    if op == "all_reduce":
        assert float(ranks[0][op][0]) == 1.0 + 2.0 ** -6


_RESTORE = """
import os, pickle
import jax, numpy as np
from repro.core.compression import CodecSpec
from repro.train import checkpoint as ck, restore_checkpoint, save_checkpoint
import jax.numpy as jnp

# The reference writes a raw bf16 record with numpy's dtype.str, '<V2', and
# then cannot read it back (np.dtype('<V2') is a void type JAX refuses;
# ROADMAP Queue 3); read it as the bf16 it was, as the port does.
unpack = ck._unpack_leaf
ck._unpack_leaf = lambda o: (jnp.asarray(np.frombuffer(o["data"], jnp.bfloat16).reshape(o["shape"]))
                             if o.get("dtype") == "<V2" else unpack(o))

params = jax.tree_util.tree_map(jnp.asarray, PARAMS)
save_checkpoint(os.path.join(CKPT, "ref-tern"), 1, params, compression=CodecSpec(kind="ternary"))
out = {}
for name in ("ref", "tp", "fsdp", "one"):
    st, _ = restore_checkpoint(os.path.join(CKPT, f"{name}-tern"), example_state=params)
    out[name] = [np.asarray(x) for x in jax.tree_util.tree_leaves(st)]
pickle.dump(out, open(OUT, "wb"))
"""


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """(the four ranks' results, the checkpoint directory, the reference's
    restores of its own, the TP, the FSDP and the one-process ternary
    saves)."""
    tmp = tmp_path_factory.mktemp("bf16-shards")
    _, cfg, st = reference_state("olmo-1b", {"qat": True}, lr=BF16_LR, **BF16)
    tm = jax.tree_util.tree_map
    state = {"params": tm(np.asarray, st.params), "wq": tm(np.asarray, st.wq),
             "opt_state": tm(np.asarray, st.opt_state), "step": int(st.step)}
    ckpt = str(tmp / "ckpt")
    ranks = run_ranks("bf16_shards", 4, tmp, timeout=150, state=state, batch=batch_np(cfg, 4),
                      lr=BF16_LR, ckpt=ckpt)
    with open(tmp / "params.pkl", "wb") as f:
        pickle.dump(ranks[0]["params"], f)
    ref = run_jax(f"import ml_dtypes, pickle\nCKPT = {ckpt!r}\n"
                  f"PARAMS = pickle.load(open({str(tmp / 'params.pkl')!r}, 'rb'))\n" + _RESTORE,
                  1, tmp)
    return ranks, ckpt, ref


@pytest.mark.parametrize("name", ["tp", "fsdp"])
@pytest.mark.parametrize("kind", ["raw", "tern"])
def test_bf16_save_from_shards_is_the_one_process_file(shards, name, kind):
    """A bf16 TrainState (raw) and its params (ternary: the bf16 encode of
    the gathered leaves) saved from two ranks' TP or FSDP shards: the same
    bytes as the one-process save; the raw file restored to shards equals
    them, dtype and bits."""
    ranks, ckpt, _ = shards
    step = "step_000000000001"
    for f in ("state.msgpack", "meta.json"):
        with open(os.path.join(ckpt, f"{name}-{kind}", step, f), "rb") as a, \
                open(os.path.join(ckpt, f"one-{kind}", step, f), "rb") as b:
            assert a.read() == b.read(), f
    assert all(r["restored_equal"][name] for r in ranks[:2])


@pytest.mark.parametrize("name", ["tp", "fsdp"])
def test_reference_restores_the_bf16_shard_save(shards, name):
    """The reference reads the ternary file saved from shards into its own
    tree: bf16 leaves, each bit for bit what it restores from the
    one-process file, and the reference's own ternary save of the same
    params restored alike but for its per-leaf scales, which the packages
    compute within rtol 1e-6 of each other (``test_torch_checkpoint.py``),
    so within one bf16 ulp of each value; zero and sign pattern exact."""
    _, _, ref = shards
    assert len(ref[name]) == len(ref["ref"]) == len(ref["one"])
    for a, one, want in zip(ref[name], ref["one"], ref["ref"]):
        assert a.dtype == want.dtype
        np.testing.assert_array_equal(_bits(a), _bits(one))
        a32, w32 = a.astype(np.float32), want.astype(np.float32)
        np.testing.assert_array_equal(np.sign(a32), np.sign(w32))
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w32), 2.0 ** -126))) - 7)
        assert (np.abs(a32 - w32) <= ulp).all()
    assert any(a.dtype == jnp.bfloat16 for a in ref[name])


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_elastic_reshard_of_a_bf16_state(shards, shape):
    """A (2, 2) FSDP x TP bf16 state, gathered and re-placed as DTensors
    onto two ranks: its whole leaves are the gathered state's, dtype and
    bits, and it takes the same step bit for bit as its ``shard_state``
    shards there."""
    ranks, _, _ = shards
    for r in ranks[:2]:
        assert r["elastic"][shape] == {"whole_equal": True, "step_equal": True}


def test_bf16_state_has_bf16_leaves(shards):
    """The saved params are the production cell's: bf16 weights."""
    ranks, _, _ = shards
    leaves = jax.tree_util.tree_leaves(ranks[0]["params"])
    assert {str(x.dtype) for x in leaves} == {"bfloat16"}


@pytest.mark.parametrize("name", ["tp", "fsdp"])
def test_port_restores_the_bf16_shard_save_as_the_reference_does(shards, name):
    """The port reads the same ternary file back to the reference's
    restored leaves, dtype and bits (each scale was once written as the
    bf16 scale's bits read as an integer, 15,898 for 0.1504)."""
    ranks, ckpt, ref = shards
    got, _ = restore_checkpoint(os.path.join(ckpt, f"{name}-tern"),
                                example_state=params_from_jax(ranks[0]["params"], "cpu"),
                                device="cpu")
    leaves = tree_leaves(got)
    assert len(leaves) == len(ref[name])
    for a, want in zip(leaves, ref[name]):
        assert str(a.dtype).removeprefix("torch.") == str(want.dtype)
        np.testing.assert_array_equal(_bits(a.float().numpy()), _bits(want))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """olmo-1b's bf16 prefill of 4 rows × 6 tokens and 4 greedy steps
    through ``launch/steps.py`` on (1, 2) and (2, 1), and on one process."""
    prompts = np.random.default_rng(0).integers(0, 128, (4, 6))
    return run_ranks("bf16_serve_steps", 2, tmp_path_factory.mktemp("bf16-serve"), timeout=120,
                     prompts=prompts, gen=4)[0]


def test_bf16_serving_with_rows_over_data_is_one_process(served):
    """Rows over "data" (each layer's weights gathered whole): every step's
    bf16 logits bit for bit one process's."""
    for a, b in zip(served[(2, 1)], served["one"]):
        assert a.dtype == b.dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_bf16_serving_over_model_within_its_partial_sums(served):
    """Over "model" each row-parallel product is two bf16 partials summed,
    a rounding one process does not make (the reference's partitioned
    step makes it too): every step's logits within 3e-2 of max |logits|
    (1.18e-2 measured, about three bf16 ulps of the largest)."""
    for a, b in zip(served[(1, 2)], served["one"]):
        a, b = a.astype(np.float32), b.astype(np.float32)
        assert np.abs(a - b).max() <= 3e-2 * np.abs(b).max()
