"""Port vs reference: the Byzantine-robust slice. The ``vote`` kernel's
plain version against the Pallas kernel (interpret mode); the robust
statistics and the port's ``Aggregator`` under ``majority``,
``trimmed_mean`` and ``median`` against ``repro.fed.aggregator``, bit for
bit; the gate's verdicts; the attackers' poisoned blobs, byte for byte; and
the defended MLP round against the JAX run. The CUDA kernel is held against
its plain version in test_torch_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.wire import decode_update_leaves as jleaves
from repro.comm.wire import encode_update as jencode
from repro.comm.wire import tree_from_records as jtree_from_records
from repro.core import FTTQConfig as JFTTQConfig
from repro.core import fttq as jfttq
from repro.core.ternary import TernaryTensor as JTernaryTensor
from repro.core.tfedavg import client_update_payload as jpayload
from repro.data import partition_iid as jpartition_iid
from repro.data import synthetic_classification as jsynthetic
from repro.fed import FedConfig as JFedConfig
from repro.fed import run_federated as jrun_federated
from repro.fed.aggregator import Aggregator as JAggregator
from repro.fed.aggregator import trimmed_mean as jtrimmed_mean
from repro.fed.aggregator import weighted_median as jweighted_median
from repro.fed.attackers import AttackConfig as JAttackConfig
from repro.fed.attackers import attacker_ids as jattacker_ids
from repro.fed.attackers import poison_blob as jpoison_blob
from repro.fed.defense import DefenseConfig as JDefenseConfig
from repro.fed.defense import UpdateGate as JUpdateGate
from repro.kernels.vote import majority_from_counts as jmajority
from repro.kernels.vote import packed_vote_counts as jvote
from repro.kernels.vote import packed_vote_counts_ref
from repro.kernels.aggregate import padded_rows as jpadded_rows
from repro.models.paper_models import init_mlp_mnist as jinit_mlp
from repro.models.paper_models import mlp_mnist as jmlp
from repro.optim import adam as jadam
from repro_torch.convert import params_from_jax
from repro_torch.data.federated import partition_iid
from repro_torch.fed import (
    ATTACKS, AttackConfig, DefenseConfig, FedConfig, UpdateGate, attacker_ids, poison_blob,
    run_federated,
)
from repro_torch.fed.aggregator import Aggregator, trimmed_mean, weighted_median
from repro_torch.fed.defense import REASONS
from repro_torch.fed.simulation import resolve_rule
from repro_torch.kernels.aggregate import LANES, fanin_table
from repro_torch.kernels.vote import (
    majority_from_counts, packed_vote_counts, packed_vote_counts_plain,
    packed_vote_counts_segments, packed_vote_counts_segments_plain,
)
from repro_torch.launch.federated import make_eval_fn
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.paper_models import mlp_mnist
from repro_torch.optim import adam
from repro_torch.parallel.fanin import fanin_vote_counts, fanin_vote_counts_segments
from repro_torch.tree import flatten_with_path, path_str

torch.set_num_threads(1)

JCFG = JFTTQConfig()


def _valid_codes(rng, shape):
    codes = rng.integers(0, 3, size=shape + (4,), dtype=np.uint8)
    return codes[..., 0] | (codes[..., 1] << 2) | (codes[..., 2] << 4) | (codes[..., 3] << 6)


# --------------------------------------------------------------------------
# The vote kernel's plain version and the robust statistics.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("c,rows,n_pad", [(1, 32, 0), (3, 32, 1), (8, 64, 3), (16, 96, 5)])
def test_vote_plain_bit_identical_to_pallas(c, rows, n_pad):
    """Every mass bit for bit; the last ``n_pad`` rows are padding clients
    (0xFF bytes, coefficient 0). The tensordot oracle sums in another order."""
    rng = np.random.default_rng(c * 100 + rows)
    stacked = _valid_codes(rng, (c, rows, LANES))
    coeffs = rng.uniform(0.5, 3.0, size=(c,)).astype(np.float32)
    if n_pad:
        coeffs[c - n_pad:] = 0.0
        stacked[c - n_pad:] = 0xFF
    ref = np.asarray(jvote(jnp.asarray(stacked), jnp.asarray(coeffs), interpret=True))
    got = packed_vote_counts_plain(torch.from_numpy(stacked), torch.from_numpy(coeffs))
    assert got.dtype == torch.float32 and got.shape == (2, 4 * rows * LANES)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref.view(np.uint32))
    np.testing.assert_allclose(got.numpy(), packed_vote_counts_ref(stacked, coeffs), atol=1e-4)


def test_vote_wrapper_takes_plain_version_on_cpu_and_rejects_other_devices():
    stacked = torch.from_numpy(_valid_codes(np.random.default_rng(0), (2, 32, LANES)))
    coeffs = torch.tensor([1.5, 0.25])
    before = packed_vote_counts.launches
    out = packed_vote_counts(stacked, coeffs)
    assert packed_vote_counts.launches == before
    assert torch.equal(out, packed_vote_counts_plain(stacked, coeffs))
    assert torch.equal(fanin_vote_counts(stacked, coeffs.double()), out)
    with pytest.raises(ValueError, match="unsupported device"):
        packed_vote_counts(stacked.to("meta"), coeffs.to("meta"))
    with pytest.raises(ValueError):
        packed_vote_counts(stacked[:, :, :64], coeffs)
    # a mesh with one rank on the client axis folds on this rank, unsharded
    one = make_mesh((1,), ("data",), device="cpu")
    assert torch.equal(fanin_vote_counts(stacked, coeffs, mesh=one), out)


# (bytes, elements) per segment: ResNet18*'s stem, conv and head at a
# quarter of their bytes, and a ragged layout (a 1-byte segment, n % 4 ≠ 0).
LAYOUTS = {
    "resnet": [(36, 144)] * 3 + [(768, 3072)] * 3 + [(40, 160)],
    "ragged": [(1, 3), (3, 9), (37, 147), (144, 576), (2, 5), (1, 4)],
}


def _staged_segments(layout, c: int, seed: int):
    """Valid wire codes per client and segment at the table's offsets; the
    aligned gaps hold garbage bytes the kernel must not use."""
    rng = np.random.default_rng(seed)
    table = fanin_table([b for b, _ in layout], [n for _, n in layout])
    staged = rng.integers(0, 256, size=(c, table.row_bytes), dtype=np.uint8)
    segs = []
    for (nb, _), off in zip(layout, table.byte_offsets):
        seg = _valid_codes(rng, (c, nb))
        staged[:, off:off + nb] = seg
        segs.append(seg)
    return table, staged, segs


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("c", [1, 3, 10, 17])
def test_vote_segments_plain_bit_identical_to_pallas(layout, c):
    """Both masses of the one-launch segment form equal the Pallas kernel
    segment by segment, bit for bit, each segment staged by the reference's
    own ``padded_rows`` (whole 32-row tiles, zero tail); slot tails past a
    ragged segment's elements are +0.0 in both planes."""
    table, staged, segs = _staged_segments(LAYOUTS[layout], c, 11 * c)
    weights = np.random.default_rng(c).uniform(0.5, 3.0, size=(c,)).astype(np.float32)
    got = packed_vote_counts_segments_plain(torch.from_numpy(staged),
                                            torch.from_numpy(weights), table).numpy()
    assert got.shape == (2, table.n_total)
    for seg, n, off in zip(segs, table.n_out, table.out_offsets):
        rows = jpadded_rows(seg.shape[1])
        stack = np.zeros((c, rows * LANES), np.uint8)
        stack[:, :seg.shape[1]] = seg
        ref = np.asarray(jvote(jnp.asarray(stack.reshape(c, rows, LANES)),
                               jnp.asarray(weights), interpret=True))[:, :n]
        np.testing.assert_array_equal(got[:, off:off + n].view(np.uint32), ref.view(np.uint32))
        tail = got[:, off + n:off + -(-n // 4) * 4]
        assert not tail.view(np.uint32).any()


def test_vote_segments_wrapper_takes_plain_version_on_cpu():
    table, staged, _ = _staged_segments(LAYOUTS["ragged"], 3, 0)
    staged = torch.from_numpy(staged)
    weights = torch.tensor([1.5, 0.25, 2.0])
    before = packed_vote_counts.launches
    out = packed_vote_counts_segments(staged, weights, table)
    assert packed_vote_counts.launches == before
    assert torch.equal(out, packed_vote_counts_segments_plain(staged, weights, table))
    assert torch.equal(fanin_vote_counts_segments(staged, weights.double(), table), out)
    with pytest.raises(ValueError, match="unsupported device"):
        packed_vote_counts_segments(staged.to("meta"), weights.to("meta"), table)
    with pytest.raises(ValueError):
        packed_vote_counts_segments_plain(staged, weights[:2], table)
    # a mesh with one rank on the client axis folds on this rank, unsharded
    one = make_mesh((1,), ("data",), device="cpu")
    assert torch.equal(fanin_vote_counts_segments(staged, weights, table, mesh=one), out)


def test_majority_from_counts_matches_reference():
    """Strict plurality, ties to 0, on the reference's example and on masses
    with ties and non-integer weights."""
    counts = np.array([[3.0, 1.0, 2.0, 1.0, 0.0], [1.0, 3.0, 2.0, 1.0, 0.0]], np.float32)
    assert majority_from_counts(torch.from_numpy(counts), 5.0).tolist() == [-1, 1, 0, 0, 0]
    assert majority_from_counts(torch.zeros(2, 4), 0.0).tolist() == [0, 0, 0, 0]
    rng = np.random.default_rng(3)
    for weights in (np.ones(7), rng.uniform(0.1, 3.0, size=7), np.array([0.1] * 10)):
        codes = rng.integers(0, 3, size=(len(weights), 2000))
        w = weights.astype(np.float32)
        counts = np.stack([(w[:, None] * (codes == 0)).sum(0),
                           (w[:, None] * (codes == 2)).sum(0)]).astype(np.float32)
        total = float(weights.sum())
        got = majority_from_counts(torch.from_numpy(counts), total)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), jmajority(counts, total))


def _stacks():
    """Random stacks with ties (values from a small set), non-integer weights,
    1-D stacks (scalar leaves: numpy sums those pairwise) and 2-D ones."""
    rng = np.random.default_rng(9)
    for c in (1, 2, 3, 5, 9, 12, 20):
        for shape in ((c,), (c, 1), (c, 37), (c, 4, 6)):
            vals = rng.choice(np.array([-1.5, -0.5, 0.0, 0.25, 1.0], np.float32), size=shape)
            noisy = vals + rng.normal(size=shape).astype(np.float32) * (rng.random(shape) < 0.5)
            w = rng.uniform(0.1, 5.0, size=c).astype(np.float32)
            yield noisy.astype(np.float32), w
            yield vals, np.ceil(w)


def test_weighted_median_matches_reference():
    for stack, w in _stacks():
        got = weighted_median(torch.from_numpy(stack), torch.from_numpy(w))
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(jweighted_median(stack, w)).view(np.uint32))


@pytest.mark.parametrize("trim", [0.0, 0.1, 0.2, 0.45])
def test_trimmed_mean_matches_reference(trim):
    for stack, w in _stacks():
        got = trimmed_mean(torch.from_numpy(stack), torch.from_numpy(w), trim)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(jtrimmed_mean(stack, w, trim)).view(np.uint32))


# --------------------------------------------------------------------------
# The Aggregator under the robust rules.
# --------------------------------------------------------------------------


def _params(seed: int) -> dict:
    """A ragged leaf (n % 4 ≠ 0), a per-layer stack, an HWIO conv leaf
    (3 scale segments), raw biases and an integer counter."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return jnp.asarray(rng.normal(size=shape).astype(np.float32))

    return {"enc": {"w": normal(17, 9), "b": normal(9)}, "stack": {"w": normal(3, 8, 12)},
            "conv": {"w": normal(3, 3, 4, 8)}, "head": {"w": normal(12, 5), "b": normal(5)},
            "steps": jnp.asarray(7, jnp.int32)}


def _blob(seed: int) -> bytes:
    params = _params(seed)
    return jencode(jpayload(params, jfttq.init_wq_tree(params, JCFG), JCFG))


def _flat_np(tree):
    return {path_str(p): np.asarray(leaf) for p, leaf in flatten_with_path(tree)}


def _flat_jax(tree):
    return {jfttq._path_str(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_identical(ref: dict, got: dict):
    assert ref.keys() == got.keys()
    for k in ref:
        assert ref[k].dtype == got[k].dtype and ref[k].shape == got[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("rule", ["majority", "trimmed_mean", "median"])
def test_aggregator_robust_rules_bit_identical_to_reference(rule):
    """9 adds at chunk_c=4 cross two full chunks and a partial flush (vote
    masses accumulate across them); then the same instance, reset, folds a
    second round equal to a fresh reference aggregator's."""
    blobs = [_blob(c % 6) for c in range(9)]
    weights = [50 + 13 * c + 0.25 * (c % 3) for c in range(9)]
    jagg = JAggregator(chunk_c=4, rule=rule, trim_frac=0.2)
    agg = Aggregator(chunk_c=4, device="cpu", rule=rule, trim_frac=0.2)
    for blob, w in zip(blobs, weights):
        jagg.add(blob, w)
        agg.add(blob, w)
    _assert_identical(_flat_jax(jagg.finalize()), _flat_np(agg.finalize(reset=True)))
    jagg2 = JAggregator(chunk_c=4, rule=rule)
    for blob, w in zip(blobs[3:8], weights[::2]):
        jagg2.add(blob, w)
        agg.add(blob, w)
    _assert_identical(_flat_jax(jagg2.finalize()), _flat_np(agg.finalize()))


def test_mixed_codecs_under_majority_raise():
    """A raw record on a path planned for the vote has no robust
    decomposition: the port refuses it as the reference does."""
    raw = jencode({k: v for k, v in _params(1).items()})
    for agg in (JAggregator(rule="majority"), Aggregator(device="cpu", rule="majority")):
        agg.add(_blob(0), 1.0)
        with pytest.raises(ValueError, match="mixed wire kinds"):
            agg.add(raw, 1.0)


def test_majority_defeats_sign_flip_minority():
    """5 honest copies at weight 2 and 4 sign-flipped ones at weight 1: the
    defended fold equals the honest-only majority exactly (and the
    reference's)."""
    honest = _blob(2)
    flipped = poison_blob(honest, AttackConfig(kind="sign_flip", n_attackers=4), client_id=0)
    agg, ref, jagg = (Aggregator(chunk_c=4, device="cpu", rule="majority"),
                      Aggregator(chunk_c=4, device="cpu", rule="majority"),
                      JAggregator(chunk_c=4, rule="majority"))
    for _ in range(5):
        for a in (agg, ref, jagg):
            a.add(honest, 2.0)
    for _ in range(4):
        agg.add(flipped, 1.0)
        jagg.add(flipped, 1.0)
    got = _flat_np(agg.finalize())
    _assert_identical(_flat_np(ref.finalize()), got)
    _assert_identical(_flat_jax(jagg.finalize()), got)


def test_resolve_rule():
    assert resolve_rule(FedConfig()) == ("mean", 0.2)
    assert resolve_rule(FedConfig(defense=DefenseConfig(enabled=False, rule="median")))[0] == "mean"
    assert resolve_rule(FedConfig(defense=DefenseConfig(enabled=True, rule="trimmed_mean",
                                                        trim_frac=0.1))) == ("trimmed_mean", 0.1)
    with pytest.raises(ValueError, match="fused_aggregation"):
        resolve_rule(FedConfig(fused_aggregation=False,
                               defense=DefenseConfig(enabled=True, rule="majority")))


# --------------------------------------------------------------------------
# The gate and the attackers.
# --------------------------------------------------------------------------


def _with_ternary(blob: bytes, fn) -> bytes:
    """The blob with ``fn`` applied to its first ternary record (reference
    types), re-encoded."""
    out, hit = [], False
    for path, leaf in jleaves(blob, zero_copy=True):
        if isinstance(leaf, JTernaryTensor) and not hit:
            leaf, hit = fn(leaf), True
        out.append((path, leaf))
    return jencode(jtree_from_records(out))


def _gate_blobs() -> list[bytes]:
    """A sequence that reaches every quarantine reason after a warm-up."""
    honest = [_blob(s) for s in range(4)]
    blown = jpoison_blob(honest[0], JAttackConfig(kind="scale_blowup", n_attackers=1), 0)
    nan = jpoison_blob(honest[1], JAttackConfig(kind="nan_poison", n_attackers=1), 1)

    def inf_scale(leaf):
        return JTernaryTensor(packed=np.asarray(leaf.packed),
                              w_q=np.full_like(np.asarray(leaf.w_q), np.inf),
                              shape=tuple(leaf.shape), dtype=leaf.dtype)

    def code3(leaf):
        packed = np.array(leaf.packed, dtype=np.uint8, copy=True)
        packed.reshape(-1)[0] = 0xFF
        return JTernaryTensor(packed=packed, w_q=np.asarray(leaf.w_q),
                              shape=tuple(leaf.shape), dtype=leaf.dtype)

    alien = jencode({"enc": {"w": np.zeros((3, 3), np.float32)}})
    nan_bias = [(p, np.full(np.shape(leaf), np.nan, np.float32)
                 if p.endswith("d:b") else leaf) for p, leaf in jleaves(honest[2], zero_copy=True)]
    return [blown, honest[0], honest[1], b"\x00garbage that never framed", alien, nan,
            _with_ternary(honest[2], inf_scale), honest[2], blown,
            _with_ternary(honest[3], code3), jencode(jtree_from_records(nan_bias)), honest[3],
            blown]


def test_gate_verdicts_match_reference():
    """The same blob sequence through both gates (min_history 2): the same
    verdicts and reasons in order, every reason reached, equal telemetry.
    The gate is built from the broadcast tree on its device: the port's
    from torch tensors, the reference's from jax arrays."""
    params = _params(0)
    jgate = JUpdateGate(JDefenseConfig(enabled=True, min_history=2), params)
    gate = UpdateGate(DefenseConfig(enabled=True, min_history=2),
                      params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu"))
    want = [(v.ok, v.reason) for v in map(jgate.check, _gate_blobs())]
    got = [(v.ok, v.reason) for v in map(gate.check, _gate_blobs())]
    assert got == want
    assert {r for ok, r in got if not ok} == set(REASONS)
    assert gate.telemetry() == jgate.telemetry()


def test_gate_on_honest_updates_passes_them_all():
    params = _params(0)
    gate = UpdateGate(DefenseConfig(enabled=True),
                      params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu"))
    blobs = [_blob(s) for s in range(6)]
    assert all(gate.check(b).ok for b in blobs)
    t = gate.telemetry()
    assert t["passed_bytes"] == sum(map(len, blobs)) and t["quarantined_updates"] == 0


def test_gate_checks_raw_bf16_payloads():
    """Raw bf16 leaves get the reference's verdicts: a finite one passes and
    so does one holding a NaN, since the reference's numpy check skips
    bfloat16, which is not ``np.floating`` (a reference defect, ROADMAP
    Queue 3). A mismatched shape is ``structure`` in both."""
    from repro_torch.comm.wire import encode_update

    gate = UpdateGate(DefenseConfig(enabled=True), {"b": torch.zeros(8, dtype=torch.bfloat16)})
    jgate = JUpdateGate(JDefenseConfig(enabled=True), {"b": jnp.zeros(8, jnp.bfloat16)})
    bad = torch.ones(8, dtype=torch.bfloat16)
    bad[3] = float("nan")
    blobs = [encode_update({"b": torch.ones(8, dtype=torch.bfloat16)}),
             encode_update({"b": bad}),
             encode_update({"b": torch.ones(4, dtype=torch.bfloat16)})]
    got = [gate.check(b) for b in blobs]
    want = [jgate.check(b) for b in blobs]
    assert [(v.ok, v.reason) for v in got] == [(v.ok, v.reason) for v in want]
    assert [v.ok for v in got] == [True, True, False] and got[2].reason == "structure"
    assert gate.telemetry() == jgate.telemetry()


def test_defense_and_attack_configs_validate():
    for bad in ({"rule": "krum"}, {"scale_bound": 1.0}, {"min_history": 0}, {"trim_frac": 0.5}):
        with pytest.raises(ValueError):
            DefenseConfig(**bad)
    for bad in ({"kind": "rootkit"}, {"n_attackers": -1}, {"blowup": 1.0}):
        with pytest.raises(ValueError):
            AttackConfig(**bad)


@pytest.mark.parametrize("kind", ATTACKS)
def test_poisoned_blobs_byte_identical_to_reference(kind):
    honest = _blob(5)
    for seed, client, rnd in ((0, 0, 0), (7, 3, 2)):
        cfg, jcfg = AttackConfig(kind=kind, n_attackers=2, seed=seed), JAttackConfig(
            kind=kind, n_attackers=2, seed=seed)
        got = poison_blob(honest, cfg, client, round_idx=rnd)
        assert got == jpoison_blob(honest, jcfg, client, round_idx=rnd)
        assert got != honest
    if kind == "sign_flip":      # an involution: flipping twice gives the honest bytes
        assert poison_blob(got, cfg, client, round_idx=rnd) == honest


def test_attacker_ids_match_reference():
    for n_att, seed, n in ((0, 0, 16), (5, 3, 16), (30, 0, 100), (9, 2, 4)):
        ids = attacker_ids(AttackConfig(n_attackers=n_att, seed=seed), n)
        assert ids == jattacker_ids(JAttackConfig(n_attackers=n_att, seed=seed), n)
        assert len(ids) == min(n_att, n)


# --------------------------------------------------------------------------
# The defended sync round on the MLP task, against the JAX run.
# --------------------------------------------------------------------------

PARAM_ATOL = 2e-6              # as tests/test_torch_fed.py: sound gap < 1e-6
FLIPS_PER_ELEMENT = 1e-4


@pytest.fixture(scope="module")
def sim_task():
    """The MLP task of tests/test_robust.py."""
    x, y, xt, yt = jsynthetic(jax.random.PRNGKey(0), 600, 10, 784, noise=3.0, n_test=100)
    return x, y, xt, yt, jinit_mlp(jax.random.PRNGKey(1))


def _recording(eval_fn, seen, to_numpy):
    def wrapped(params):
        seen.append({path_str(p): to_numpy(leaf) for p, leaf in flatten_with_path(params)})
        return eval_fn(params)
    return wrapped


def _jax_eval(xt, yt):
    xt_j, yt_j = jnp.asarray(xt), jnp.asarray(yt)

    def eval_fn(p):
        return float(jnp.mean(jnp.argmax(jmlp(p, xt_j), -1) == yt_j)), 0.0
    return eval_fn


def _run_port(task, **cfg_kw):
    x, y, xt, yt, jparams = task
    seen = []
    eval_fn = make_eval_fn(mlp_mnist, xt, yt, torch.device("cpu"))
    res = run_federated(
        mlp_mnist, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu"),
        partition_iid(x, y, 4), FedConfig(algorithm="tfedavg", participation=1.0,
                                          local_epochs=1, batch_size=64, rounds=2, **cfg_kw),
        adam(1e-3), _recording(eval_fn, seen, lambda t: t.numpy().copy()), eval_every=1,
        device="cpu")
    res.params = seen
    return res


def _run_jax(task, **cfg_kw):
    x, y, xt, yt, jparams = task
    seen = []
    res = jrun_federated(jmlp, jparams, jpartition_iid(x, y, 4), JFedConfig(
        algorithm="tfedavg", participation=1.0, local_epochs=1, batch_size=64, rounds=2,
        **cfg_kw), jadam(1e-3), _recording(_jax_eval(xt, yt), seen, np.asarray),
        eval_every=1)
    res.params = seen
    return res


def _assert_same_ledger(ref, got):
    assert got.upload_bytes == ref.upload_bytes
    assert got.download_bytes == ref.download_bytes
    assert got.round_times == ref.round_times
    assert got.participants_per_round == ref.participants_per_round
    assert got.telemetry["upload_bytes_per_round"] == ref.telemetry["upload_bytes_per_round"]
    assert got.telemetry["defense"] == ref.telemetry["defense"]


def _assert_same_globals(ref, got):
    assert len(got.params) == len(ref.params) == 2
    for r, (want, have) in enumerate(zip(ref.params, got.params)):
        assert sorted(have) == sorted(want)
        for path, a in have.items():
            b = want[path]
            outside = int((np.abs(a - b) > PARAM_ATOL).sum())
            allowed = int(FLIPS_PER_ELEMENT * a.size) if a.ndim >= 2 else 0
            assert outside <= allowed, (r, path, float(np.abs(a - b).max()))


def test_sim_nan_poison_quarantined_like_the_reference(sim_task):
    """One nan_poison attacker per round: the gate quarantines its upload in
    both runs; ledger, bytes, round times and participants equal."""
    ref = _run_jax(sim_task, attack=JAttackConfig(kind="nan_poison", n_attackers=1, seed=2),
                   defense=JDefenseConfig(enabled=True))
    got = _run_port(sim_task, attack=AttackConfig(kind="nan_poison", n_attackers=1, seed=2),
                    defense=DefenseConfig(enabled=True))
    assert got.telemetry["defense"]["ledger_balanced"]
    assert got.telemetry["defense"]["quarantined_updates"] == 2
    _assert_same_ledger(ref, got)
    _assert_same_globals(ref, got)


def test_sim_holds_the_model_when_every_upload_is_quarantined(sim_task):
    """Every client poisons: each round quarantines all four uploads, books
    their bytes, and holds the global model, as the reference does."""
    kw = dict(attack=AttackConfig(kind="nan_poison", n_attackers=4, seed=2),
              defense=DefenseConfig(enabled=True))
    got = _run_port(sim_task, **kw)
    ref = _run_jax(sim_task, attack=JAttackConfig(kind="nan_poison", n_attackers=4, seed=2),
                   defense=JDefenseConfig(enabled=True))
    _assert_same_ledger(ref, got)
    assert got.telemetry["defense"]["quarantined_updates"] == 8
    assert got.telemetry["defense"]["passed_updates"] == 0
    initial = {path_str(p): np.asarray(leaf) for p, leaf in
               flatten_with_path(jax.tree_util.tree_map(np.asarray, sim_task[4]))}
    for held in got.params:
        assert all(np.array_equal(held[k], initial[k]) for k in initial)


def test_sim_sign_flip_under_majority_matches_reference(sim_task):
    ref = _run_jax(sim_task, attack=JAttackConfig(kind="sign_flip", n_attackers=1, seed=2),
                   defense=JDefenseConfig(enabled=True, rule="majority"))
    got = _run_port(sim_task, attack=AttackConfig(kind="sign_flip", n_attackers=1, seed=2),
                    defense=DefenseConfig(enabled=True, rule="majority"))
    assert got.telemetry["defense"]["quarantined_updates"] == 0
    _assert_same_ledger(ref, got)
    _assert_same_globals(ref, got)


def test_sim_gate_on_honest_equals_gate_off(sim_task):
    """The gate never mutates a payload and draws no randomness."""
    off = _run_port(sim_task)
    on = _run_port(sim_task, defense=DefenseConfig(enabled=True))
    assert on.upload_bytes == off.upload_bytes and on.round_times == off.round_times
    assert on.accuracy == off.accuracy
    for a, b in zip(on.params, off.params):
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    d = on.telemetry["defense"]
    assert d["quarantined_updates"] == 0 and d["ledger_balanced"]
    assert "defense" not in off.telemetry
