"""Port vs reference: the packed fan-in kernel's plain versions (the
reference's one-stack entry point and the segment-table form the
``Aggregator`` launches) against the Pallas kernel (interpret mode), and
the streaming ``Aggregator`` against
``repro.fed.aggregator.Aggregator`` and the list reference
``server_aggregate`` on the same wire blobs. The CUDA kernel is held
against its plain version in test_torch_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.wire import encode_update as jencode
from repro.core import FTTQConfig as JFTTQConfig
from repro.core import fttq as jfttq
from repro.core.tfedavg import TernaryUpdate as JUpdate
from repro.core.tfedavg import client_update_payload as jpayload
from repro.core.tfedavg import server_aggregate as jserver_aggregate
from repro.fed.aggregator import Aggregator as JAggregator
from repro.kernels.aggregate import packed_weighted_sum as jpws
from repro.kernels.aggregate import packed_weighted_sum_ref
from repro.kernels.aggregate import padded_rows as jpadded_rows
from repro_torch.comm.wire import decode_update, decode_update_leaves
from repro_torch.core.ternary import TernaryTensor
from repro_torch.core.tfedavg import TernaryUpdate, server_aggregate
from repro_torch.fed import aggregator as aggregator_mod
from repro_torch.fed.aggregator import Aggregator
from repro_torch.kernels.aggregate import (
    LANES, fanin_table, packed_weighted_sum, packed_weighted_sum_plain,
    packed_weighted_sum_segments, packed_weighted_sum_segments_plain,
)
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel.fanin import fanin_weighted_sum, fanin_weighted_sum_segments
from repro_torch.tree import flatten_with_path, path_str

torch.set_num_threads(1)


def _stacked(c: int, rows: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    out = rng.integers(0, 3, size=(c, rows, LANES), dtype=np.uint8)
    for j in range(1, 4):   # all four codes of a byte populated
        out |= rng.integers(0, 3, out.shape, dtype=np.uint8) << (2 * j)
    return out


@pytest.mark.parametrize("c,rows,n_pad", [(1, 32, 0), (3, 32, 1), (4, 64, 2),
                                          (16, 32, 5), (16, 96, 0)])
def test_plain_bit_identical_to_pallas(c, rows, n_pad):
    """Same client order from +0.0 and exact terms: every fp32 output is
    bit-identical; the last ``n_pad`` rows are padding (garbage bytes,
    coefficient 0). The tensordot oracle sums in another order (atol)."""
    stacked = _stacked(c, rows, 100 * c + rows)
    coeffs = np.random.default_rng(c).normal(size=(c,)).astype(np.float32)
    if n_pad:
        coeffs[c - n_pad:] = 0.0
        stacked[c - n_pad:] = 0xFF
    ref = np.asarray(jpws(jnp.asarray(stacked), jnp.asarray(coeffs), interpret=True))
    got = packed_weighted_sum_plain(torch.from_numpy(stacked), torch.from_numpy(coeffs))
    assert got.dtype == torch.float32 and got.shape == (4 * rows * LANES,)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref.view(np.uint32))
    np.testing.assert_allclose(got.numpy(), packed_weighted_sum_ref(stacked, coeffs),
                               atol=1e-5)


def test_wrapper_takes_plain_version_on_cpu_and_rejects_other_devices():
    stacked = torch.from_numpy(_stacked(2, 32, 0))
    coeffs = torch.tensor([0.5, -0.25])
    before = packed_weighted_sum.launches
    out = packed_weighted_sum(stacked, coeffs)
    assert packed_weighted_sum.launches == before   # no kernel on the CPU
    assert torch.equal(out, packed_weighted_sum_plain(stacked, coeffs))
    assert torch.equal(fanin_weighted_sum(stacked, coeffs.double()), out)
    with pytest.raises(ValueError, match="unsupported device"):
        packed_weighted_sum(stacked.to("meta"), coeffs.to("meta"))
    with pytest.raises(ValueError):
        packed_weighted_sum(stacked[:, :, :64], coeffs)
    # a mesh with one rank on the client axis folds on this rank, unsharded
    one = make_mesh((1,), ("data",), device="cpu")
    assert torch.equal(fanin_weighted_sum(stacked, coeffs, mesh=one), out)


# (bytes, elements) per segment: ResNet18*'s stem (3 kernel rows of 144 B),
# conv (3 × 3,072 B) and head (160 B) at a quarter of their bytes, and a
# ragged layout — a 1-byte segment, leaves with n % 4 ≠ 0, a 37-byte one.
LAYOUTS = {
    "resnet": [(36, 144)] * 3 + [(768, 3072)] * 3 + [(40, 160)],
    "ragged": [(1, 3), (3, 9), (37, 147), (144, 576), (2, 5), (1, 4)],
}


def _staged_segments(layout, c: int, seed: int):
    """Random wire codes per client and segment, staged at the table's
    offsets (the aligned gaps hold garbage bytes the kernel must not use)."""
    rng = np.random.default_rng(seed)
    table = fanin_table([b for b, _ in layout], [n for _, n in layout])
    staged = rng.integers(0, 256, size=(c, table.row_bytes), dtype=np.uint8)
    segs = []
    for (nb, _), off in zip(layout, table.byte_offsets):
        seg = rng.integers(0, 3, size=(c, nb), dtype=np.uint8)
        for j in range(1, 4):
            seg |= rng.integers(0, 3, seg.shape, dtype=np.uint8) << (2 * j)
        staged[:, off:off + nb] = seg
        segs.append(seg)
    return table, staged, segs


def _jax_stack(seg: np.ndarray) -> np.ndarray:
    """A segment staged for the Pallas kernel, as the reference stages it:
    whole 32-row tiles of 128 bytes, zero tail."""
    c, nb = seg.shape
    rows = jpadded_rows(nb)
    out = np.zeros((c, rows * LANES), np.uint8)
    out[:, :nb] = seg
    return out.reshape(c, rows, LANES)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("c", [1, 3, 10, 17])
def test_segments_plain_bit_identical_to_pallas(layout, c):
    """The one-launch segment form's plain version equals the Pallas kernel
    segment by segment, bit for bit, each segment staged by the reference's
    own ``padded_rows``; slot tails past a ragged segment's elements are
    +0.0. One exception, the sign of a zero: at C = 1 XLA folds the
    kernel's ``0 + w·u`` to ``w·u``, so a code-1 element under a negative
    coefficient is −0.0 there and +0.0 in the port, which sums from +0.0 as
    stated (real coefficients, weight · scale, are ≥ 0)."""
    table, staged, segs = _staged_segments(LAYOUTS[layout], c, 7 * c)
    coeffs = np.random.default_rng(c).normal(size=(c, len(segs))).astype(np.float32)
    got = packed_weighted_sum_segments_plain(torch.from_numpy(staged),
                                             torch.from_numpy(coeffs), table).numpy()
    assert got.shape == (table.n_total,) and table.n_total % 4 == 0
    for s, (seg, n, off) in enumerate(zip(segs, table.n_out, table.out_offsets)):
        ref = np.asarray(jpws(jnp.asarray(_jax_stack(seg)), jnp.asarray(coeffs[:, s]),
                              interpret=True))[:n]
        mine = got[off:off + n]
        np.testing.assert_array_equal(mine, ref)
        nonzero = ref != 0
        np.testing.assert_array_equal(mine[nonzero].view(np.uint32),
                                      ref[nonzero].view(np.uint32))
        if c > 1:
            np.testing.assert_array_equal(mine.view(np.uint32), ref.view(np.uint32))
        tail = got[off + n:off + -(-n // 4) * 4]
        assert not tail.any() and not np.signbit(tail).any()


def test_segments_wrapper_takes_plain_version_on_cpu():
    table, staged, _ = _staged_segments(LAYOUTS["ragged"], 3, 0)
    staged = torch.from_numpy(staged)
    coeffs = torch.randn(3, table.n_segments, generator=torch.Generator().manual_seed(0))
    before = packed_weighted_sum.launches
    out = packed_weighted_sum_segments(staged, coeffs, table)
    assert packed_weighted_sum.launches == before
    assert torch.equal(out, packed_weighted_sum_segments_plain(staged, coeffs, table))
    assert torch.equal(fanin_weighted_sum_segments(staged, coeffs.double(), table), out)
    with pytest.raises(ValueError, match="unsupported device"):
        packed_weighted_sum_segments(staged.to("meta"), coeffs.to("meta"), table)
    with pytest.raises(ValueError):
        packed_weighted_sum_segments(staged[:, :-4], coeffs, table)
    with pytest.raises(ValueError):
        packed_weighted_sum_segments_plain(staged, coeffs[:, :-1], table)
    with pytest.raises(ValueError):
        fanin_table([4, 2], [16, 9])          # 9 elements need 3 bytes
    # a mesh with one rank on the client axis folds on this rank, unsharded
    one = make_mesh((1,), ("data",), device="cpu")
    assert torch.equal(fanin_weighted_sum_segments(staged, coeffs, table, mesh=one), out)


# --------------------------------------------------------------------------
# Streaming Aggregator vs the reference Aggregator and the list reference.
# --------------------------------------------------------------------------

JCFG = JFTTQConfig()


def _params(seed: int) -> dict:
    """Every aggregation corner: a ragged leaf (n % 4 ≠ 0), a per-layer
    stack, an HWIO conv leaf (3 segments, one per kernel row), raw biases
    and an integer counter."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return jnp.asarray(rng.normal(size=shape).astype(np.float32))

    return {
        "enc": {"w": normal(17, 9), "b": normal(9)},
        "stack": {"w": normal(3, 8, 12)},
        "conv": {"w": normal(3, 3, 4, 8)},
        "head": {"w": normal(12, 5), "b": normal(5)},
        "steps": jnp.asarray(7, jnp.int32),
    }


def _blobs(n: int, offset: int = 0) -> tuple[list[bytes], list]:
    blobs, payloads = [], []
    for c in range(n):
        params = _params(offset + c % 6)
        payload = jpayload(params, jfttq.init_wq_tree(params, JCFG), JCFG)
        blobs.append(jencode(payload))
        payloads.append(payload)
    return blobs, payloads


def _weights(n: int, offset: int = 0) -> list[int]:
    return [50 + 13 * (c + offset) for c in range(n)]


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


@pytest.mark.parametrize("n_clients", [1, 3, 8, 17])
def test_aggregator_bit_identical_to_reference(n_clients):
    """The port's Aggregator equals the reference Aggregator bit for bit on
    the same blobs, across bucket boundaries (chunk_c=8: 3 → bucket 4,
    17 → 8 + 8 + 1), multi-segment leaves and raw leaves; and the list
    reference within fp32 reordering (atol 1e-6, rtol 1e-5)."""
    blobs, payloads = _blobs(n_clients)
    weights = _weights(n_clients)
    jagg = JAggregator(chunk_c=8)
    agg = Aggregator(chunk_c=8, device="cpu")
    for blob, w in zip(blobs, weights):
        jagg.add(blob, w)
        agg.add(blob, w)
    ref = _flat_jax(jagg.finalize())
    got = _flat_np(agg.finalize())
    _assert_identical(ref, got)
    assert {k: v.shape for k, v in got.items()}["conv/w"] == (3, 3, 4, 8)
    assert len([k for k in agg._groups if k[0] == "d:conv\x1fd:w"]) == 3

    updates = [TernaryUpdate(payload=decode_update(b), n_samples=w)
               for b, w in zip(blobs, weights)]
    listed = _flat_np(server_aggregate(updates, "cpu"))
    jlisted = _flat_jax(jserver_aggregate(
        [JUpdate(payload=p, n_samples=w) for p, w in zip(payloads, weights)]))
    _assert_identical(jlisted, listed)
    for k in ref:
        np.testing.assert_allclose(got[k].astype(np.float32), listed[k].astype(np.float32),
                                   atol=1e-6, rtol=1e-5, err_msg=k)


def test_aggregator_reset_reuse():
    """finalize(reset=True) keeps plans, the segment table and the staging
    buffer; the next round equals a fresh reference aggregator's on its own
    blobs."""
    agg = Aggregator(chunk_c=4, device="cpu")
    for blob, w in zip(*(_blobs(5)[0], _weights(5))):
        agg.add(blob, w)
    agg.finalize(reset=True)
    kept = (agg._staging, agg._table)
    blobs2, _ = _blobs(3, offset=2)
    jagg = JAggregator(chunk_c=4)
    for blob, w in zip(blobs2, _weights(3, offset=4)):
        agg.add(blob, w)
        jagg.add(blob, w)
    assert agg.n_clients == 3
    _assert_identical(_flat_jax(jagg.finalize()), _flat_np(agg.finalize()))
    assert agg._staging is kept[0] and agg._table is kept[1]


def test_aggregator_stages_exact_bytes():
    """A staged row holds exactly each ternary segment's bytes (rounded up
    to 4) at its table offset, and a flush stages only its own clients
    (7 adds at chunk_c=3: flushes of 3, 3 and 1) and their coefficients."""
    blobs, weights = _blobs(7)[0], _weights(7)
    seen = []
    plain = aggregator_mod.fanin_weighted_sum_segments

    def spy(staged, coeffs, table, **kw):
        seen.append((staged.clone(), coeffs.clone()))
        return plain(staged, coeffs, table, **kw)

    aggregator_mod.fanin_weighted_sum_segments = spy
    try:
        agg = Aggregator(chunk_c=3, device="cpu")
        for blob, w in zip(blobs, weights):
            agg.add(blob, w)
        agg.finalize()
    finally:
        aggregator_mod.fanin_weighted_sum_segments = plain
    segs = []          # (client's bytes of each segment, its scale) per client
    for blob in blobs:
        rows = []
        for _, leaf in decode_update_leaves(blob):
            if isinstance(leaf, TernaryTensor):
                packed, scale = leaf.packed.numpy().reshape(-1), leaf.w_q.reshape(-1).numpy()
                nb = packed.size // scale.size if scale.size > 1 else packed.size
                rows += [(packed[i * nb:(i + 1) * nb], float(scale[i]))
                         for i in range(scale.size)]
        segs.append(rows)
    row_bytes = sum(-(-len(b) // 4) * 4 for b, _ in segs[0])
    assert agg._table.row_bytes == row_bytes and agg._table.n_segments == len(segs[0])
    assert agg._staging.numel() == 3 * (row_bytes + 4 * len(segs[0]))
    assert [tuple(st.shape) for st, _ in seen] == [(3, row_bytes), (3, row_bytes), (1, row_bytes)]
    for k, (staged, coeffs) in enumerate(seen):
        for i in range(staged.shape[0]):
            client = 3 * k + i
            for s, ((b, scale), off) in enumerate(zip(segs[client], agg._table.byte_offsets)):
                assert bytes(staged[i, off:off + len(b)].numpy()) == b.tobytes()
                assert coeffs[i, s].item() == np.float32(weights[client] * scale)


def test_aggregator_fedavg_raw_updates_and_ledgers():
    """An all-raw (FedAvg) update aggregates through the dense fallback,
    bit for bit with the reference; the drop ledger and the checks match."""
    rng = np.random.default_rng(3)
    trees = [{"w": jnp.asarray(rng.normal(size=(6, 5)).astype(np.float32)),
              "b": jnp.asarray(rng.normal(size=(5,)).astype(np.float32))} for _ in range(3)]
    jagg, agg = JAggregator(chunk_c=2), Aggregator(chunk_c=2, device="cpu")
    for t, w in zip(trees, [3, 5, 9]):
        jagg.add(jencode(t), w)
        agg.add(jencode(t), w)
    _assert_identical(_flat_jax(jagg.finalize()), _flat_np(agg.finalize()))
    agg.note_dropped(100)
    agg.note_quarantined(7)
    assert (agg.dropped_updates, agg.dropped_bytes) == (1, 100)
    assert (agg.quarantined_updates, agg.quarantined_bytes) == (1, 7)
    with pytest.raises(ValueError, match="no client updates"):
        Aggregator(device="cpu").finalize()
    with pytest.raises(ValueError):
        agg.add(jencode(trees[0]), -1.0)
    for rule in ("majority", "trimmed_mean", "median"):
        assert Aggregator(device="cpu", rule=rule).rule == rule
    with pytest.raises(ValueError, match="rule"):
        Aggregator(device="cpu", rule="krum")
    with pytest.raises(ValueError, match="trim_frac"):
        Aggregator(device="cpu", trim_frac=0.5)


def test_record_paths_and_rebuild_match_reference():
    """``decode_update_leaves`` gives the reference's record paths in wire
    order, ``tree_leaf_paths`` stamps the same paths on a tree, and
    ``tree_from_records`` rebuilds the decoded tree."""
    from repro.comm.wire import decode_update_leaves as jleaves
    from repro.comm.wire import tree_leaf_paths as jtree_leaf_paths
    from repro_torch.comm.wire import decode_update_leaves, tree_from_records, tree_leaf_paths

    blob = _blobs(1)[0][0]
    pairs = decode_update_leaves(blob)
    assert [p for p, _ in pairs] == [p for p, _ in jleaves(blob)]
    tree = tree_from_records(pairs)
    assert [p for p, _ in tree_leaf_paths(tree)] == [p for p, _ in pairs]
    assert [p for p, _ in jtree_leaf_paths(_params(0))] == [p for p, _ in pairs]
    np.testing.assert_array_equal(tree["enc"]["b"].numpy(),
                                  np.asarray(_params(0)["enc"]["b"]))


def test_aggregator_mixed_codec_round_bit_identical_to_reference():
    """A mean round mixing ternary and raw (FedAvg) uploads of the same
    tree: the raw clients' fused leaves detour to the dense fallback and
    their staged rows carry coefficient 0; the fold equals the reference's
    bit for bit across flushes of 2 (raw clients alone in one flush too)."""
    blobs, _ = _blobs(3)
    raw = [jencode(_params(10 + i)) for i in range(3)]
    order = [raw[0], raw[1], blobs[0], raw[2], blobs[1], blobs[2]]
    jagg, agg = JAggregator(chunk_c=2), Aggregator(chunk_c=2, device="cpu")
    for blob, w in zip(order, _weights(6)):
        jagg.add(blob, w)
        agg.add(blob, w)
    _assert_identical(_flat_jax(jagg.finalize()), _flat_np(agg.finalize()))
