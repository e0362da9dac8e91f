"""Port vs reference: the packed fan-in kernel's plain version against the
Pallas kernel (interpret mode), and the streaming ``Aggregator`` against
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
from repro_torch.comm.wire import decode_update
from repro_torch.core.tfedavg import TernaryUpdate, server_aggregate
from repro_torch.fed.aggregator import Aggregator, bucket_for
from repro_torch.kernels.aggregate import (
    LANES, packed_weighted_sum, packed_weighted_sum_plain, padded_rows,
)
from repro_torch.parallel.fanin import fanin_weighted_sum
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
    with pytest.raises(NotImplementedError):
        fanin_weighted_sum(stacked, coeffs, mesh=object())


@pytest.mark.parametrize("nbytes", [1, 127, 128, 144, 3072, 4096, 4097, 160_000])
def test_padded_rows_matches_reference(nbytes):
    assert padded_rows(nbytes) == jpadded_rows(nbytes)


@pytest.mark.parametrize("c,chunk", [(1, 16), (3, 16), (5, 4), (16, 16), (17, 16), (9, 6)])
def test_bucket_for(c, chunk):
    from repro.fed.aggregator import bucket_for as jbucket_for

    assert bucket_for(c, chunk) == jbucket_for(c, chunk)


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
    """finalize(reset=True) keeps plans and staging buffers; the next round
    equals a fresh reference aggregator's on its own blobs."""
    agg = Aggregator(chunk_c=4, device="cpu")
    for blob, w in zip(*(_blobs(5)[0], _weights(5))):
        agg.add(blob, w)
    agg.finalize(reset=True)
    buffers = dict(agg._buffers)
    blobs2, _ = _blobs(3, offset=2)
    jagg = JAggregator(chunk_c=4)
    for blob, w in zip(blobs2, _weights(3, offset=4)):
        agg.add(blob, w)
        jagg.add(blob, w)
    assert agg.n_clients == 3
    _assert_identical(_flat_jax(jagg.finalize()), _flat_np(agg.finalize()))
    assert all(agg._buffers[k] is v for k, v in buffers.items())


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
