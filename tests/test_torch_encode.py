"""Port vs reference: the client upload (payload mode) and the server
broadcast (server mode) through ``core.tfedavg``, fused and reference, on
the paper's MLP and ResNet18* trees and a ragged stacked leaf.

Payload mode carries the trained w_q as-is, so the wire buffers are
byte-identical to the reference's. Server mode takes its scale from tile
moments whose float sums run in another order than XLA's; codes, framing
and sizes are byte-identical and the scales agree to rtol 1e-6 (ROADMAP
Queue 3). Within the port, fused and reference give the same bytes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.wire import encode_update as jencode
from repro.core import FTTQConfig as JFTTQConfig
from repro.core import fttq as jfttq
from repro.core.tfedavg import client_update_payload as jpayload
from repro.core.tfedavg import fedavg_round_bytes as jfedavg_bytes
from repro.core.tfedavg import server_requantize as jrequantize
from repro.core.tfedavg import tfedavg_round_bytes as jtfedavg_bytes
from repro.models.paper_models import init_mlp_mnist, init_resnet_cifar
from repro_torch.comm.wire import decode_update, encode_update
from repro_torch.convert import params_from_jax
from repro_torch.core.compression import CodecSpec, compress_pytree
from repro_torch.core.fttq import FTTQConfig
from repro_torch.core.ternary import TernaryTensor
from repro_torch.core.tfedavg import (
    client_update_payload, fedavg_round_bytes, server_requantize, tfedavg_round_bytes,
)
from repro_torch.tree import flatten_with_path

torch.set_num_threads(1)


def _ragged_tree(key):
    k = jax.random.split(key, 3)
    return {"stack": {"w": jax.random.normal(k[0], (3, 5, 3))},     # 15 % 4 ≠ 0
            "flat": {"w": jax.random.normal(k[1], (7, 11))},
            "bias": jax.random.normal(k[2], (11,))}


TREES = {
    "mlp": lambda: init_mlp_mnist(jax.random.PRNGKey(0)),
    "resnet": lambda: init_resnet_cifar(jax.random.PRNGKey(1), width=8),
    "ragged": lambda: _ragged_tree(jax.random.PRNGKey(2)),
}


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturbed(tree, seed):
    """A trained-looking tree: the init plus noise, so scales are not the
    init's."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + 0.01 * rng.normal(size=a.shape).astype(a.dtype)),
        tree)


@pytest.mark.parametrize("name", list(TREES))
@pytest.mark.parametrize("fused", [True, False])
def test_client_payload_byte_identical(name, fused):
    jcfg, cfg = JFTTQConfig(), FTTQConfig()
    jparams = _perturbed(TREES[name](), 0)
    jwq = jax.tree_util.tree_map(lambda w: w * 1.1, jfttq.init_wq_tree(jparams, jcfg))
    ref = jencode(jpayload(jparams, jwq, jcfg, fused=fused))
    params = params_from_jax(_to_np(jparams), "cpu")
    wq = params_from_jax(_to_np(jwq), "cpu")
    payload = client_update_payload(params, wq, cfg, fused=fused)
    assert encode_update(payload) == ref
    other = client_update_payload(params, wq, cfg, fused=not fused)
    assert encode_update(other) == ref


def _records(blob: bytes) -> list:
    return flatten_with_path(decode_update(blob), is_leaf=lambda x: isinstance(x, TernaryTensor))


@pytest.mark.parametrize("name,rule", [("mlp", "mean"), ("mlp", "max"), ("ragged", "mean"),
                                       ("ragged", "max"), ("resnet", "mean")])
def test_server_requantize_matches_reference(name, rule):
    """Same sizes, paths, codes and raw leaves byte for byte; scales within
    rtol 1e-6; the port's fused and reference buffers identical."""
    jcfg, cfg = JFTTQConfig(threshold_rule=rule), FTTQConfig(threshold_rule=rule)
    jparams = _perturbed(TREES[name](), 1)
    ref_fused = jencode(jrequantize(jparams, jcfg))
    ref_plain = jencode(jrequantize(jparams, jcfg, fused=False))
    assert ref_fused == ref_plain
    params = params_from_jax(_to_np(jparams), "cpu")
    got = encode_update(server_requantize(params, cfg))
    assert got == encode_update(server_requantize(params, cfg, fused=False))
    assert len(got) == len(ref_fused)
    n_scales = 0
    for (pa, a), (pb, b) in zip(_records(ref_fused), _records(got)):
        assert pa == pb
        assert type(a) is type(b)
        if isinstance(a, TernaryTensor):
            assert (a.shape, a.dtype) == (b.shape, b.dtype)
            np.testing.assert_array_equal(b.packed.numpy(), a.packed.numpy())
            assert tuple(a.w_q.shape) == tuple(b.w_q.shape)
            np.testing.assert_allclose(b.w_q.numpy(), a.w_q.numpy(), rtol=1e-6)
            n_scales += a.w_q.numel()
        else:
            np.testing.assert_array_equal(b.numpy(), a.numpy())
    if name == "resnet":
        assert n_scales == 3 + 16 * 3 + 1   # stem + 16 convs × 3 kernel rows + head


def test_codec_spec_fused_flag_same_bytes():
    """``TernaryCodec`` through the kernel and through the reference chain
    serializes the same bytes."""
    params = params_from_jax(_to_np(_perturbed(TREES["mlp"](), 2)), "cpu")
    a, _ = compress_pytree(params, CodecSpec(kind="ternary"))
    b, _ = compress_pytree(params, CodecSpec(kind="ternary", fused_encode=False))
    assert encode_update(a) == encode_update(b)


@pytest.mark.parametrize("name", ["mlp", "resnet"])
def test_round_bytes_match_reference(name):
    jparams = TREES[name]()
    params = params_from_jax(_to_np(jparams), "cpu")
    assert fedavg_round_bytes(params, 7) == jfedavg_bytes(jparams, 7)
    assert tfedavg_round_bytes(params, 7, FTTQConfig()) == jtfedavg_bytes(
        jparams, 7, JFTTQConfig())


def test_segment_table_covers_the_resnet_tree():
    """ResNet18* at full width: the one launch's segment table lists every
    quantized element exactly once — 52 segments (the stem's 3 kernel rows,
    16 convs × 3, the head), each a slice of its leaf in order, its wire
    bytes back to back and one moment tile each."""
    from repro_torch.core import encode
    from repro_torch.core import fttq
    from repro_torch.core.fttq import init_wq_tree
    from repro_torch.core.ternary import packed_nbytes
    from repro_torch.kernels.quantize_pack import segment_table
    from repro_torch.models.paper_models import init_resnet_cifar

    cfg = FTTQConfig()
    params = init_resnet_cifar(seed=1, device="cpu")
    leaves = dict(flatten_with_path(params))
    wq_paths = flatten_with_path(init_wq_tree(params, cfg))
    items = [encode._Item(leaf=leaves[p], mode="payload", cfg=cfg, wq=wq,
                          stacked=fttq._is_stacked(leaves[p], wq)) for p, wq in wq_paths]
    rows, sizes = [], []
    for it in items:
        seg_rows, scal, n_seg = encode._segments(it)
        assert scal.shape == (n_seg, 2) and seg_rows.data_ptr() == it.leaf.data_ptr()
        rows += [seg_rows[i] for i in range(n_seg)]
        sizes.append((it.leaf.numel(), n_seg))
    table, lay = segment_table(rows)
    t = table.numpy()
    assert t.shape == (52, 5)
    assert sorted(set(int(n) for n in t[:, 1])) == [576, 640, 12288]
    np.testing.assert_array_equal(t[:, 0], [r.data_ptr() for r in rows])
    np.testing.assert_array_equal(t[:, 3], np.arange(52))           # one tile each
    np.testing.assert_array_equal(t[:, 4], 0)
    ends = t[:, 2] + (t[:, 1] + 3) // 4
    np.testing.assert_array_equal(t[1:, 2], ends[:-1])               # back to back
    assert ends[-1] == lay.n_bytes == sum(packed_nbytes(r.numel()) for r in rows)
    assert lay.n_tiles == 52
    row = 0
    for numel, n_seg in sizes:                                        # each leaf, whole, in order
        assert t[row:row + n_seg, 1].sum() == numel
        assert (np.diff(t[row:row + n_seg, 0]) == 4 * t[row, 1]).all()
        row += n_seg
    assert row == 52


def test_one_kernel_call_per_tree_encode(monkeypatch):
    """Each tree encode makes exactly one multi-segment call: the client
    upload, the server broadcast and the codec pre-pass; the broadcast's
    residual pass over an already-encoded tree makes none."""
    from repro_torch.core import encode
    from repro_torch.core.fttq import init_wq_tree
    from repro_torch.models.paper_models import init_resnet_cifar

    calls = []
    real = encode.quantize_pack_segments

    def counting(segments, *a, **kw):
        calls.append(len(segments))
        return real(segments, *a, **kw)

    monkeypatch.setattr(encode, "quantize_pack_segments", counting)
    cfg = FTTQConfig()
    params = init_resnet_cifar(seed=2, width=8, device="cpu")
    client_update_payload(params, init_wq_tree(params, cfg), cfg)
    assert calls == [52]
    broadcast = server_requantize(params, cfg)
    assert calls == [52, 52]
    compress_pytree(broadcast, CodecSpec(kind="ternary"))
    assert calls == [52, 52]
    compress_pytree(params, CodecSpec(kind="ternary"))
    assert len(calls) == 3
