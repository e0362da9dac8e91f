"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``gpu`` marker and skips where no CUDA device
is present. The module imports torch, numpy and the port only, so it also
runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from repro_torch.comm.wire import decode_update_leaves, encode_update
from repro_torch.core.encode import leaf_scalars, segment_scalars
from repro_torch.core.fttq import FTTQConfig, init_wq_tree
from repro_torch.core.ternary import TernaryTensor, encode_ternary, packed_nbytes
from repro_torch.core.tfedavg import client_update_payload, server_requantize
from repro_torch.fed import hierarchy
from repro_torch.fed.aggregator import Aggregator
from repro_torch.fed.hierarchy import EdgeTier, HierarchyConfig
from repro_torch.kernels import ops
from repro_torch.kernels.aggregate import (
    LANES, fanin_table, packed_weighted_sum, packed_weighted_sum_plain,
    packed_weighted_sum_segments, packed_weighted_sum_segments_plain,
)
from repro_torch.kernels.pack2bit import pack2bit, pack2bit_plain, unpack2bit, unpack2bit_plain
from repro_torch.kernels.quantize_pack import (
    quantize_pack, quantize_pack_plain, quantize_pack_segments, quantize_pack_segments_plain,
    segment_layout,
)
from repro_torch.kernels.ternary_quantize import ternary_quantize, ternary_quantize_plain
from repro_torch.kernels.vote import (
    packed_vote_counts, packed_vote_counts_plain, packed_vote_counts_segments,
    packed_vote_counts_segments_plain,
)
from repro_torch.models.paper_models import init_resnet_cifar
from repro_torch.tree import flatten_with_path, tree_map
from repro_torch.kernels.ternary_matmul import (
    ternary_matmul, ternary_matmul_plain, ternary_matmul_split,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(5,), (33001,), (3, 2048, 2048), (16, 8192, 2048)])
def test_quantize_pack_matches_plain(cuda_device, shape):
    """Codes and tile counts exact, tile sums within rtol 1e-5."""
    x = torch.randn(shape, generator=torch.Generator(cuda_device).manual_seed(0),
                    device=cuda_device)
    scal, _ = leaf_scalars(x, FTTQConfig())
    before = quantize_pack.launches
    packed, moments = quantize_pack(x, scal)
    assert quantize_pack.launches == before + 1
    ref_packed, ref_moments = quantize_pack_plain(x, scal)
    torch.cuda.synchronize()
    assert torch.equal(packed, ref_packed)
    assert torch.equal(moments[:, 1], ref_moments[:, 1])
    torch.testing.assert_close(moments[:, 0], ref_moments[:, 0], rtol=1e-5, atol=0)


def test_quantize_pack_unaligned_leaf(cuda_device):
    """A view that starts off a 16-byte boundary takes the scalar loads."""
    base = torch.randn(4097, device=cuda_device)
    x = base[1:]
    scal = torch.tensor([4.0, 0.2], device=cuda_device)
    packed, moments = quantize_pack(x, scal)
    ref_packed, ref_moments = quantize_pack_plain(x, scal)
    assert torch.equal(packed, ref_packed)
    torch.testing.assert_close(moments, ref_moments, rtol=1e-5, atol=0)


@pytest.mark.parametrize("mode", ["payload", "server"])
@pytest.mark.parametrize("shape", [(3, 3, 3, 64), (3, 3, 64, 64), (64, 10)])
def test_quantize_pack_segments_through_out(cuda_device, shape, mode):
    """ResNet18*'s segments (576, 12,288 and 640 elements) as the encode
    writes them, each at its byte offset of one buffer: codes, counts and
    the bytes around them exact, tile sums within rtol 1e-6."""
    gen = torch.Generator(cuda_device).manual_seed(len(shape))
    leaf = torch.randn(shape, generator=gen, device=cuda_device) * 0.05
    rows = leaf.reshape(shape[0] if len(shape) >= 3 else 1, -1)
    denom, delta = segment_scalars(rows, mode, FTTQConfig())
    scal = torch.cat([denom, delta], dim=1).to(torch.float32)
    seg = packed_nbytes(rows.shape[1])
    buf = torch.full((16 + rows.shape[0] * seg + 16,), 0xA5, dtype=torch.uint8,
                     device=cuda_device)
    want = buf.clone()
    for i in range(rows.shape[0]):
        at = 16 + i * seg
        _, moments = quantize_pack(rows[i], scal[i], out=buf[at:at + seg])
        ref_packed, ref_moments = quantize_pack_plain(rows[i], scal[i])
        want[at:at + seg] = ref_packed
        assert torch.equal(moments[:, 1], ref_moments[:, 1])
        torch.testing.assert_close(moments[:, 0], ref_moments[:, 0], rtol=1e-6, atol=0)
    assert torch.equal(buf, want)


def test_encode_on_the_card_matches_the_reference_chain(cuda_device):
    """ResNet18* (width 16): the fused upload's wire bytes equal the
    reference chain's; the fused broadcast's codes equal it and its scales
    are within rtol 1e-6."""
    cfg = FTTQConfig()
    params = init_resnet_cifar(seed=3, width=16, device=cuda_device)
    wq = init_wq_tree(params, cfg)
    up = [encode_update(client_update_payload(params, wq, cfg, fused=f)) for f in (True, False)]
    assert up[0] == up[1]
    fused, ref = (flatten_with_path(server_requantize(params, cfg, fused=f)) for f in (True, False))
    n_ternary = 0
    for (pa, a), (pb, b) in zip(fused, ref):
        assert pa == pb
        if isinstance(b, TernaryTensor):
            n_ternary += 1
            assert a.shape == b.shape and a.dtype == b.dtype
            assert torch.equal(torch.as_tensor(a.packed).cpu(), torch.as_tensor(b.packed).cpu())
            torch.testing.assert_close(torch.as_tensor(a.w_q).cpu(),
                                       torch.as_tensor(b.w_q).cpu(), rtol=1e-6, atol=0)
        else:
            assert torch.equal(a, b), pa
    assert n_ternary == 18


@pytest.mark.parametrize("mode", ["payload", "server"])
def test_quantize_pack_segments_match_plain(cuda_device, mode):
    """ResNet18*'s 52 segments (and a ragged, a two-tile and a one-element
    segment) in one launch into a guarded buffer: bytes and guards exact,
    counts exact, tile sums and scales within rtol 1e-6."""
    gen = torch.Generator(cuda_device).manual_seed(52)
    sizes = [576] * 3 + [12288] * 48 + [640] + [7, 40001, 1]
    base = torch.randn(sum(sizes) + 8, generator=gen, device=cuda_device) * 0.05
    segs, at = [], 0
    for n in sizes:
        segs.append(base[at:at + n])
        at += n + (4 if n == 7 else 0)       # one segment starts off a 16-byte boundary
    rows = torch.stack([torch.cat([x.abs().max().reshape(1) + 1e-8,
                                   torch.full((1,), 0.05, device=cuda_device)]) for x in segs])
    if mode == "payload":
        rows[:, 1] = torch.stack([0.7 * (x / d).abs().mean() for x, d in zip(segs, rows[:, 0])])
    lay = segment_layout(sizes)
    buf = torch.full((16 + lay.n_bytes + 16,), 0xA5, dtype=torch.uint8, device=cuda_device)
    before = quantize_pack.launches
    _, moments, scales = quantize_pack_segments(segs, rows, out=buf[16:16 + lay.n_bytes],
                                                with_scales=mode == "server")
    assert quantize_pack.launches == before + 1
    ref_packed, ref_moments, ref_scales = quantize_pack_segments_plain(
        segs, rows, with_scales=mode == "server")
    torch.cuda.synchronize()
    want = torch.full_like(buf, 0xA5)
    want[16:16 + lay.n_bytes] = ref_packed
    assert torch.equal(buf, want)
    assert torch.equal(moments[:, 1], ref_moments[:, 1])
    torch.testing.assert_close(moments[:, 0], ref_moments[:, 0], rtol=1e-6, atol=0)
    if mode == "server":
        torch.testing.assert_close(scales, ref_scales, rtol=1e-6, atol=0)
        for _ in range(2):                   # the scales' order is fixed: launches agree
            _, _, again = quantize_pack_segments(segs, rows, with_scales=True)
            torch.cuda.synchronize()
            assert torch.equal(again, scales)
    else:
        assert scales is None


def test_quantize_pack_segments_many_tiles(cuda_device):
    """Segments of many moment tiles (129, 32 and 25) in one launch, the
    scales formed on the card from all of a segment's tiles: bytes exact,
    counts exact, tile sums and scales within rtol 1e-6."""
    gen = torch.Generator(cuda_device).manual_seed(129)
    segs = [torch.randn(n, generator=gen, device=cuda_device)
            for n in (2 ** 22 + 3, 2 ** 20, 3 * 2 ** 18 + 1)]
    rows = torch.stack([torch.cat([x.abs().max().reshape(1) + 1e-8,
                                   torch.full((1,), 0.1, device=cuda_device)]) for x in segs])
    packed, moments, scales = quantize_pack_segments(segs, rows, with_scales=True)
    ref_packed, ref_moments, ref_scales = quantize_pack_segments_plain(segs, rows, True)
    torch.cuda.synchronize()
    assert moments.shape[0] == 129 + 32 + 25
    assert torch.equal(packed, ref_packed)
    assert torch.equal(moments[:, 1], ref_moments[:, 1])
    torch.testing.assert_close(moments[:, 0], ref_moments[:, 0], rtol=1e-6, atol=0)
    torch.testing.assert_close(scales, ref_scales, rtol=1e-6, atol=0)


def test_encode_launches_quantize_pack_once_per_tree(cuda_device):
    """A ResNet18* upload, a broadcast and a codec pass each launch the
    kernel exactly once; the residual pass over an encoded tree launches
    none."""
    from repro_torch.core.compression import CodecSpec, compress_pytree

    cfg = FTTQConfig()
    params = init_resnet_cifar(seed=4, width=16, device=cuda_device)
    wq = init_wq_tree(params, cfg)
    before = quantize_pack.launches
    client_update_payload(params, wq, cfg)
    assert quantize_pack.launches == before + 1
    broadcast = server_requantize(params, cfg)
    assert quantize_pack.launches == before + 2
    compress_pytree(broadcast, CodecSpec(kind="ternary"))
    assert quantize_pack.launches == before + 2
    compress_pytree(params, CodecSpec(kind="ternary"))
    assert quantize_pack.launches == before + 3


def _random_packed(k: int, n: int, gen: torch.Generator, device) -> torch.Tensor:
    c = torch.randint(0, 3, (k // 4, 4, n), generator=gen, device=device, dtype=torch.uint8)
    return c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)


@pytest.mark.parametrize("m,k,n", [(4, 2048, 2048), (4, 2048, 8192), (4, 8192, 2048),
                                   (128, 2048, 2048), (128, 2048, 8192), (128, 8192, 2048),
                                   (5, 256, 131), (33, 64, 70), (17, 4, 1), (1, 8, 4),
                                   (3, 36, 130), (1, 2048, 2048), (16, 1024, 260),
                                   (8, 2048, 2048), (16, 2048, 2048)])
def test_ternary_matmul_matches_plain(cuda_device, m, k, n):
    """fp32 with TF32 off; rtol and atol 1e-4 cover the summation order.
    The tensor-core kernel also agrees with its own arithmetic in plain
    PyTorch (the exact bf16 split) to the same limit."""
    gen = torch.Generator(cuda_device).manual_seed(m + k + n)
    x = torch.randn(m, k, generator=gen, device=cuda_device)
    packed = _random_packed(k, n, gen, cuda_device)
    wq = torch.tensor(0.37, device=cuda_device)
    before = ternary_matmul.launches
    y = ternary_matmul(x, packed, wq)
    assert ternary_matmul.launches == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(y, ternary_matmul_plain(x, packed, wq), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(y, ternary_matmul_split(x, packed, wq), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m,k,n", [(4, 2048, 2048), (4, 8192, 2048), (128, 2048, 8192),
                                   (128, 8192, 2048), (1, 2048, 2048), (8, 2048, 2048),
                                   (16, 2048, 2048), (33, 64, 70), (40, 1024, 260), (3, 36, 130)])
def test_ternary_matmul_exact_on_one_hot_weights(cuda_device, m, k, n):
    """One nonzero code (±1 at a random k) per column: every output is one
    exact product ±x[i, k_n] · w_q, so any summation order gives it and the
    kernel equals its plain version and its bf16 split bit for bit. A lost
    part of the split (lo is about 2^-17 of x) or a misplaced k fails."""
    gen = torch.Generator(cuda_device).manual_seed(7 * m + n)
    x = torch.randn(m, k, generator=gen, device=cuda_device)
    codes = torch.ones(k, n, dtype=torch.uint8, device=cuda_device)
    at = torch.randint(0, k, (n,), generator=gen, device=cuda_device)
    codes[at, torch.arange(n, device=cuda_device)] = 2 * torch.randint(
        0, 2, (n,), generator=gen, device=cuda_device, dtype=torch.uint8)
    c = codes.reshape(k // 4, 4, n)
    packed = c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)
    wq = torch.tensor(0.37, device=cuda_device)
    y = ternary_matmul(x, packed, wq)
    torch.cuda.synchronize()
    assert torch.equal(y, ternary_matmul_plain(x, packed, wq))
    assert torch.equal(y, ternary_matmul_split(x, packed, wq))


@pytest.mark.parametrize("m,k,n", [(4, 2048, 2048), (128, 8192, 2048), (3, 36, 130)])
def test_ternary_matmul_in_a_cuda_graph(cuda_device, m, k, n):
    """Captured into a CUDA graph and replayed on new inputs, the kernel
    gives what an eager launch gives."""
    gen = torch.Generator(cuda_device).manual_seed(m * n)
    x = torch.randn(m, k, generator=gen, device=cuda_device)
    packed = _random_packed(k, n, gen, cuda_device)
    wq = torch.tensor(0.21, device=cuda_device)
    ternary_matmul(x, packed, wq)                 # warm-up outside the capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = ternary_matmul(x, packed, wq)
    for _ in range(2):
        x.copy_(torch.randn(m, k, generator=gen, device=cuda_device))
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, ternary_matmul(x, packed, wq))
        torch.testing.assert_close(y, ternary_matmul_plain(x, packed, wq), rtol=1e-4, atol=1e-4)


def test_ternary_matmul_rejects_what_it_cannot_take(cuda_device):
    """bf16 x is taken and returns bf16 equal to the plain version (all
    weights zero here, so every product is exact); a mismatched K and a
    packed tensor on another device are refused."""
    x = torch.randn(4, 64, device=cuda_device)
    packed = torch.zeros(16, 8, dtype=torch.uint8, device=cuda_device)
    wq = torch.tensor(1.0, device=cuda_device)
    xb = x.to(torch.bfloat16)
    y = ternary_matmul(xb, packed, wq)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, ternary_matmul_plain(xb, packed, wq))
    with pytest.raises(ValueError):
        ternary_matmul(x[:, :32], packed, wq)
    with pytest.raises(ValueError):
        ternary_matmul(x, packed.cpu(), wq)


def _bf16_ulp(y: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place of |y| (8 significant bits)."""
    m = y.abs().float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(m)) - 7)


def _bf16_allowed(y, y_ref, x, packed, wq) -> torch.Tensor:
    """Per output: one bf16 ulp of the larger result, plus four fp32 ulps
    of Σ|x·w|·w_q, the fp32 summation-order allowance of two sums of the
    same exact products, which matters only where the sum cancels to far
    below its terms (an output of 4e-5 from terms of 400 differs by 7e-7
    between two fp32 orders, three bf16 ulps of the output)."""
    from repro_torch.kernels.pack2bit import unpack2bit_plain

    terms = (x.float().abs() @ unpack2bit_plain(packed, torch.float32).abs()) * wq.float().abs()
    return _bf16_ulp(torch.maximum(y.float().abs(), y_ref.float().abs())) + 2.0 ** -22 * terms


@pytest.mark.parametrize("m,k,n", [(4, 2048, 2048), (4, 8192, 2048), (16, 2048, 2048),
                                   (128, 2048, 8192), (3, 36, 130), (33, 64, 70), (17, 4, 1)])
def test_ternary_matmul_bf16_matches_plain(cuda_device, m, k, n):
    """bf16 x: a bf16 result within one bf16 ulp of the plain version (the
    fp32 sums differ in order only; where a sum cancels, within that
    order's fp32 allowance, ``_bf16_allowed``), bit for bit on one-hot
    weights."""
    gen = torch.Generator(cuda_device).manual_seed(m * 7 + n)
    x = torch.randn(m, k, generator=gen, device=cuda_device).to(torch.bfloat16)
    packed = _random_packed(k, n, gen, cuda_device)
    wq = torch.tensor(0.37, device=cuda_device)
    before = ternary_matmul.launches
    y = ternary_matmul(x, packed, wq)
    assert ternary_matmul.launches == before + 1
    y_ref = ternary_matmul_plain(x, packed, wq)
    assert y.dtype == torch.bfloat16 and y_ref.dtype == torch.bfloat16
    gap = (y.float() - y_ref.float()).abs()
    assert bool((gap <= _bf16_allowed(y, y_ref, x, packed, wq)).all())
    codes = torch.ones((k, n), dtype=torch.uint8, device=cuda_device)
    codes[torch.randint(0, k, (n,), generator=gen, device=cuda_device),
          torch.arange(n, device=cuda_device)] = 2
    c = codes.reshape(k // 4, 4, n)
    onehot = c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)
    assert torch.equal(ternary_matmul(x, onehot, wq), ternary_matmul_plain(x, onehot, wq))


@pytest.mark.parametrize("sizes", [[5], [33001, 4096, 37, 3], [16 * 2048 * 2048 // 16]])
def test_quantize_pack_bf16_segments_match_plain(cuda_device, sizes):
    """bf16 segments in one launch: bytes and counts bit for bit, tile
    sums and scales within fp32 order (rtol 1e-6)."""
    gen = torch.Generator(cuda_device).manual_seed(len(sizes))
    segs = [torch.randn(s, generator=gen, device=cuda_device).to(torch.bfloat16)
            for s in sizes]
    scal = torch.cat([leaf_scalars(s, FTTQConfig())[0][None] for s in segs])
    before = quantize_pack.launches
    packed, moments, scales = quantize_pack_segments(segs, scal, with_scales=True)
    assert quantize_pack.launches == before + 1
    p_ref, m_ref, s_ref = quantize_pack_segments_plain(segs, scal, True)
    assert torch.equal(packed, p_ref)
    assert torch.equal(moments[:, 1], m_ref[:, 1])
    torch.testing.assert_close(moments[:, 0], m_ref[:, 0], rtol=1e-6, atol=0)
    torch.testing.assert_close(scales, s_ref, rtol=1e-6, atol=0)


def test_bf16_tree_encodes_through_the_bf16_kernel(cuda_device):
    """A bf16 tree's card encode: one quantize_pack launch for its bf16
    group, the wire bytes of the CPU encode, w_q cast back to bf16."""
    params = tree_map(lambda t: t.to(torch.bfloat16), init_resnet_cifar(seed=1, device="cpu"))
    fcfg = FTTQConfig()
    card = tree_map(lambda t: t.to(cuda_device), params)
    before = quantize_pack.launches
    enc_card = server_requantize(card, fcfg)
    assert quantize_pack.launches == before + 1
    enc_cpu = server_requantize(params, fcfg)
    card_leaves = [leaf for _, leaf in flatten_with_path(
        enc_card, is_leaf=lambda x: isinstance(x, TernaryTensor))]
    cpu_leaves = [leaf for _, leaf in flatten_with_path(
        enc_cpu, is_leaf=lambda x: isinstance(x, TernaryTensor))]
    n_ternary = 0
    for a, b in zip(card_leaves, cpu_leaves):
        if isinstance(a, TernaryTensor):
            n_ternary += 1
            assert torch.equal(a.packed, b.packed)
            assert a.w_q.dtype == torch.bfloat16
            torch.testing.assert_close(a.w_q.float(), b.w_q.float(), rtol=1e-2, atol=0)
    assert n_ternary > 0


def _random_stack(c: int, rows: int, gen: torch.Generator, device) -> torch.Tensor:
    codes = torch.randint(0, 3, (c, rows * LANES, 4), generator=gen, device=device,
                          dtype=torch.uint8)
    packed = (codes[..., 0] | (codes[..., 1] << 2) | (codes[..., 2] << 4)
              | (codes[..., 3] << 6))
    return packed.reshape(c, rows, LANES)


@pytest.mark.parametrize("c,rows,n_pad", [(1, 32, 0), (2, 32, 1), (4, 32, 2), (16, 32, 6),
                                          (16, 4096, 0), (16, 131072, 3)])
def test_aggregate_bit_identical_to_plain(cuda_device, c, rows, n_pad):
    """ResNet18*'s segments pad to 32 rows of 128 bytes; the last case is
    16 clients × 2^26 elements. Zero-coefficient rows hold garbage bytes."""
    gen = torch.Generator(cuda_device).manual_seed(c * rows)
    stacked = _random_stack(c, rows, gen, cuda_device)
    coeffs = torch.randn(c, generator=gen, device=cuda_device)
    if n_pad:
        coeffs[c - n_pad:] = 0.0
        stacked[c - n_pad:] = 0xFF
    before = packed_weighted_sum.launches
    out = packed_weighted_sum(stacked, coeffs)
    assert packed_weighted_sum.launches == before + 1
    ref = packed_weighted_sum_plain(stacked, coeffs)
    torch.cuda.synchronize()
    assert out.shape == (4 * rows * LANES,)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


def test_aggregator_on_the_card_equals_the_cpu(cuda_device):
    """ResNet18* (width 16) uploads folded by the kernel equal the plain
    version's fold bit for bit."""
    cfg = FTTQConfig()
    blobs = []
    for seed in range(5):
        params = init_resnet_cifar(seed=seed, width=16, device="cpu")
        blobs.append(encode_update(client_update_payload(params, init_wq_tree(params, cfg), cfg)))
    outs = []
    for dev in ("cpu", cuda_device):
        agg = Aggregator(chunk_c=4, device=dev)
        for i, blob in enumerate(blobs):
            agg.add(blob, 100 + i)
        outs.append(flatten_with_path(agg.finalize()))
    for (pa, a), (pb, b) in zip(*outs):
        assert pa == pb
        assert torch.equal(a, b.cpu()), pa


def test_aggregate_rejects_what_it_cannot_take(cuda_device):
    stacked = torch.zeros(2, 32, LANES, dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        packed_weighted_sum(stacked, torch.ones(2, device=cuda_device, dtype=torch.float64))
    with pytest.raises(ValueError):
        packed_weighted_sum(stacked, torch.ones(3, device=cuda_device))
    with pytest.raises(ValueError):
        packed_weighted_sum(stacked, torch.ones(2))


@pytest.mark.parametrize("c,rows,n_pad", [(1, 32, 0), (2, 32, 1), (4, 32, 2), (16, 32, 6),
                                          (16, 4096, 0), (16, 131072, 3)])
def test_vote_bit_identical_to_plain(cuda_device, c, rows, n_pad):
    """Both masses bit for bit; zero-coefficient rows hold 0xFF bytes (code
    3). The last case is 16 clients × 2^26 elements."""
    gen = torch.Generator(cuda_device).manual_seed(c * rows + 1)
    stacked = _random_stack(c, rows, gen, cuda_device)
    coeffs = torch.rand(c, generator=gen, device=cuda_device) * 3.0
    if n_pad:
        coeffs[c - n_pad:] = 0.0
        stacked[c - n_pad:] = 0xFF
    before = packed_vote_counts.launches
    out = packed_vote_counts(stacked, coeffs)
    assert packed_vote_counts.launches == before + 1
    ref = packed_vote_counts_plain(stacked, coeffs)
    torch.cuda.synchronize()
    assert out.shape == (2, 4 * rows * LANES)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("rule", ["majority", "median", "trimmed_mean"])
def test_robust_aggregator_on_the_card_equals_the_cpu(cuda_device, rule):
    """ResNet18* (width 16) uploads under each robust rule: the card's fold
    equals the plain fold bit for bit (5 clients at chunk_c=4)."""
    cfg = FTTQConfig()
    blobs = []
    for seed in range(5):
        params = init_resnet_cifar(seed=seed, width=16, device="cpu")
        blobs.append(encode_update(client_update_payload(params, init_wq_tree(params, cfg), cfg)))
    outs = []
    for dev in ("cpu", cuda_device):
        agg = Aggregator(chunk_c=4, device=dev, rule=rule)
        for i, blob in enumerate(blobs):
            agg.add(blob, 100 + 7 * i)
        outs.append(flatten_with_path(agg.finalize()))
    for (pa, a), (pb, b) in zip(*outs):
        assert pa == pb
        assert torch.equal(a, b.cpu()), pa


# (bytes, elements) per segment: segments of 1, 3, 37 and 144 bytes (ragged
# element counts) and one of 5 blocks; ResNet18*'s 52 segments of a round.
SEGMENT_LAYOUTS = {
    "ragged": [(1, 3), (3, 9), (37, 147), (144, 576), (5000, 19999), (2, 8)],
    "resnet52": [(144, 576)] * 3 + [(3072, 12288)] * 48 + [(160, 640)],
}


def _segment_case(layout: str, c: int, dev, seed: int):
    """A staged buffer of random bytes (every code, garbage in the aligned
    gaps), a (C, S) coefficient matrix with negative entries and (C,)
    weights, on the card."""
    nb, n_out = zip(*SEGMENT_LAYOUTS[layout])
    table = fanin_table(nb, n_out, dev)
    gen = torch.Generator(dev).manual_seed(seed)
    staged = torch.randint(0, 256, (c, table.row_bytes), generator=gen, device=dev,
                           dtype=torch.uint8)
    coeffs = torch.randn(c, table.n_segments, generator=gen, device=dev)
    weights = torch.rand(c, generator=gen, device=dev) * 3.0
    return table, staged, coeffs, weights


@pytest.mark.parametrize("layout,c", [("ragged", 1), ("ragged", 3), ("ragged", 17),
                                      ("ragged", 9), ("resnet52", 10), ("resnet52", 16)])
def test_segment_kernels_bit_identical_to_plain(cuda_device, layout, c):
    """One launch of each segment kernel over a whole layout equals its
    plain version bit for bit over the whole flat output, slot tails
    included (C = 9 and 17 run the 8-deep client unroll and its rest)."""
    table, staged, coeffs, weights = _segment_case(layout, c, cuda_device, 31 * c)
    before = (packed_weighted_sum.launches, packed_vote_counts.launches)
    out = packed_weighted_sum_segments(staged, coeffs, table)
    votes = packed_vote_counts_segments(staged, weights, table)
    assert (packed_weighted_sum.launches, packed_vote_counts.launches) == (before[0] + 1,
                                                                           before[1] + 1)
    ref = packed_weighted_sum_segments_plain(staged, coeffs, table)
    ref_votes = packed_vote_counts_segments_plain(staged, weights, table)
    torch.cuda.synchronize()
    assert out.shape == (table.n_total,) and votes.shape == (2, table.n_total)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(votes.view(torch.int32), ref_votes.view(torch.int32))


@pytest.mark.parametrize("bad", [float("inf"), float("nan")])
def test_vote_with_a_non_finite_weight_equals_plain(cuda_device, bad):
    """A non-finite weight makes w · 0 NaN: the kernel then keeps the
    multiply-add for every client (the finite path skips zero indicators)
    and still equals its plain version bit for bit."""
    table, staged, _, weights = _segment_case("ragged", 9, cuda_device, 5)
    weights[4] = bad
    out = packed_vote_counts_segments(staged, weights, table)
    ref = packed_vote_counts_segments_plain(staged, weights, table)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


def test_segment_kernels_reject_what_they_cannot_take(cuda_device):
    table, staged, coeffs, weights = _segment_case("ragged", 2, cuda_device, 0)
    with pytest.raises(ValueError):
        packed_weighted_sum_segments(staged, coeffs.double(), table)
    with pytest.raises(ValueError):
        packed_weighted_sum_segments(staged, coeffs[:, :-1].contiguous(), table)
    with pytest.raises(ValueError):
        packed_vote_counts_segments(staged, weights.cpu(), table)
    with pytest.raises(ValueError):
        packed_vote_counts_segments(staged, weights, fanin_table([4], [16]))
    cpu_table = fanin_table([nb for nb, _ in SEGMENT_LAYOUTS["ragged"]],
                            [n for _, n in SEGMENT_LAYOUTS["ragged"]])
    with pytest.raises(ValueError):
        packed_weighted_sum_segments(staged, coeffs, cpu_table)


def _resnet_blobs(n: int) -> list:
    cfg = FTTQConfig()
    blobs = []
    for seed in range(n):
        params = init_resnet_cifar(seed=seed % 6, width=16, device="cpu")
        blobs.append(encode_update(client_update_payload(params, init_wq_tree(params, cfg), cfg)))
    return blobs


@pytest.mark.parametrize("rule", ["mean", "majority"])
def test_aggregator_launches_once_per_flush(cuda_device, rule):
    """10 ResNet18* (width 16) uploads at chunk_c=16 are one flush: one
    launch of the rule's kernel for all 52 segments, none of the other."""
    blobs = _resnet_blobs(10)
    agg = Aggregator(chunk_c=16, device=cuda_device, rule=rule)
    before = (packed_weighted_sum.launches, packed_vote_counts.launches)
    for i, blob in enumerate(blobs):
        agg.add(blob, 100 + i)
    agg.finalize()
    torch.cuda.synchronize()
    launched = (packed_weighted_sum.launches - before[0], packed_vote_counts.launches - before[1])
    assert agg._table.n_segments == 52
    assert launched == ((1, 0) if rule == "mean" else (0, 1))


@pytest.mark.parametrize("rule", ["mean", "majority"])
def test_aggregator_five_flushes_equal_the_cpu(cuda_device, rule):
    """17 uploads at chunk_c=4: five flushes through one pinned staging
    buffer (refilled after each copy's event), five launches, and the fold
    equals the CPU plain fold bit for bit."""
    blobs = _resnet_blobs(17)
    outs = []
    for dev in ("cpu", cuda_device):
        agg = Aggregator(chunk_c=4, device=dev, rule=rule)
        counter = packed_weighted_sum if rule == "mean" else packed_vote_counts
        before = counter.launches
        for i, blob in enumerate(blobs):
            agg.add(blob, 100 + 7 * i)
        outs.append(flatten_with_path(agg.finalize()))
        if dev != "cpu":
            assert counter.launches - before == 5
            assert agg._staging.is_pinned()
    for (pa, a), (pb, b) in zip(*outs):
        assert pa == pb
        assert torch.equal(a, b.cpu()), pa


def _dyadic_blobs(n: int, raw_at: tuple = ()) -> list:
    """Uploads whose every product and sum is exact in fp32: ternary leaves
    with power-of-two scales (one flat, one stacked with a scale per layer)
    and integer-valued raw leaves; the clients in ``raw_at`` ship every
    leaf raw (a mixed-codec upload)."""
    gen = torch.Generator().manual_seed(11)
    blobs = []
    for i in range(n):
        flat = torch.randint(0, 3, (16, 12), generator=gen, dtype=torch.int8) - 1
        stack = torch.randint(0, 3, (3, 8, 12), generator=gen, dtype=torch.int8) - 1
        w_flat = torch.tensor(2.0 ** -(i % 3))
        w_stack = (2.0 ** -torch.randint(0, 4, (3, 1, 1), generator=gen)).float()
        bias = torch.randint(-8, 9, (12,), generator=gen).float()
        if i in raw_at:
            tree = {"a": {"w": flat.float() * w_flat}, "b": {"w": stack.float() * w_stack},
                    "bias": bias}
        else:
            tree = {"a": {"w": encode_ternary(flat, w_flat)},
                    "b": {"w": encode_ternary(stack, w_stack)}, "bias": bias}
        blobs.append(encode_update(tree))
    return blobs


@pytest.mark.parametrize("rule,blobs_of", [("mean", "resnet"), ("majority", "resnet"),
                                           ("mean", "mixed")])
def test_long_lived_aggregator_equals_fresh_ones(cuda_device, rule, blobs_of):
    """One CUDA aggregator over three finalize(reset=True) mixes, as the
    async server keeps it, equals a fresh CUDA aggregator per mix and the
    CPU fold, bit for bit. The mixes have 3, 5 and 2 uploads at chunk_c=2
    (flushes refill the pinned buffer across mixes); no later mix starts
    with the upload that planned the table, and in the mixed case the
    second mix starts with a raw upload whose leaves the table planned as
    fused, while its fresh aggregator plans them raw."""
    if blobs_of == "resnet":
        blobs = _resnet_blobs(10)
        weights = [100 + 7 * i for i in range(10)]
    else:
        blobs = _dyadic_blobs(10, raw_at=(3, 8))
        weights = [1 + i % 4 for i in range(10)]
    mixes = [[0, 1, 2], [3, 4, 5, 6, 7], [8, 9]]
    counter = packed_weighted_sum if rule == "mean" else packed_vote_counts
    kept = Aggregator(chunk_c=2, device=cuda_device, rule=rule)
    for mix in mixes:
        before = counter.launches
        for i in mix:
            kept.add(blobs[i], weights[i])
        got = kept.finalize(reset=True)
        torch.cuda.synchronize()
        assert counter.launches - before == -(-len(mix) // 2)
        assert kept.n_clients == 0
        for dev in (cuda_device, "cpu"):
            fresh = Aggregator(chunk_c=2, device=dev, rule=rule)
            for i in mix:
                fresh.add(blobs[i], weights[i])
            want = flatten_with_path(fresh.finalize())
            for (pa, a), (pb, b) in zip(flatten_with_path(got), want):
                assert pa == pb
                assert a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu()), (mix, dev, pa)
    assert kept._staging.is_pinned()


def _assert_same_records(got: bytes, want: bytes, scale_rtol: float) -> None:
    """Two wire blobs hold the same records: raw payloads and ternary codes
    bit for bit, each ternary scale within ``scale_rtol``."""
    got_pairs, want_pairs = decode_update_leaves(got), decode_update_leaves(want)
    assert [p for p, _ in got_pairs] == [p for p, _ in want_pairs]
    for (path, a), (_, b) in zip(got_pairs, want_pairs):
        assert type(a) is type(b), path
        if isinstance(a, TernaryTensor):
            assert a.shape == b.shape and a.dtype == b.dtype, path
            assert torch.equal(a.packed, b.packed), path
            torch.testing.assert_close(a.w_q, b.w_q, rtol=scale_rtol, atol=0)
        else:
            assert torch.equal(a, b), path


@pytest.mark.parametrize("requantize", [True, False])
def test_edge_tier_on_the_card_equals_the_cpu(cuda_device, requantize, monkeypatch):
    """A 3-edge tier over two folds of ResNet18* (width 16) uploads against
    the CPU tier. Lossless: the upstream blobs byte for byte and the folds
    bit for bit. Requantizing: the edge means are bit-identical, so the
    upstream codes are too; each scale comes from tile moments that the
    card sums in another order than the plain version, so it is held to
    the encode's rtol 1e-6, and the card's root fold of its own blobs
    equals the CPU fold of those blobs bit for bit. Per fold one
    quantize_pack launch per requantizing edge, one aggregate launch per
    edge, and one at the root when its records are ternary (a lossless root
    folds raw records without a kernel)."""
    blobs = _resnet_blobs(12)
    shipped = []

    def recording_encode(tree):
        shipped.append(encode_update(tree))
        return shipped[-1]

    monkeypatch.setattr(hierarchy, "encode_update", recording_encode)
    tiers = {dev: EdgeTier(HierarchyConfig(n_edges=3, requantize_at_edge=requantize),
                           FTTQConfig(), 12, device=dev) for dev in ("cpu", cuda_device)}
    for fold in range(2):
        clients = range(fold * 6, fold * 6 + 6)
        outs = {}
        for dev, tier in tiers.items():
            for k in clients:
                tier.add(k, blobs[k], 100 + k, staleness=float(fold))
            before = (quantize_pack.launches, packed_weighted_sum.launches)
            shipped.clear()
            mean, info = tier.fold()
            torch.cuda.synchronize()
            outs[dev] = (flatten_with_path(mean), list(shipped), info,
                         (quantize_pack.launches - before[0],
                          packed_weighted_sum.launches - before[1]))
        (want, want_blobs, want_info, _), (got, got_blobs, got_info, launched) = (
            outs["cpu"], outs[cuda_device])
        assert got_info == want_info and got_info["edges_active"] == 3
        assert len(got_blobs) == len(want_blobs) == 3
        assert launched == ((3, 4) if requantize else (0, 3))
        if requantize:
            root = Aggregator(chunk_c=16, device="cpu")
            for e, blob in enumerate(got_blobs):
                _assert_same_records(blob, want_blobs[e], scale_rtol=1e-6)
                weight = 0.0
                for k in clients:
                    if k % 3 == e:
                        weight += float(100 + k)
                root.add(blob, weight)
            want = flatten_with_path(root.finalize())
        else:
            assert got_blobs == want_blobs
        for (pa, a), (pb, b) in zip(got, want):
            assert pa == pb
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b), (fold, pa)
    assert tiers["cpu"].telemetry() == tiers[cuda_device].telemetry()
    assert tiers[cuda_device].telemetry()["ledger_balanced"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,offset", [((2048, 2048), 0), ((100, 260), 0), ((4097,), 1),
                                          ((7,), 0)])
def test_ternary_quantize_matches_plain(cuda_device, dtype, shape, offset):
    """Codes and θ_t bit for bit in fp32 and bf16; an odd length and a view
    off a 16-byte boundary take the scalar path."""
    gen = torch.Generator(cuda_device).manual_seed(sum(shape))
    n = 1
    for s in shape:
        n *= s
    base = torch.randn(n + offset, generator=gen, device=cuda_device).to(dtype)
    theta = base[offset:].reshape(shape)
    _, _, wq = ops.fttq_apply(theta, 0.7)
    absw = theta.float().abs()
    inv = 1.0 / (absw.max() + 1e-8)
    delta = 0.7 * absw.mean() * inv
    before = ternary_quantize.launches
    it, tt = ternary_quantize(theta, inv, delta, wq)
    assert ternary_quantize.launches == before + 1
    it_ref, tt_ref = ternary_quantize_plain(theta, inv, delta, wq)
    torch.cuda.synchronize()
    assert it.dtype == torch.int8 and tt.dtype == dtype and tt.shape == shape
    assert torch.equal(it, it_ref)
    assert torch.equal(tt.view(torch.uint8), tt_ref.view(torch.uint8))


@pytest.mark.parametrize("k,n", [(8192, 2048), (512, 256), (1024, 130), (260, 64), (4, 1)])
def test_pack_unpack_match_plain(cuda_device, k, n):
    """pack2bit and unpack2bit (int8, fp32, bf16, fp16) bit for bit; the
    round trip is exact; N % 4 ≠ 0 takes the one-column path."""
    gen = torch.Generator(cuda_device).manual_seed(k + n)
    it = torch.randint(-1, 2, (k, n), generator=gen, device=cuda_device, dtype=torch.int8)
    before = (pack2bit.launches, unpack2bit.launches)
    packed = pack2bit(it)
    assert torch.equal(packed, pack2bit_plain(it))
    for dtype in (torch.int8, torch.float32, torch.bfloat16, torch.float16):
        assert torch.equal(unpack2bit(packed, dtype), unpack2bit_plain(packed, dtype)), dtype
    assert torch.equal(unpack2bit(packed), it)
    assert (pack2bit.launches, unpack2bit.launches) == (before[0] + 1, before[1] + 5)


def test_ops_kernels_reject_what_they_cannot_take(cuda_device):
    with pytest.raises(TypeError):
        ternary_quantize(torch.zeros(8, device=cuda_device, dtype=torch.float16), 1.0, 0.1, 0.2)
    with pytest.raises(ValueError):
        ternary_quantize(torch.zeros(8, 8, device=cuda_device).t(), 1.0, 0.1, 0.2)
    with pytest.raises(TypeError):
        pack2bit(torch.zeros(8, 4, device=cuda_device))
    with pytest.raises(TypeError):
        unpack2bit(torch.zeros(2, 4, dtype=torch.uint8, device=cuda_device), torch.int32)
    with pytest.raises(ValueError):
        packed_vote_counts(torch.zeros(2, 32, LANES, dtype=torch.uint8, device=cuda_device),
                           torch.ones(2))


# --------------------------------------------------------------------------
# The codec registry, the controller and mixed-codec folds on the card.
# --------------------------------------------------------------------------


def _codec_tree(device) -> dict:
    """A weight with top-k ties (zeros, −0.0, repeated magnitudes), a bias
    and a norm scale, from a seeded CPU generator."""
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(96, 48, generator=gen)
    w[0, :6], w[1, :4], w[2, :3], w[3, :3] = 0.0, -0.0, 0.5, -0.5
    tree = {"layer": {"w": w, "bias": 0.1 * torch.randn(48, generator=gen)},
            "norm_scale": torch.arange(8.0) / 8.0}
    return {"layer": {k: v.to(device) for k, v in tree["layer"].items()},
            "norm_scale": tree["norm_scale"].to(device)}


@pytest.mark.parametrize("kind", ["fp16", "bf16", "topk", "topk16"])
def test_codec_on_the_card_equals_the_cpu(cuda_device, kind):
    """Three error-feedback encodes on the card and on the CPU: the same
    wire bytes and bit-identical residuals, top-k ties included."""
    from repro_torch.core.compression import CodecSpec, compress_pytree

    spec = CodecSpec(kind=kind, residual="fp16" if kind != "fp16" else "topk",
                     topk_fraction=0.1, error_feedback=True)
    trees = {dev: _codec_tree(dev) for dev in ("cpu", cuda_device)}
    res = {dev: None for dev in trees}
    for step in range(3):
        blobs = {}
        for dev, tree in trees.items():
            wire, res[dev] = compress_pytree(tree, spec, residual=res[dev])
            blobs[dev] = encode_update(wire)
        assert blobs["cpu"] == blobs[cuda_device], (kind, step)
        for (pa, a), (_, b) in zip(flatten_with_path(res["cpu"]),
                                   flatten_with_path(res[cuda_device])):
            assert b.device.type == "cuda" and torch.equal(a, b.cpu()), (kind, step, pa)


def test_narrow_on_the_card_writes_the_cpu_bits(cuda_device):
    """fp16 and bf16 downcasts at subnormals, overflow, ties and on NaNs
    with payloads and signs: the card writes the CPU's (XLA's) bits."""
    from repro_torch.core.compression import narrow

    vals = torch.tensor([6e-8, -6e-8, 6.1e-5, 3e-8, 65504.0, 65519.99, 65520.0, -65520.0,
                         1e-40, 0.0, -0.0, float("inf"), float("-inf"), 1.0 + 2 ** -8,
                         1.0 + 3 * 2 ** -8, 1.0 + 2 ** -11, 3.0e38])
    nans = torch.tensor([0x7FC00000, -0x00400000, 0x7F800001, 0x7FA00000, -0x005FFFFF],
                        dtype=torch.int32).view(torch.float32)
    x = torch.cat([vals, nans, torch.randn(100_000, generator=torch.Generator().manual_seed(1))])
    for dtype in (torch.float16, torch.bfloat16):
        want = narrow(x, dtype).view(torch.int16)
        got = narrow(x.to(cuda_device), dtype).view(torch.int16).cpu()
        assert torch.equal(got, want), dtype


def _controller_run(device, mode: str):
    from repro_torch.data.federated import partition_iid
    from repro_torch.data.synthetic import synthetic_classification
    from repro_torch.fed import ControllerConfig, FedConfig, run_federated
    from repro_torch.models.paper_models import init_mlp_mnist, mlp_mnist
    from repro_torch.optim import adam

    x, y, _, _ = synthetic_classification(0, 360, 10, 784, noise=3.0, n_test=10)
    cfg = FedConfig(mode=mode, n_clients=6, participation=0.5, local_epochs=1, batch_size=16,
                    rounds=3, seed=3, controller=ControllerConfig(
                        warmup_encodes=1, divergence_high=1e9, slow_factor=0.0))
    return run_federated(mlp_mnist, init_mlp_mnist(seed=1, device=device),
                         partition_iid(x, y, 6), cfg, adam(1e-3), lambda p: (0.0, 0.0),
                         eval_every=3, device=device)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_controller_run_on_the_card_equals_the_cpu(cuda_device, mode):
    """An MLP controller run on the card and on the CPU: the same rungs
    per round, bytes by rung, bytes up and down and simulated times (a
    top-k upload's size depends only on which indices make the cut)."""
    cpu, card = _controller_run("cpu", mode), _controller_run(cuda_device, mode)
    a, b = cpu.telemetry["controller"], card.telemetry["controller"]
    assert b["rung_counts_per_round"] == a["rung_counts_per_round"]
    assert b["bytes_by_kind"] == a["bytes_by_kind"] and "topk16" in b["bytes_by_kind"]
    assert (card.upload_bytes, card.download_bytes) == (cpu.upload_bytes, cpu.download_bytes)
    assert card.round_times == cpu.round_times


@pytest.mark.parametrize("kinds", [("ternary", "topk16", "ternary", "fp16"),
                                   ("topk16", "ternary", "ternary", "bf16")])
def test_mixed_codec_aggregator_on_the_card_equals_the_cpu(cuda_device, kinds):
    """Mixed-codec uploads in both orders (the table planned from a ternary
    or from a top-k upload): the card's fold equals the CPU's bit for bit."""
    from repro_torch.core.compression import CodecSpec, compress_pytree

    blobs = []
    for i, kind in enumerate(kinds):
        tree = init_resnet_cifar(seed=i, width=16, device="cpu")
        wire, _ = compress_pytree(tree, CodecSpec(kind=kind, topk_fraction=0.05))
        blobs.append(encode_update(wire))
    outs = []
    for dev in ("cpu", cuda_device):
        agg = Aggregator(chunk_c=2, device=dev)
        before = packed_weighted_sum.launches
        for i, blob in enumerate(blobs):
            agg.add(blob, 100 + 7 * i)
        outs.append(flatten_with_path(agg.finalize()))
        if dev != "cpu":
            torch.cuda.synchronize()
            assert packed_weighted_sum.launches - before == (2 if kinds[0] == "ternary" else 0)
    for (pa, a), (pb, b) in zip(*outs):
        assert pa == pb
        assert torch.equal(a, b.cpu()), pa


@pytest.mark.parametrize("mode,n_edges", [("sync", 0), ("sync", 8), ("async", 0)])
def test_run_fleet_on_the_card_equals_the_cpu(cuda_device, mode, n_edges, monkeypatch):
    """``run_fleet`` at 10⁴ clients on the MLP, on the card and on the CPU
    fed the card's pool (the same blobs, cohort weights and add order): the
    rounds, participants, drops, times, bytes and telemetry equal; the card
    launches quantize_pack once per pool slot, for the broadcast and per
    requantizing edge, and aggregate once per flat round or fold, or per
    edge and per root flush. Flat and async: the final update bit for bit.
    Tier: each edge's upstream codes bit for bit and its scale within the
    encode's rtol 1e-6, and the card's final update equals the CPU root
    fold of the card's edge records bit for bit."""
    from repro_torch.fed import fleet
    from repro_torch.fed.availability import AvailabilityConfig
    from repro_torch.fed.simulation import FedConfig
    from repro_torch.models.paper_models import init_mlp_mnist

    params = init_mlp_mnist(seed=1, device="cpu")
    cfg = FedConfig(mode=mode, n_clients=10_000, participation=0.05,
                    rounds=3 if mode == "async" else 2, buffer_k=16,
                    availability=AvailabilityConfig(kind="diurnal"),
                    hierarchy=HierarchyConfig(n_edges=n_edges))
    pools, collected = [], []
    plain_pool, plain_collect = fleet._payload_pool, EdgeTier.collect

    def recording_pool(*a, **kw):
        pools.append(plain_pool(*a, **kw))
        return pools[-1]

    def recording_collect(self):
        collected.append((self.device.type, plain_collect(self)))
        return collected[-1][1]

    monkeypatch.setattr(fleet, "_payload_pool", recording_pool)
    monkeypatch.setattr(EdgeTier, "collect", recording_collect)
    before = (quantize_pack.launches, packed_weighted_sum.launches)
    card = fleet.run_fleet(params, cfg, device=cuda_device)
    torch.cuda.synchronize()
    launched = (quantize_pack.launches - before[0], packed_weighted_sum.launches - before[1])
    given = iter(pools)
    monkeypatch.setattr(fleet, "_payload_pool", lambda *a, **kw: next(given))
    cpu = fleet.run_fleet(params, cfg, device="cpu")

    for field in ("rounds_run", "participants_per_round", "dropped_per_round", "round_times",
                  "upload_bytes", "download_bytes", "telemetry"):
        assert getattr(card, field) == getattr(cpu, field), field
    edges = [len(recs) for dev, recs in collected if dev == "cuda"]
    assert launched == (1 + 8 + sum(edges),
                        sum(e + -(-e // 16) for e in edges) if n_edges else cfg.rounds)
    want = cpu.final_update
    if n_edges:
        card_recs = [recs for dev, recs in collected if dev == "cuda"]
        cpu_recs = [recs for dev, recs in collected if dev == "cpu"]
        for got, ref in zip(card_recs, cpu_recs):
            assert [(e, w) for e, _, w in got] == [(e, w) for e, _, w in ref]
            for (_, a, _), (_, b, _) in zip(got, ref):
                _assert_same_records(a, b, scale_rtol=1e-6)
        root = Aggregator(chunk_c=cfg.hierarchy.root_chunk_c, device="cpu")
        for _, blob, w in card_recs[-1]:
            root.add(blob, w)
        want = root.finalize()
    for (pa, a), (pb, b) in zip(flatten_with_path(card.final_update), flatten_with_path(want)):
        assert pa == pb
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b), pa


def test_socket_round_on_the_card_equals_the_card_reference(cuda_device, tmp_path):
    """Four client processes encode on the card (one quantize_pack launch
    each) and the server folds there (one aggregate launch): the hash is the
    in-process card reference's, and the fold of the received blobs on a
    CPU Aggregator is the card's bit for bit."""
    from repro_torch.fed.mp_server import (
        demo_params, params_hash, run_inprocess_reference, run_socket_round,
    )

    params = demo_params(seed=7)
    before = packed_weighted_sum.launches
    res = run_socket_round(params, 4, seed=7, timeout_s=300.0, device=cuda_device,
                           report_dir=str(tmp_path))
    torch.cuda.synchronize()
    assert packed_weighted_sum.launches - before == 1
    assert res.committed == "full" and res.ledger()["balance_ok"]
    ref = run_inprocess_reference(params, 4, seed=7, device=cuda_device)
    assert params_hash(res.params) == params_hash(ref)
    assert sorted(res.client_reports) == [0, 1, 2, 3]
    for rep in res.client_reports.values():
        assert rep["device"] == "cuda" and rep["launches"]["quantize_pack"] == 1
    cpu = Aggregator(chunk_c=16, device="cpu")
    for _, weight, blob in sorted(res.received):
        cpu.add(blob, weight=weight)
    for (pa, a), (pb, b) in zip(flatten_with_path(res.params),
                                flatten_with_path(cpu.finalize())):
        assert pa == pb and torch.equal(a.cpu(), b), pa


def test_socket_round_raises_where_no_card_is_present(monkeypatch):
    """Asked for the card where none is present, the socket tier raises
    before it binds a socket or starts a client."""
    from repro_torch.fed.mp_server import demo_params, run_inprocess_reference, run_socket_round

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_socket_round(demo_params(), 2, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_inprocess_reference(demo_params(), 2, device="cuda")


# --------------------------------------------------------------------------
# The model zoo and the serve loop on the card.
# --------------------------------------------------------------------------


def _to(tree, device):
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.to(device), tree)


def test_demo_serve_engine_on_the_card_equals_the_cpu(cuda_device):
    """The same weights served by a card engine and a CPU engine: the same
    artifact sizes, logits within 1e-5 and the same cache counters."""
    from repro_torch.launch.serve_loop import ServeEngine, demo_model

    cfg, params = demo_model(device="cpu")
    cpu = ServeEngine(cfg, params, max_batch=4, device="cpu")
    before = ternary_matmul.launches
    card = ServeEngine(cfg, _to(params, cuda_device), max_batch=4, device=cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (3, 6),
                         generator=torch.Generator().manual_seed(2))
    for b in (3, 1, 2):
        got = card.forward(toks[:b])
        want = cpu.forward(toks[:b])
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    assert ternary_matmul.launches - before == 3 * cfg.n_layers * 7
    assert card.stats() == cpu.stats()


@pytest.mark.parametrize("sk,window,causal", [(2100, 1 << 30, True), (2100, 1 << 30, False),
                                              (2100, 1024, True), (3072, 1 << 30, True)])
def test_flash_equals_naive_on_the_card(cuda_device, sk, window, causal):
    from repro_torch.models.attention import _attend_flash, _attend_naive

    gen = torch.Generator(cuda_device).manual_seed(sk)
    q = torch.randn(1, sk, 2, 4, 64, generator=gen, device=cuda_device)
    k = torch.randn(1, sk, 2, 64, generator=gen, device=cuda_device)
    v = torch.randn(1, sk, 2, 64, generator=gen, device=cuda_device)
    pos = torch.arange(sk, device=cuda_device)
    kw = dict(causal=causal, window=window)
    got = _attend_flash(q, k, v, pos, pos, **kw)
    want = _attend_naive(q, k, v, pos, pos, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_moe_and_mamba_on_the_card_equal_the_cpu(cuda_device):
    from repro_torch.models.mamba2 import init_mamba, mamba_block
    from repro_torch.models.moe import init_moe, moe

    gen = torch.Generator().manual_seed(0)
    mp = init_moe(gen, 64, 32, 16, 2, 64, torch.float32)
    x = torch.randn(2, 24, 64, generator=gen)
    for top_k, cf in ((4, 1.25), (2, 0.5)):
        want, waux = moe(mp, x, top_k=top_k, capacity_factor=cf)
        got, aux = moe(_to(mp, cuda_device), x.to(cuda_device), top_k=top_k,
                       capacity_factor=cf)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
        assert abs(float(aux) - float(waux)) <= 1e-6
    bp = init_mamba(gen, 64, 8, 16, 2, 4, torch.float32)
    xm = torch.randn(2, 37, 64, generator=gen)
    kw = dict(n_heads=8, d_state=16, expand=2, conv_width=4, chunk=16)
    want, wc = mamba_block(bp, xm, **kw)
    got, c = mamba_block(_to(bp, cuda_device), xm.to(cuda_device), **kw)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(c["ssd"].cpu(), wc["ssd"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["gemma3-4b", "llama-3.2-vision-11b"])
def test_packed_zoo_deploy_on_the_card_equals_the_cpu(cuda_device, arch):
    """A reduced gemma3 (sliding windows) and vlm (cross-attention, gates at
    0.5) deployed packed on the card: the CPU deploy's codes, framing and
    byte count exactly, its scales within rtol 1e-6 (the card sums tile
    moments in another order), its logits within 1e-4 of max |logits|."""
    from repro_torch.comm.wire import decode_update
    from repro_torch.configs import get_reduced
    from repro_torch.core.compression import CodecSpec, compress_pytree, is_wire_leaf
    from repro_torch.launch.serve import ternary_deploy
    from repro_torch.models.frontends import synth_vision_patches
    from repro_torch.models.transformer import forward, init_params

    cfg = get_reduced(arch)
    params = init_params(cfg, seed=0, device="cpu")
    if cfg.family == "vlm":
        params["cross"]["gate_attn"].fill_(0.5)
        params["cross"]["gate_mlp"].fill_(0.5)
    spec = CodecSpec(kind="ternary", residual="fp16", fttq=FTTQConfig())
    blobs = {}
    for name, dev in (("cpu", "cpu"), ("card", cuda_device)):
        wire, _ = compress_pytree(_to(params, dev), spec)
        blobs[name] = encode_update(wire)
    assert len(blobs["card"]) == len(blobs["cpu"])
    card_leaves = flatten_with_path(decode_update(blobs["card"]), is_leaf=is_wire_leaf)
    cpu_leaves = flatten_with_path(decode_update(blobs["cpu"]), is_leaf=is_wire_leaf)
    n_ternary = 0
    for (pa, a), (pb, b) in zip(card_leaves, cpu_leaves):
        assert pa == pb and type(a) is type(b), pa
        if isinstance(a, TernaryTensor):
            n_ternary += 1
            assert torch.equal(a.packed.cpu(), b.packed.cpu()), pa
            torch.testing.assert_close(a.w_q.cpu(), b.w_q.cpu(), rtol=1e-6, atol=0)
        else:
            assert torch.equal(a.data.cpu(), b.data.cpu()), pa
    assert n_ternary == (7 if cfg.family == "dense" else 14)
    vis = (synth_vision_patches(torch.Generator().manual_seed(2), 2, cfg.n_patches,
                                cfg.d_model) if cfg.family == "vlm" else None)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1))
    served_cpu, n_cpu, _, _ = ternary_deploy(params, FTTQConfig(), packed=True,
                                             residual="fp16", device="cpu")
    served, n_card, _, _ = ternary_deploy(_to(params, cuda_device), FTTQConfig(), packed=True,
                                          residual="fp16", device=cuda_device)
    assert n_card == n_cpu == len(blobs["cpu"])
    want, _, _ = forward(cfg, served_cpu, toks, vision_embeds=vis)
    got, _, _ = forward(cfg, served, toks.to(cuda_device),
                        vision_embeds=None if vis is None else vis.to(cuda_device))
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(want.abs().max())


# --------------------------------------------------------------------------
# Training on the card (repro_torch.train).
# --------------------------------------------------------------------------


def _train_step_both(arch: str, dev, micro: int):
    from repro_torch.configs import get_reduced
    from repro_torch.optim import adam
    from repro_torch.train import TrainerConfig, init_train_state, make_train_step
    from repro_torch.train.fault import elastic_reshard

    cfg = get_reduced(arch)
    tcfg = TrainerConfig(microbatches=micro)
    opt = adam(3e-3)
    state = init_train_state(cfg, tcfg, opt, seed=0, device="cpu")
    card = elastic_reshard(state, dev)
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (2 * micro, 16), generator=gen,
                              dtype=torch.int32) for k in ("tokens", "labels")}
    step = make_train_step(cfg, tcfg, opt)
    new_cpu, m_cpu = step(state, batch)
    new_card, m_card = step(card, {k: v.to(dev) for k, v in batch.items()})
    return new_cpu, m_cpu, new_card, m_card


@pytest.mark.parametrize("arch,micro", [("olmo-1b", 1), ("qwen3-moe-30b-a3b", 2)])
def test_train_step_on_the_card_equals_the_cpu(cuda_device, arch, micro):
    """One QAT step of a dense and a MoE (microbatched) reduced arch from
    the same state: loss within rtol 1e-5, Adam's m (0.1·g) and the new w_q
    within 1e-5 of each leaf's largest, the step counted."""
    from repro_torch.tree import tree_leaves

    new_cpu, m_cpu, new_card, m_card = _train_step_both(arch, cuda_device, micro)
    torch.testing.assert_close(m_card["loss"].cpu(), m_cpu["loss"], rtol=1e-5, atol=0)
    torch.testing.assert_close(m_card["grad_norm"].cpu(), m_cpu["grad_norm"], rtol=1e-4, atol=0)
    for tree in ("m", "v"):
        for a, c in zip(tree_leaves(new_card.opt_state[tree]), tree_leaves(new_cpu.opt_state[tree])):
            assert float((a.cpu() - c).abs().max()) <= 1e-5 * float(c.abs().max()) + 1e-30
    for a, c in zip(tree_leaves(new_card.wq), tree_leaves(new_cpu.wq)):
        assert float((a.cpu() - c).abs().max()) <= 1e-5 * float(c.abs().max())
    assert int(new_card.step) == int(new_cpu.step) == 1


def test_ternary_checkpoint_on_the_card(cuda_device, tmp_path):
    """A ternary save of a reduced olmo-1b tree on the card: one
    quantize_pack launch, the packed records the CPU save's bytes and the
    scales within rtol 1e-6, and the restored leaves the CPU's decode."""
    from repro_torch.configs import get_reduced
    from repro_torch.core.compression import CodecSpec
    from repro_torch.models.transformer import init_params
    from repro_torch.train import restore_checkpoint, save_checkpoint
    from repro_torch.train._msgpack import unpackb

    params = init_params(get_reduced("olmo-1b"), seed=0, device="cpu")
    spec = CodecSpec(kind="ternary")
    before = quantize_pack.launches
    save_checkpoint(str(tmp_path / "card"), 1, _to(params, cuda_device), compression=spec)
    assert quantize_pack.launches - before == 1
    save_checkpoint(str(tmp_path / "cpu"), 1, params, compression=spec)
    recs = {}
    for name in ("card", "cpu"):
        with open(tmp_path / name / "step_000000000001" / "state.msgpack", "rb") as f:
            recs[name] = unpackb(f.read())["leaves"]
    n_tern = 0
    for a, c in zip(recs["card"], recs["cpu"]):
        if "__tern__" in c:
            n_tern += 1
            wa = torch.frombuffer(bytearray(a.pop("w_q")), dtype=torch.float32)
            wc = torch.frombuffer(bytearray(c.pop("w_q")), dtype=torch.float32)
            torch.testing.assert_close(wa, wc, rtol=1e-6, atol=0)
        assert a == c
    assert n_tern == 7
    back, meta = restore_checkpoint(str(tmp_path / "card"), example_state=params,
                                    device=cuda_device)
    back_cpu, _ = restore_checkpoint(str(tmp_path / "cpu"), example_state=params, device="cpu")
    assert meta["compressed"]
    for (_, a), (_, c) in zip(flatten_with_path(back), flatten_with_path(back_cpu)):
        assert a.device.type == "cuda"
        torch.testing.assert_close(a.cpu(), c, rtol=1e-6, atol=0)


def _tree_of(rng, shapes):
    if isinstance(shapes, dict):
        return {k: _tree_of(rng, v) for k, v in shapes.items()}
    return rng.normal(size=shapes).astype("float32")


def test_collective_on_two_gloo_ranks_on_the_card(cuda_device, tmp_path):
    """``ternary_allreduce(_tree)`` on two gloo ranks sharing cuda:0 (each
    collective staged through pinned host memory): over three steps of
    error feedback the kernel path equals the plain version from the same
    inputs within 1e-6 of each leaf's largest |value|, both ranks alike,
    and a rank receives 0.25 B per compressed coordinate."""
    import numpy as np

    from _torch_dist import run_ranks

    rng = np.random.default_rng(0)
    shapes = {"dense": {"w": (256, 512)}, "conv": {"kernel": (3, 4, 64)}, "bias": (64,)}
    single = rng.normal(size=(2, 64, 32)).astype("float32")
    steps = [[_tree_of(rng, shapes) for _ in range(2)] for _ in range(3)]
    ranks = run_ranks("collectives", 2, tmp_path, timeout=180, single=single, steps=steps,
                      device="cuda:0")
    for r in ranks:
        for got, plain in zip(r["steps"], r["plain"]):
            for part in ("synced", "res"):
                for a, b in ((got[part]["bias"], plain[part]["bias"]),
                             (got[part]["conv"]["kernel"], plain[part]["conv"]["kernel"]),
                             (got[part]["dense"]["w"], plain[part]["dense"]["w"])):
                    assert np.abs(a - b).max() <= 1e-6 * max(np.abs(b).max(), 1e-30)
        n_comp = 256 * 512 + 3 * 4 * 64
        assert r["steps"][0]["wire"]["all_gather"] == n_comp // 4 + 4 * 2
    np.testing.assert_array_equal(ranks[0]["single"], ranks[1]["single"])


def test_sharded_fold_on_two_gloo_ranks_on_the_card(cuda_device, tmp_path):
    """The client-sharded fan-in on two gloo ranks sharing cuda:0: one
    aggregate or vote launch per fold and rank, and the folds equal the
    CPU's one-process fold of all 16 clients within fp32 order."""
    import numpy as np

    from _torch_dist import run_ranks

    rng = np.random.default_rng(0)
    st = rng.integers(0, 256, size=(16, 32, LANES), dtype=np.uint8)
    co = rng.normal(size=(16,)).astype("float32")
    nbytes, n_out = [37, 144, 1, 300], [147, 576, 3, 1200]
    table = fanin_table(nbytes, n_out)
    staged = rng.integers(0, 256, size=(16, table.row_bytes), dtype=np.uint8)
    seg_co = rng.normal(size=(16, 4)).astype("float32")
    ranks = run_ranks("fanin", 2, tmp_path, timeout=180, stacked=st, coeffs=co, staged=staged,
                      seg_coeffs=seg_co, nbytes=nbytes, n_out=n_out, c_odd=5, device="cuda:0")
    cst, cco = torch.from_numpy(st), torch.from_numpy(co)
    want = {"sum": packed_weighted_sum_plain(cst, cco), "vote": packed_vote_counts_plain(cst, cco),
            "sum_segments": packed_weighted_sum_segments_plain(
                torch.from_numpy(staged), torch.from_numpy(seg_co), table),
            "vote_segments": packed_vote_counts_segments_plain(torch.from_numpy(staged), cco,
                                                               table)}
    for r in ranks:
        for k, w in want.items():
            np.testing.assert_allclose(r[k], w.numpy(), rtol=1e-6, atol=1e-5, err_msg=k)
        assert r["launches"] == (3, 2)


def test_tensor_parallel_on_two_gloo_ranks_on_the_card(cuda_device, tmp_path):
    """``parallel.tensor`` on two gloo ranks sharing cuda:0 (every
    collective staged through pinned host memory): the conjugate functions
    exact; shard and gather round trips bit for bit; FTTQ on shards with
    whole-leaf statistics against the whole leaves on the card (forward bit
    for bit, g_θ and g_wq within 1e-6 of their largest, init_wq within rtol
    1e-6, ternary_stats' counts exact, the global norm within rtol 1e-6);
    the vocab-parallel cross entropy within rtol 1e-6 (its gradient 1e-6 of
    the largest)."""
    import numpy as np

    from _torch_dist import run_ranks

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        return [] if tree is None else [np.asarray(tree)]

    ranks = run_ranks("tp_basics", 2, tmp_path, timeout=180, device="cuda:0")
    for r, out in enumerate(ranks):
        x = [np.arange(6.0).reshape(2, 3) + 10 * k for k in range(2)]
        np.testing.assert_array_equal(out["copy"][1], np.full((2, 3), 3.0))
        np.testing.assert_array_equal(out["reduce"][0], x[0] + x[1])
        np.testing.assert_array_equal(out["gather"][0], np.concatenate(x, axis=1))
        for t in out["trees"].values():
            assert t["round_trip"] and t["state_round_trip"] and t["local_shapes"]
        f = out["fttq"]
        for a, b in zip(leaves(f["q"][0]), leaves(f["q"][1])):
            np.testing.assert_array_equal(a, b)
        for key in ("g_theta", "g_wq"):
            for a, b in zip(leaves(f[key][0]), leaves(f[key][1])):
                assert np.abs(a - b).max() <= 1e-6 * max(np.abs(a).max(), 1e-30), key
        for a, b in zip(leaves(f["init_wq"][0]), leaves(f["init_wq"][1])):
            np.testing.assert_allclose(b, a, rtol=1e-6)
        assert f["stats"][0] == f["stats"][1]
        np.testing.assert_allclose(f["norm"][1], f["norm"][0], rtol=1e-6)
        ce0, ce1, g0, g1 = out["ce"]
        np.testing.assert_allclose(ce1, ce0, rtol=1e-6)
        assert np.abs(g1 - g0).max() <= 1e-6 * np.abs(g0).max()


def test_tensor_parallel_families_on_two_gloo_ranks_on_the_card(cuda_device, tmp_path):
    """One TP train step of deepseek-moe (reduced: expert stacks split by
    expert, shared experts by hidden unit) and zamba2 (reduced: Mamba2
    weights gathered, the shared block column/row-parallel) on two gloo
    ranks sharing cuda:0, gathered, against the one-device step on the card
    from the same state, to ``assert_step_matches``'s rule: loss within
    rtol 2e-6, params within 1e-6 where |g| ≥ 1e-6 and within Adam's bound
    2·lr elsewhere (its first step lr · g / (|g| + 1e-8) is ill-conditioned
    there)."""
    import numpy as np

    from _torch_dist import run_ranks

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        return [] if tree is None else [np.asarray(tree)]

    ranks = run_ranks("tp_family_steps", 2, tmp_path, timeout=180, device="cuda:0")
    for out in ranks:
        for arch, got in out.items():
            np.testing.assert_allclose(got["loss"][1], got["loss"][0], rtol=2e-6, err_msg=arch)
            for a, b, m in zip(leaves(got["params"][0]), leaves(got["params"][1]),
                               leaves(got["m"])):
                small = np.abs(m) < 1e-7
                assert np.abs(a - b)[~small].max(initial=0.0) <= 1e-6, arch
                assert np.abs(a - b)[small].max(initial=0.0) <= 2 * 3e-3, arch


def test_fsdp_step_on_two_gloo_ranks_on_the_card(cuda_device, tmp_path):
    """One FSDP train step of olmo-1b and qwen3-moe-30b-a3b (reduced) over
    a (2, 1) data x model mesh of two gloo ranks sharing cuda:0 (each layer
    gathers its data-cut weights, the backward reduce-scatters their
    gradients through pinned host memory), gathered, against the
    one-device step on the card from the same state, to
    ``assert_step_matches``'s rule (loss rtol 2e-6; params 1e-6 where |g| ≥
    1e-6, Adam's bound 2·lr elsewhere); the reduce-scatter counter is half
    the data-cut leaves' bytes."""
    import numpy as np

    from _torch_dist import run_ranks

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        return [] if tree is None else [np.asarray(tree)]

    ranks = run_ranks("fsdp_step", 2, tmp_path, timeout=180, device="cuda:0")
    for out in ranks:
        for arch, got in out.items():
            np.testing.assert_allclose(got["loss"][1], got["loss"][0], rtol=2e-6, err_msg=arch)
            for a, b, m in zip(leaves(got["params"][0]), leaves(got["params"][1]),
                               leaves(got["m"])):
                small = np.abs(m) < 1e-7
                assert np.abs(a - b)[~small].max(initial=0.0) <= 1e-6, arch
                assert np.abs(a - b)[small].max(initial=0.0) <= 2 * 3e-3, arch
            assert got["wire"]["reduce_scatter"] == got["data_cut_bytes"] // 2, arch


def test_sequence_cut_attention_on_two_gloo_ranks_on_the_card(cuda_device, tmp_path):
    """Batch-1 prefill (two chunks) and 7 greedy decode steps with the
    cache's sequence cut over two gloo ranks sharing cuda:0 (granite-20b's
    MQA over "model" and over "data", gemma3-4b's sliding window over
    "data"; reduced, 16 slots, 8 a rank): each step's logits within 1e-4 of
    max |logits| of the same ranks' CPU run, every write crossing from
    rank 0's slots into rank 1's."""
    import numpy as np

    from _torch_dist import run_ranks

    ranks = run_ranks("seq_attention", 2, tmp_path, timeout=180, device="cuda:0")
    for out in ranks:
        for name, got in out.items():
            assert got["cuda:0"]["slots"] == got["cpu"]["slots"] == 8, name
            for a, b in zip(got["cuda:0"]["logits"], got["cpu"]["logits"]):
                assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), name
