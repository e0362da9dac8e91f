"""Port vs reference: wire → kernel-layout repack bytes, the ternary
matmul's plain version against the Pallas kernel (interpret mode), and the
packed matmul against the dequantized product. The CUDA kernel is held
against its plain version in test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ternary import encode_ternary as jencode
from repro.kernels import repack as jrepack
from repro.kernels.ternary_matmul import ternary_matmul as jternary_matmul
from repro_torch.core.ternary import encode_ternary
from repro_torch.kernels.repack import (
    packed_matmul, packed_params_from_wire, repack_to_kernel_layout,
)
from repro_torch.kernels.ternary_matmul import (
    BF16_DECODE_BN, BF16_DECODE_WARPS, BF16_STAGE4, BN, KC4, MAX_SPLIT, SM_COUNT, launch_shape,
    launch_shape_bf16, split_bf16x3, ternary_matmul, ternary_matmul_plain, ternary_matmul_split,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(64, 48), (32, 16), (100, 26), (10, 6), (7, 5),
                                   (3, 32, 16), (2, 12, 20)])
def test_repack_bytes_identical_to_reference(shape):
    rng = np.random.default_rng(sum(shape))
    it = rng.integers(-1, 2, size=shape).astype(np.int8)
    wq = np.float32(0.4)
    ref = jrepack.repack_to_kernel_layout(jencode(jnp.asarray(it), jnp.asarray(wq)))
    got = repack_to_kernel_layout(encode_ternary(torch.from_numpy(it), torch.tensor(wq)),
                                  "cpu")
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(ref.packed))
    np.testing.assert_array_equal(got.w_q.numpy(), np.asarray(ref.w_q))
    assert got.k == ref.k == shape[-2]


def _pack_along_k(codes: np.ndarray) -> np.ndarray:
    """(K, N) wire codes in {0, 1, 2} → (K//4, N) kernel-layout bytes."""
    c = codes.reshape(codes.shape[0] // 4, 4, codes.shape[1])
    return (c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)).astype(np.uint8)


@pytest.mark.parametrize("m,k,n", [(4, 64, 48), (5, 32, 37), (1, 8, 3), (17, 128, 130)])
def test_plain_matches_pallas_kernel(m, k, n):
    """Ragged M and N included; every shape fits one reference block."""
    rng = np.random.default_rng(m * k + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    codes = rng.integers(0, 3, size=(k, n)).astype(np.uint8)
    packed = _pack_along_k(codes)
    wq = np.float32(0.37)
    ref = jternary_matmul(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(wq),
                          interpret=True)
    got = ternary_matmul_plain(torch.from_numpy(x), torch.from_numpy(packed), torch.tensor(wq))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    dense = (codes.astype(np.float32) - 1) * wq
    np.testing.assert_allclose(got.numpy(), x @ dense, rtol=1e-5, atol=1e-5)


def test_packed_matmul_matches_dequantized_and_pads_k():
    rng = np.random.default_rng(5)
    for k, n in [(64, 48), (10, 6)]:
        it = rng.integers(-1, 2, size=(k, n)).astype(np.int8)
        t = encode_ternary(torch.from_numpy(it), torch.tensor(0.3))
        y = packed_matmul(torch.from_numpy(rng.normal(size=(2, 3, k)).astype(np.float32)),
                          repack_to_kernel_layout(t, "cpu"))
        assert y.shape == (2, 3, n)
    x = torch.from_numpy(rng.normal(size=(5, 10)).astype(np.float32))
    y = packed_matmul(x, repack_to_kernel_layout(t, "cpu"))
    torch.testing.assert_close(y, x @ t.dequantize(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="contraction dim"):
        packed_matmul(torch.ones(2, 12), repack_to_kernel_layout(t, "cpu"))


def test_packed_params_from_wire_keeps_weights_2bit():
    rng = np.random.default_rng(6)
    it = rng.integers(-1, 2, size=(2, 16, 8)).astype(np.int8)
    tree = {"w": encode_ternary(torch.from_numpy(it), torch.tensor(0.5)),
            "b": torch.ones(3)}
    served = packed_params_from_wire(tree, "cpu")
    assert served["w"].packed.shape == (2, 4, 8) and served["w"].w_q.shape == (2, 1, 1)
    assert torch.equal(served["b"], torch.ones(3))
    layer = served["w"].layer(1)
    x = torch.from_numpy(rng.normal(size=(3, 16)).astype(np.float32))
    torch.testing.assert_close(packed_matmul(x, layer),
                               x @ (torch.from_numpy(it[1]).float() * 0.5))


def test_launch_shape_fills_the_card_and_covers_k():
    """Row tile 4 at decode-sized M, 16 up to 16 rows (mma.sync), else 32
    (the warpgroup kernel); K split into non-empty ranges of at least one
    stage, far enough for two blocks per SM at decode and one above, unless
    K runs out of stages."""
    for m, k, n in [(4, 2048, 2048), (4, 2048, 8192), (4, 8192, 2048),
                    (128, 2048, 2048), (128, 2048, 8192), (128, 8192, 2048), (3, 4, 5),
                    (1, 2048, 2048), (16, 2048, 2048), (33, 64, 70)]:
        k4 = k // 4
        bm, split = launch_shape(m, k4, n)
        assert bm == (4 if m <= 4 else 16 if m <= 16 else 32)
        per = -(-k4 // split)
        assert per * split >= k4 and per * (split - 1) < k4   # no empty split
        assert split == 1 or per >= KC4
        blocks = -(-n // BN) * -(-m // bm) * split
        target = 2 * SM_COUNT if bm == 4 else SM_COUNT
        assert blocks >= target or split == max(1, k4 // KC4)


OLMO_1B_LAYERS = [(2048, 2048), (2048, 8192), (8192, 2048)]   # (K, N): wq/wk/wv/wo, w_in/w_gate, w_out


@pytest.mark.parametrize("m,k,n", [(m, k, n) for m in (1, 4, 8, 16, 17, 64, 128, 129, 256, 2048)
                                   for k, n in OLMO_1B_LAYERS]
                         + [(3, 36, 130), (33, 64, 70), (17, 4, 1), (40, 1024, 260),
                            (300, 512, 136), (5, 256, 131), (2044, 2048, 8192)])
def test_launch_shape_bf16_covers_k_and_fills_the_card(m, k, n):
    """The bf16 rule: the mma.sync kernel (8 or 16 rows) at decode-sized m
    and wherever K is no multiple of 8 (the TMA's 16-byte rows), else the
    wgmma kernel (64, 128 or 256 rows, 256 unsplit only). K splits are
    powers of two within the portable cluster (8 at decode, 4 above, where a
    block has its SM to itself), each a whole number of 64-K stages with no
    empty split; the split grows until the blocks reach the target (two per
    SM at decode, one above) or a limit stops it: the cluster, or K too
    short for a stage per decode warp (two stages above)."""
    k4 = k // 4
    bm, split = launch_shape_bf16(m, k4, n)
    wgmma = m > 16 and k % 8 == 0 and k4 >= BF16_STAGE4
    if wgmma:
        assert bm == (64 if m <= 64 else 128 if bm != 256 else 256) and bm >= min(m, 64)
        most, bn, target, least = MAX_SPLIT // 2, BN, SM_COUNT, 2 * BF16_STAGE4
    else:
        assert bm == (8 if m <= 8 else 16)
        most, bn = MAX_SPLIT, BF16_DECODE_BN
        target, least = 2 * SM_COUNT, BF16_DECODE_WARPS * BF16_STAGE4
    assert split & (split - 1) == 0 and 1 <= split <= most
    assert bm != 256 or split == 1
    per = -(-(-(-k4 // split)) // BF16_STAGE4) * BF16_STAGE4
    assert per * split >= k4 and per * (split - 1) < k4       # K covered, no empty split
    assert split == 1 or per % BF16_STAGE4 == 0
    blocks = -(-n // bn) * -(-m // bm) * split
    assert (2 * blocks > target or split == most or k4 < 2 * split * least)
    if m in (4, 128) and (k, n) in OLMO_1B_LAYERS:
        assert blocks >= SM_COUNT // 3 and split > 1          # olmo-1b's calls spread over the card
    if bm == 256:
        assert 2 * -(-n // BN) * -(-m // 256) > SM_COUNT     # its tiles alone fill half the card


def test_split_bf16x3_is_exact():
    """hi + mid + lo == x bit for bit over exponents 2^-60 .. 2^60, and
    each part is a bf16 value."""
    rng = np.random.default_rng(14)
    x = (rng.normal(size=200_000) * np.exp2(rng.uniform(-60, 60, size=200_000))
         ).astype(np.float32)
    hi, mid, lo = split_bf16x3(torch.from_numpy(x))
    np.testing.assert_array_equal(((hi + mid) + lo).numpy().view(np.int32), x.view(np.int32))
    for part in (hi, mid, lo):
        assert torch.equal(part.to(torch.bfloat16).to(torch.float32), part)
    assert (mid.abs() <= hi.abs()).all() and (lo.abs() <= mid.abs()).all()


@pytest.mark.parametrize("m,k,n", [(4, 64, 48), (3, 36, 130), (1, 8, 3), (17, 128, 130)])
def test_split_product_matches_pallas_kernel(m, k, n):
    """The kernel's arithmetic (three bf16 parts, summed (lo + mid) + hi,
    then × w_q) against the reference kernel, rtol 1e-5."""
    rng = np.random.default_rng(m * k + n + 1)
    x = rng.normal(size=(m, k)).astype(np.float32)
    codes = rng.integers(0, 3, size=(k, n)).astype(np.uint8)
    packed = _pack_along_k(codes)
    wq = np.float32(0.37)
    ref = jternary_matmul(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(wq),
                          interpret=True)
    got = ternary_matmul_split(torch.from_numpy(x), torch.from_numpy(packed), torch.tensor(wq))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("m,k,n", [(4, 64, 48), (3, 36, 130), (17, 128, 130)])
def test_split_product_exact_on_one_hot_weights(m, k, n):
    """One nonzero code per column: every output is one exact product, so
    the split arithmetic equals the plain version and the reference kernel
    bit for bit, and dropping the lo part does not (the card check's
    premise)."""
    rng = np.random.default_rng(m + k + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    codes = np.ones((k, n), dtype=np.uint8)
    codes[rng.integers(0, k, size=n), np.arange(n)] = 2 * rng.integers(0, 2, size=n)
    packed = _pack_along_k(codes)
    wq = np.float32(0.37)
    ref = np.asarray(jternary_matmul(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(wq),
                                     interpret=True))
    xt, pt, wt = torch.from_numpy(x), torch.from_numpy(packed), torch.tensor(wq)
    got = ternary_matmul_split(xt, pt, wt)
    np.testing.assert_array_equal(got.numpy(), ternary_matmul_plain(xt, pt, wt).numpy())
    np.testing.assert_array_equal(got.numpy(), ref)
    hi, mid, _ = split_bf16x3(xt)
    w = torch.from_numpy(codes.astype(np.float32) - 1)
    assert not torch.equal((mid @ w + hi @ w) * wt, got)


def test_wrapper_takes_plain_version_on_cpu():
    x = torch.randn(3, 8)
    packed = torch.full((2, 5), 0b10011001, dtype=torch.uint8)
    before = ternary_matmul.launches
    torch.testing.assert_close(ternary_matmul(x, packed, torch.tensor(2.0)),
                               ternary_matmul_plain(x, packed, torch.tensor(2.0)))
    assert ternary_matmul.launches == before


def test_wrappers_refuse_devices_they_have_no_kernel_for():
    """Dispatch is by the tensor's device: CPU takes the plain version, CUDA
    the kernel, anything else raises (there is no silent fallback)."""
    from repro_torch.kernels.quantize_pack import quantize_pack

    x = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ternary_matmul(x, torch.empty(2, 5, dtype=torch.uint8, device="meta"),
                       torch.empty((), device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        quantize_pack(x, torch.empty(2, device="meta"))
