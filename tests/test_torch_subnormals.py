"""Subnormals as XLA treats them: the plain versions of ``quantize_pack`` and
``ternary_quantize`` against the Pallas kernels in interpret mode on every
bf16 bit pattern and on a sample of fp32 patterns that holds subnormals of
every magnitude.

XLA computes fp32 and bf16 on the CPU with denormals flushed (as the TPU
does): ``jnp.asarray(np.float32(1e-39)) > 0`` is False. A subnormal weight,
denom, Δ, inverse scale or w_q enters as a zero of its sign, and a subnormal
quotient or product is flushed before it is compared or summed. PyTorch keeps
subnormals, so the port applies the rule itself (``dtypes.flush_subnormal``).

Also here: the bf16 kernel's division-free rule (a threshold on x and a
reciprocal product for |xs|), modelled in PyTorch's fp32 arithmetic, against
the plain version's division on every bf16 bit pattern; and the one place
found where the port's statistics still differ from the reference's on
subnormal weights (ROADMAP Queue 3, open).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import fttq as jfttq
from repro.kernels import ops as jops
from repro.kernels.quantize_pack import BLOCK_S, quantize_pack_segments, stage_encode
from repro.kernels.quantize_pack import quantize_pack as jquantize_pack
from repro.kernels.quantize_pack import scale_from_moments as jscale_from_moments
from repro.kernels.ternary_quantize import ternary_quantize as jternary_quantize
from repro_torch.core import fttq
from repro_torch.dtypes import TINY, flush_subnormal
from repro_torch.kernels import ops
from repro_torch.kernels.quantize_pack import (
    _scaled, n_tiles, quantize_pack_plain, quantize_pack_segments_plain, scale_from_moments,
    segment_layout,
)
from repro_torch.kernels.ternary_quantize import ternary_quantize_plain

torch.set_num_threads(1)

# (denom, Δ): a zero Δ, a subnormal denom, normal pairs, and a denom near
# fp32's top
PAIRS = [(0.8125, 0.0), (7.1e-39, 0.5), (1.0, 0.05), (1.7e38, 0.01)]


def _bf16_bits() -> np.ndarray:
    """Every bf16 bit pattern as uint16."""
    return np.arange(65536, dtype=np.uint32).astype(np.uint16)


def _patterns(kind: str) -> tuple[np.ndarray, torch.dtype]:
    """The inputs of a case as (raw bits as numpy, torch dtype): every bf16
    bit pattern; the same with non-finite patterns set to 0 (so tile sums are
    finite); a seeded fp32 sample of 2^16 patterns drawn from all 2^32 and
    2^13 subnormals, each magnitude 2^-149 … 2^-127 and both signs."""
    if kind == "bf16":
        return _bf16_bits(), torch.bfloat16
    if kind == "bf16_finite":
        bits = _bf16_bits()
        finite = (bits & 0x7F80) != 0x7F80
        return np.where(finite, bits, 0).astype(np.uint16), torch.bfloat16
    rng = np.random.default_rng(2029)
    any_bits = rng.integers(0, 2 ** 32, 2 ** 16, dtype=np.uint64).astype(np.uint32)
    top = np.uint32(1) << (np.arange(2 ** 13) % 23).astype(np.uint32)
    low = rng.integers(0, 2 ** 23, 2 ** 13, dtype=np.uint64).astype(np.uint32) & (top - 1)
    sign = rng.integers(0, 2, 2 ** 13).astype(np.uint32) << np.uint32(31)
    return np.concatenate([any_bits, top | low | sign]), torch.float32


def _torch_x(bits: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.bfloat16:
        return torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(bits.view(np.float32).copy())


def _jax_x(bits: np.ndarray, dtype: torch.dtype) -> jax.Array:
    if dtype == torch.bfloat16:
        return jnp.asarray(bits.view(ml_dtypes.bfloat16))
    return jnp.asarray(bits.view(np.float32))


def test_xla_flushes_subnormals():
    """The behaviour the port follows: XLA on the CPU reads a subnormal as
    zero and flushes a subnormal result; PyTorch does neither."""
    assert not bool(jnp.asarray(np.float32(1e-39)) > 0)
    assert float(jnp.asarray(np.float32(1e-20)) * jnp.float32(1e-20)) == 0.0
    assert bool(torch.tensor(1e-39) > 0)
    x = torch.tensor([1e-39, -1e-39, 2e-38, 1.0, float("inf"), -2e-38])
    got = flush_subnormal(x)
    assert got.tolist()[:2] == [0.0, 0.0] and torch.signbit(got).tolist()[:2] == [False, True]
    assert torch.equal(got[2:], x[2:])
    assert TINY == float(np.finfo(np.float32).tiny)


@pytest.mark.parametrize("denom,delta", PAIRS)
@pytest.mark.parametrize("kind", ["bf16", "bf16_finite", "fp32"])
def test_quantize_pack_plain_matches_pallas_on_bit_patterns(kind, denom, delta):
    """Wire bytes and tile counts bit for bit, tile sums within rtol 1e-6
    (infinite sums equal), at a zero Δ, a subnormal denom and normal pairs.
    Before the flush, (0.8125, 0) and (7.1e-39, 0.5) differed in 64 and 46
    bf16 bytes."""
    bits, dtype = _patterns(kind)
    jpacked, jmoments, n = jquantize_pack(_jax_x(bits, dtype), jnp.float32(denom),
                                          jnp.float32(delta), interpret=True)
    ref_bytes = np.asarray(jpacked).reshape(-1)[: (n + 3) // 4]
    jmoments = np.asarray(jmoments)
    packed, moments = quantize_pack_plain(_torch_x(bits, dtype),
                                          torch.tensor([denom, delta], dtype=torch.float32))
    np.testing.assert_array_equal(packed.numpy(), ref_bytes)
    np.testing.assert_array_equal(moments[:, 1].numpy(), jmoments[:, 1])
    np.testing.assert_allclose(moments[:, 0].numpy(), jmoments[:, 0], rtol=1e-6)


@pytest.mark.parametrize("kind", ["bf16", "bf16_finite", "fp32"])
def test_quantize_pack_segments_plain_matches_pallas_on_bit_patterns(kind):
    """The four (denom, Δ) pairs as four segments of one call against the
    reference kernel on the concatenated staging with per-block rows: bytes
    and counts bit for bit, sums and each segment's scale within rtol 1e-6
    (non-finite ones equal), the scale against the reference's
    ``scale_from_moments``."""
    bits, dtype = _patterns(kind)
    x = _jax_x(bits, dtype)
    staged, n = stage_encode(x)
    g = staged.shape[0] // BLOCK_S
    block_scal = np.concatenate([np.broadcast_to(np.float32(p), (g, 2)) for p in PAIRS])
    jpacked, jmoments = quantize_pack_segments(jnp.concatenate([staged] * len(PAIRS)),
                                               jnp.asarray(block_scal), interpret=True)
    jbytes = np.asarray(jpacked).reshape(len(PAIRS), -1)[:, : (n + 3) // 4]
    jmoments = np.asarray(jmoments).reshape(len(PAIRS), g, 2)

    scal = torch.tensor(PAIRS, dtype=torch.float32)
    packed, moments, scales = quantize_pack_segments_plain(
        [_torch_x(bits, dtype)] * len(PAIRS), scal, with_scales=True)
    lay = segment_layout([n] * len(PAIRS))
    assert g == n_tiles(n)
    for i in range(len(PAIRS)):
        b, t = lay.byte_offsets[i], lay.tile_starts[i]
        np.testing.assert_array_equal(packed[b:b + (n + 3) // 4].numpy(), jbytes[i])
        np.testing.assert_array_equal(moments[t:t + g, 1].numpy(), jmoments[i, :, 1])
        np.testing.assert_allclose(moments[t:t + g, 0].numpy(), jmoments[i, :, 0], rtol=1e-6)
        ref_scale = np.asarray(jscale_from_moments(jnp.asarray(jmoments[i]),
                                                   jnp.float32(PAIRS[i][0])))
        np.testing.assert_allclose(scales[i].numpy(), ref_scale, rtol=1e-6)


@pytest.mark.parametrize("denom", [1e-39, -3e-39, 2.0 ** -126, 0.5])
def test_scale_from_moments_flushes_as_xla(denom):
    """A subnormal denom is a zero, and a subnormal quotient (the first two
    rows' sum over their count) or scale comes out as zero, as the reference
    computes them; normal values throughout give the bits they gave before."""
    moments = np.array([[3e-38, 5.0], [1e-37, 7.0], [2.5, 1.0]], np.float32)
    for rows in (moments[:2], moments):
        ref = np.asarray(jscale_from_moments(jnp.asarray(rows), jnp.float32(denom)))
        got = scale_from_moments(torch.from_numpy(rows), torch.tensor(denom, dtype=torch.float32))
        np.testing.assert_array_equal(got.numpy().view(np.uint32), ref.view(np.uint32))


TQ_SCALARS = [(1.0, 0.0, 0.5), (3.0, 0.0, 1e-39), (1e-39, 0.0, 0.5), (2.0 ** -100, 0.0, 1.0),
              (0.5, 1e-39, 2.0 ** -126 - 2.0 ** -140), (0.7, 0.05, 0.3)]


@pytest.mark.parametrize("inv,delta,wq", TQ_SCALARS)
@pytest.mark.parametrize("kind", ["bf16", "fp32", "fp32_as_bf16"])
def test_ternary_quantize_plain_matches_pallas_on_subnormals(kind, inv, delta, wq):
    """Codes and θ_t bit for bit against the Pallas kernel at Δ = 0 (and a
    subnormal Δ, inverse scale or w_q): every bf16 bit pattern, the fp32
    sample's subnormals (fp32, and rounded to bf16)."""
    bits, dtype = _patterns("bf16" if kind == "bf16" else "fp32")
    x = _torch_x(bits, dtype)
    if kind != "bf16":
        x = x[-2 ** 13:]
    if kind == "fp32_as_bf16":
        x = x.to(torch.bfloat16)
    x = x.reshape(-1, 256)
    if x.dtype == torch.bfloat16:     # the bits as they are, NaN payloads too
        jx = jnp.asarray(x.view(torch.int16).numpy().view(ml_dtypes.bfloat16))
    else:
        jx = jnp.asarray(x.numpy())
    ji, jt = jternary_quantize(jx, jnp.float32(inv), jnp.float32(delta), jnp.float32(wq),
                               interpret=True)
    it, tt = ternary_quantize_plain(x, inv, delta, wq)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ji))
    jt_bits = np.asarray(jt).view(np.uint16 if x.dtype == torch.bfloat16 else np.uint32)
    tt_bits = tt.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32).numpy()
    np.testing.assert_array_equal(tt_bits, jt_bits.view(tt_bits.dtype))


def _binade_denoms(seed: int) -> list[float]:
    """One bf16 denom in every normal bf16 binade, a seeded significand each."""
    rng = np.random.default_rng(seed)
    return [float(np.ldexp(1.0 + rng.integers(0, 128) / 128.0, e)) for e in range(-126, 128)]


def _bf16_neighbours(v: float) -> list[float]:
    b = torch.tensor(v).to(torch.bfloat16).view(torch.int16)
    return [float((b - 1).view(torch.bfloat16)), v, float((b + 1).view(torch.bfloat16))]


@pytest.mark.parametrize("delta", [0.05, 0.3, 0.7, 1.0])
def test_bf16_threshold_and_reciprocal_equal_the_division(delta):
    """The bf16 kernel's rule without a division (csrc/quantize_pack_bf16.cu),
    in PyTorch's IEEE fp32 arithmetic: with D and d the bf16 denom and Δ and
    d+ the next bf16 above d, T = D · (d + d+)/2 and rcp = 1/D, the codes
    are x > T and x < −T and |xs| = bf16(|x| · rcp). Wherever the kernel
    takes this path (D, d, T positive finite normals, rcp normal), it equals
    the plain version's division on every bf16 bit pattern of x, for a D in
    every bf16 binade and Δ and its bf16 neighbours."""
    x = _torch_x(_bf16_bits(), torch.bfloat16)
    xf = x.float()
    fast_rows = 0
    for dl in _bf16_neighbours(delta):
        for dn in _binade_denoms(int(delta * 100)):
            scal = torch.tensor([dn, dl], dtype=torch.float32)
            xs, d = _scaled(x, scal)
            pos, neg = xs > d, xs < -d
            big_d = flush_subnormal(scal[0].to(torch.bfloat16)).float()
            small_d = d.float()
            up = (small_d.view(torch.int32) + 0x10000).view(torch.float32)
            t = (small_d + up) * 0.5 * big_d
            rcp = 1.0 / big_d
            if not (TINY <= big_d <= 2.0 ** 126 and small_d >= TINY
                    and TINY <= t <= torch.finfo(torch.float32).max):
                continue
            fast_rows += 1
            assert torch.equal(xf > t, pos) and torch.equal(xf < -t, neg), (dn, dl)
            sel = pos | neg
            got = (xf.abs() * rcp).to(torch.bfloat16)[sel]
            assert torch.equal(got.view(torch.int16), xs.abs()[sel].view(torch.int16)), (dn, dl)
    assert fast_rows >= 3 * 240


def test_fttq_statistics_of_a_subnormal_leaf_still_differ():
    """Open (ROADMAP Queue 3): the layer statistics of a leaf whose weights
    are all subnormal. The reference reads them as zeros, so its Δ and w_q
    are 0 and every code is 0. The port's ``kernels/ops.py::fttq_scalars``
    and ``core/fttq.py`` keep them and scale them to normal values: the
    fused apply's codes agree (``ternary_quantize`` flushes θ), but its w_q
    does not, and ``core.fttq``'s QAT codes select some weights. This test
    pins today's difference; when the statistics follow XLA's rule it
    fails, and becomes a parity test."""
    x = (np.random.default_rng(0).normal(size=(64, 32)) * 1e-39).astype(np.float32)
    ji, _, jw = jops.fttq_apply(jnp.asarray(x), 0.7, interpret=True)
    pi, _, pw = ops.fttq_apply(torch.from_numpy(x), 0.7)
    assert not np.asarray(ji).any() and float(jw) == 0.0
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    assert float(pw) > 0.0
    ts_j = jfttq.scale_layer(jnp.asarray(x))
    codes_j = np.asarray(jfttq.ternarize(ts_j, jfttq.fttq_threshold(ts_j, 0.7)))
    ts_t = fttq.scale_layer(torch.from_numpy(x))
    codes_t = fttq.ternarize(ts_t, fttq.fttq_threshold(ts_t, 0.7)).numpy()
    assert not codes_j.any() and int((codes_t != codes_j).sum()) > 1000
