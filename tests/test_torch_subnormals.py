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
the plain version's division on every bf16 bit pattern; the window below
2^-126 where XLA flushes an exact product or quotient that IEEE rounding
takes up to 2^-126, enumerated through every function that forms one; and
NaN and ±inf weights through the QAT forward, whole and on two ranks.
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
from _torch_subnormal_cases import (
    EXACT_SUMS, LEAVES, subnormal_leaves, window_operands, window_pairs,
)
from repro_torch.core import fttq
from repro_torch.dtypes import (
    TINY, flush_subnormal, flushed_abs, flushed_op, flushed_product, xla_op,
)
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


def test_fttq_statistics_of_a_subnormal_leaf_match_reference():
    """The layer statistics of a leaf whose weights are all subnormal
    (ROADMAP Queue 3, closed): the reference reads them as zeros, so its Δ
    and w_q are 0 and every code is 0. The port's ``kernels/ops.py::
    fttq_scalars`` and ``core/fttq.py`` read them so too: the fused apply's
    codes and w_q, and ``core.fttq``'s codes, Δ and init_wq, equal the
    reference's bit for bit. (The parent's w_q was 1.18e-31 and its QAT
    codes selected 1,186 of the 2,048 weights.)"""
    x = (np.random.default_rng(0).normal(size=(64, 32)) * 1e-39).astype(np.float32)
    ji, jt, jw = jops.fttq_apply(jnp.asarray(x), 0.7, interpret=True)
    pi, pt, pw = ops.fttq_apply(torch.from_numpy(x), 0.7)
    assert not np.asarray(ji).any() and float(jw) == 0.0
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    _same_bits(pt, jt, "θ_t")
    _same_bits(pw, jw, "w_q")
    ts_j = jfttq.scale_layer(jnp.asarray(x))
    dj = jfttq.fttq_threshold(ts_j, 0.7)
    ts_t = fttq.scale_layer(torch.from_numpy(x))
    dt = fttq.fttq_threshold(ts_t, 0.7)
    _same_bits(dt, dj, "Δ")
    _same_bits(fttq.ternarize(ts_t, dt), jfttq.ternarize(ts_j, dj), "codes")
    _same_bits(fttq.init_wq(torch.from_numpy(x), fttq.FTTQConfig()),
               jfttq.init_wq(jnp.asarray(x), jfttq.FTTQConfig()), "init_wq")


# --------------------------------------------------------------------------
# XLA's rule in the FTTQ statistics, port against reference (ROADMAP Queue 3).
# --------------------------------------------------------------------------

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(x: np.ndarray, dtype: str) -> tuple[torch.Tensor, jax.Array]:
    """The same fp32 or bf16 bits as a torch tensor and a JAX array (fp32
    values rounded to bf16 by ml_dtypes)."""
    if dtype == "bfloat16":
        b = x.astype(ml_dtypes.bfloat16)
        return torch.from_numpy(b.view(np.int16).copy()).view(torch.bfloat16), jnp.asarray(b)
    return torch.from_numpy(x.copy()), jnp.asarray(x)


def _raw(x) -> np.ndarray:
    """Raw bits of a torch tensor or JAX array as unsigned integers, flat."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        x = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.atleast_1d(np.asarray(x)).reshape(-1)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


def _same_bits(got, want, what=""):
    g, w = _raw(got), _raw(want)
    assert g.dtype == w.dtype and g.shape == w.shape, what
    np.testing.assert_array_equal(g, w, err_msg=what)


def _same_or_both_nan(got, want, what=""):
    """Bit for bit, where a NaN on both sides counts as equal (XLA and
    PyTorch write different NaN payloads and signs)."""
    g, w = _raw(got), _raw(want)
    assert g.dtype == w.dtype and g.shape == w.shape, what
    gf, wf = _as_f32(g), _as_f32(w)
    ok = (g == w) | (np.isnan(gf) & np.isnan(wf))
    assert ok.all(), f"{what}: {int((~ok).sum())} of {ok.size} differ"


def _as_f32(bits: np.ndarray) -> np.ndarray:
    if bits.dtype == np.uint16:
        return torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16).float().numpy()
    return bits.view(np.float32)


def _same_up_to_zero_sign(got, want, what=""):
    """Bit for bit, except that a zero may have either sign (the fp32
    backward's flushed products; see ``dtypes.flushed_product``)."""
    g, w = _as_f32(_raw(got)), _as_f32(_raw(want))
    ok = (_raw(got) == _raw(want)) | ((g == 0) & (w == 0))
    assert ok.all(), f"{what}: {int((~ok).sum())} of {ok.size} differ"


def _close(got, want, dtype: str, what=""):
    """A sum over many normal terms, which PyTorch and XLA add in another
    order: within rtol 1e-5 in fp32 (``test_torch_fttq.py``'s GRAD_RTOL;
    XLA sums the 2,048 terms of one sign in a sequence, which drifts
    further from PyTorch's blocked sum than terms of both signs do); in
    bf16 (where the reference also rounds its sums to bf16) within 1%."""
    g = torch.as_tensor(np.asarray(got.float() if isinstance(got, torch.Tensor) else
                                   np.asarray(got, np.float32))).double().numpy()
    w = np.asarray(want).astype(np.float64)
    np.testing.assert_allclose(g, w, rtol=1e-5 if dtype == "float32" else 1e-2, err_msg=what)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", LEAVES)
def test_fttq_one_leaf_statistics_match_reference(name, dtype):
    """``scale_layer``, Δ by both rules, the codes and ``init_wq`` of a leaf
    holding subnormals against the reference: θ_s and the codes bit for
    bit, Δ by the max rule bit for bit; Δ by the mean rule and w_q bit for
    bit where their sums have at most one nonzero term (the all-subnormal
    and tiny-normal-max leaves), within the sums' rounding elsewhere."""
    x, jx = _pair(subnormal_leaves()[name], dtype)
    ts, jts = fttq.scale_layer(x), jfttq.scale_layer(jx)
    _same_bits(ts, jts, "θ_s")
    for rule in ("mean", "max"):
        d, jd = fttq.fttq_threshold(ts, 0.7, rule), jfttq.fttq_threshold(jts, 0.7, rule)
        w = fttq.init_wq(x, fttq.FTTQConfig(threshold_rule=rule))
        jw = jfttq.init_wq(jx, jfttq.FTTQConfig(threshold_rule=rule))
        _same_bits(fttq.ternarize(ts, d), jfttq.ternarize(jts, jd), f"{rule} codes")
        if name in EXACT_SUMS or rule == "max":
            _same_bits(d, jd, f"{rule} Δ")
        else:
            _close(d, jd, dtype, f"{rule} Δ")
        if name in EXACT_SUMS:
            _same_bits(w, jw, f"{rule} w_q")
        else:
            _close(w, jw, dtype, f"{rule} w_q")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", ["subnormal", "tiny_max", "edge", "tiny"])
def test_fttq_apply_matches_reference_on_subnormal_leaves(name, dtype):
    """``ops.fttq_apply`` (``fttq_scalars``, then ``ternary_quantize``)
    against the reference's with the Pallas kernel in interpret mode: the
    codes bit for bit; w_q and θ_t bit for bit on the leaves whose sums have
    one nonzero term at most, within the sums' rounding elsewhere."""
    x, jx = _pair(subnormal_leaves()[name], dtype)
    i_t, theta_t, w_q = ops.fttq_apply(x, 0.7)
    ji, jt, jw = jops.fttq_apply(jx, 0.7, interpret=True)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(ji))
    if name in EXACT_SUMS:
        # the port's w_q is fp32 for a bf16 θ, the reference's bf16: one value
        assert float(w_q) == float(jw) and np.signbit(float(w_q)) == np.signbit(float(jw))
        _same_bits(theta_t, jt, "θ_t")
    else:
        _close(w_q, jw, dtype, "w_q")
        _close(theta_t, jt, dtype, "θ_t")


def _stacked(dtype: str):
    leaves = subnormal_leaves()
    return _pair(np.stack([leaves[k] for k in LEAVES]), dtype)


def _jax_rows(jstacked, rule="mean"):
    """The reference's per-layer codes and (denom, Δ), vmapped over the
    leading axis as its ``quantize_tree`` does for a stacked leaf."""
    def one(t):
        ts = jfttq.scale_layer(t)
        d = jfttq.fttq_threshold(ts, 0.7, rule)
        return jfttq.ternarize(ts, d), jnp.max(jnp.abs(t)) + 1e-8, d

    return jax.vmap(one)(jstacked)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_row_codes_and_row_statistics_match_reference(dtype):
    """The row forms on a stacked (5, 64, 32) leaf, one row a layer (the
    all-subnormal, tiny-normal-max, edge, subnormal-rows and tiny-normal
    layers): ``row_codes`` bit for bit against the reference's vmapped
    codes, both rules; ``leaf_row_stats`` on one device: denom bit for bit,
    Δ bit for bit on the first two rows and within the sums' rounding on
    the others."""
    x, jx = _stacked(dtype)
    rows = x.reshape(len(LEAVES), -1)
    for rule in ("mean", "max"):
        jcodes, _, _ = _jax_rows(jx, rule)
        _same_bits(fttq.row_codes(rows, 0.7, rule), np.asarray(jcodes).reshape(len(LEAVES), -1),
                   rule)
    _, jdenom, jdelta = _jax_rows(jx)
    (denom, delta), = fttq.leaf_row_stats([rows], 0.7, [()])
    _same_bits(denom, jdenom, "denom")
    _same_bits(delta[:2], np.asarray(jdelta)[:2], "Δ")
    _close(delta[2:].reshape(-1), np.asarray(jdelta)[2:], dtype, "Δ")


def _vjp_case(name: str, dtype: str):
    """A leaf, the reference's init_wq of it, and a seeded normal cotangent
    with subnormals at a few positions whose code is 0."""
    x, jx = _pair(subnormal_leaves()[name], dtype)
    jw = jfttq.init_wq(jx, jfttq.FTTQConfig())
    rng = np.random.default_rng(7)
    cot = rng.normal(size=x.shape).astype(np.float32)
    codes = np.asarray(jfttq.ternarize(jfttq.scale_layer(jx),
                                       jfttq.fttq_threshold(jfttq.scale_layer(jx), 0.7)))
    flat = cot.reshape(-1)
    zero = np.flatnonzero(codes.reshape(-1) == 0)[:40]
    flat[zero] = (rng.normal(size=zero.size) * 1e-39).astype(np.float32)
    g, jg = _pair(cot, dtype)
    return x, jx, jw, g, jg


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", LEAVES)
def test_fttq_quantize_forward_and_backward_match_jax_vjp(name, dtype):
    """``FTTQQuantize`` (whole leaf) against ``jax.vjp`` of the reference's
    ``fttq_quantize`` at the reference's init_wq, with a cotangent that
    holds subnormals where the code is 0: θ_t bit for bit, g_θ bit for bit
    but the sign of a zero (``dtypes.flushed_product``); g_wq bit for bit
    where the sum has one nonzero term at most, within its rounding
    elsewhere."""
    x, jx, jw, g, jg = _vjp_case(name, dtype)
    y_ref, vjp = jax.vjp(lambda t, w: jfttq.fttq_quantize(t, w, 0.7), jx, jw)
    g_theta_ref, g_wq_ref = vjp(jg)
    theta = x.clone().requires_grad_()
    w = _pair(np.asarray(jw, np.float32).reshape(()), dtype)[0].clone().requires_grad_()
    y = fttq.FTTQQuantize.apply(theta, w, 0.7)
    y.backward(g)
    _same_bits(y, y_ref, "θ_t")
    _same_up_to_zero_sign(theta.grad, g_theta_ref, "g_θ")
    if name in EXACT_SUMS:
        _same_bits(w.grad, g_wq_ref, "g_wq")
    else:
        _close(w.grad, g_wq_ref, dtype, "g_wq")


def test_fttq_backward_of_a_subnormal_cotangent_beyond_a_unit_scale():
    """The backward reads a subnormal cotangent as XLA does, a zero, before
    its product with w_q: where one meets a selected weight and |w_q| > 1,
    XLA gives 0 (not the normal w_q·g), in g_θ and in g_wq's terms. Against
    the reference's vjp at w_q = 4: g_θ and g_wq bit for bit."""
    x = np.random.default_rng(8).normal(size=(16, 32)).astype(np.float32)
    jx = jnp.asarray(x)
    codes = np.asarray(jfttq.ternarize(jfttq.scale_layer(jx),
                                       jfttq.fttq_threshold(jfttq.scale_layer(jx), 0.7)))
    cot = np.ones_like(x)
    sel = np.flatnonzero(codes.reshape(-1) != 0)[:5]
    cot.reshape(-1)[sel] = np.float32(1e-38)          # subnormal; 4e-38 is normal
    w = np.float32(4.0)
    _, vjp = jax.vjp(lambda t, s: jfttq.fttq_quantize(t, s, 0.7), jx, jnp.asarray(w))
    g_ref, gw_ref = vjp(jnp.asarray(cot))
    theta = torch.from_numpy(x).requires_grad_()
    wq = torch.tensor(w).requires_grad_()
    fttq.FTTQQuantize.apply(theta, wq, 0.7).backward(torch.from_numpy(cot))
    assert (np.asarray(g_ref).reshape(-1)[sel] == 0).all()
    _same_bits(theta.grad, g_ref, "g_θ")
    _same_bits(wq.grad, gw_ref, "g_wq")


def _subnormal_tree(dtype: str):
    """A tree of two 2-D subnormal leaves, a stacked one (all-subnormal,
    tiny-normal-max and edge layers), a bias and a norm scale."""
    leaves = subnormal_leaves()
    stack = np.stack([leaves["subnormal"], leaves["tiny_max"], leaves["edge"]])
    np_tree = {"a": {"w": leaves["subnormal"]}, "b": {"w": leaves["tiny_max"]},
               "stack": {"w": stack}, "a_bias": {"bias": leaves["subnormal"][0]},
               "norm": {"scale": leaves["edge"][0]}}
    pairs = jax.tree_util.tree_map(lambda a: _pair(a, dtype), np_tree)
    is_pair = lambda p: isinstance(p, tuple)  # noqa: E731
    return (jax.tree_util.tree_map(lambda p: p[0], pairs, is_leaf=is_pair),
            jax.tree_util.tree_map(lambda p: p[1], pairs, is_leaf=is_pair))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_init_wq_tree_quantize_tree_and_ternary_stats_match_reference(dtype):
    """A tree of subnormal leaves through ``init_wq_tree`` (one factor per
    layer of the stacked leaf), ``quantize_tree`` at the reference's factors,
    its gradients against ``jax.grad``, and ``ternary_stats``: factors bit
    for bit except the edge layer's (within its sum's rounding), the
    quantized tree bit for bit, g_θ bit for bit but the sign of a zero, g_wq
    bit for bit where its sum has one nonzero term at most, and the
    statistics equal."""
    tree, jtree = _subnormal_tree(dtype)
    cfg, jcfg = fttq.FTTQConfig(), jfttq.FTTQConfig()
    wq, jwq = fttq.init_wq_tree(tree, cfg), jfttq.init_wq_tree(jtree, jcfg)
    _same_bits(wq["a"]["w"], jwq["a"]["w"], "a")
    _same_bits(wq["b"]["w"], jwq["b"]["w"], "b")
    _same_bits(wq["stack"]["w"][:2], np.asarray(jwq["stack"]["w"])[:2], "stack")
    _close(wq["stack"]["w"][2:].reshape(-1), np.asarray(jwq["stack"]["w"])[2:].reshape(-1),
           dtype, "stack edge layer")
    assert wq["a_bias"]["bias"] is None and wq["norm"]["scale"] is None
    wq_from_ref = {k: {n: (_pair(np.asarray(v, np.float32), dtype)[0] if v is not None else None)
                       for n, v in d.items()} for k, d in jwq.items()}
    params = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(), tree)
    factors = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(), wq_from_ref)
    q = fttq.quantize_tree(params, factors, cfg)
    jq = jfttq.quantize_tree(jtree, jwq, jcfg)
    for k in ("a", "b", "stack"):
        _same_bits(q[k]["w"], jq[k]["w"], f"quantized {k}")

    def jloss(p, w):
        out = jfttq.quantize_tree(p, w, jcfg)
        return sum(jnp.sum(out[k]["w"].astype(jnp.float32) * (i + 1.5))
                   for i, k in enumerate(("a", "b", "stack")))

    jgp, jgw = jax.grad(jloss, argnums=(0, 1))(jtree, jwq)
    loss = sum((q[k]["w"].float() * (i + 1.5)).sum() for i, k in enumerate(("a", "b", "stack")))
    loss.backward()
    for k in ("a", "b", "stack"):
        _same_up_to_zero_sign(params[k]["w"].grad, jgp[k]["w"], f"g_θ {k}")
    _same_bits(factors["a"]["w"].grad, jgw["a"]["w"], "g_wq a")
    _same_bits(factors["b"]["w"].grad, jgw["b"]["w"], "g_wq b")
    _same_bits(factors["stack"]["w"].grad[:2], np.asarray(jgw["stack"]["w"])[:2], "g_wq stack")
    assert fttq.ternary_stats(tree, cfg) == jfttq.ternary_stats(jtree, jcfg)


@pytest.fixture(scope="module")
def shard_stats(tmp_path_factory):
    """Two "model" ranks' statistics of leaves cut along their columns."""
    from _torch_dist import run_ranks

    rng = np.random.default_rng(11)
    sub = (rng.normal(size=(2, 64)) * 1e-39).astype(np.float32)
    beside = sub.copy()
    beside[:, 32:] = (rng.normal(size=(2, 32)) * 1e-36).astype(np.float32)
    held = sub.copy()
    held[1, 40] = np.float32(2e-38)            # the global max, on rank 1
    held[0, 7] = np.float32(-3e-38)            # and on rank 0 for the first row
    one = held[1:].copy()
    # a NaN or +inf weight on rank 1's half: gloo's MAX drops a NaN that
    # meets rank 0's finite maximum second
    nan = rng.normal(size=(2, 64)).astype(np.float32)
    inf = nan.copy()
    nan[1, 40] = np.nan
    inf[1, 40] = np.inf
    cases = {}
    for name, rows in (("beside", beside), ("held", held), ("one_row", one), ("nan", nan),
                       ("inf", inf)):
        for dtype in DTYPES:
            b = rows.astype(ml_dtypes.bfloat16).view(np.int16) if dtype == "bfloat16" else rows
            cases[f"{name}-{dtype}"] = (b.copy(), dtype == "bfloat16")
    cot = rng.normal(size=(2, 64)).astype(np.float32)
    ranks = run_ranks("subnormal_shard_stats", 2, tmp_path_factory.mktemp("shard_stats"),
                      leaves=cases, cot=cot)
    return {"beside": beside, "held": held, "one_row": one, "nan": nan, "inf": inf}, cot, ranks


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", ["beside", "held", "one_row", "nan", "inf"])
def test_sharded_statistics_follow_the_rule_as_one_array(shard_stats, name, dtype):
    """``leaf_row_stats`` over a "model" axis of two ranks, a leaf cut along
    its columns: a shard that is all subnormal beside a shard of tiny
    normals; a leaf whose global maximum is a tiny normal on one rank (and
    a one-row leaf, whose ``ternary_stats`` on the shards count the whole
    leaf); a NaN or +inf weight on rank 1 (the whole row's maximum NaN or
    inf on both ranks, the codes NaN where the reference's are). Each rank's (denom, Δ) is the reference's of the whole row
    computed as one array (denom bit for bit; Δ bit for bit where its sum
    has one nonzero term, within the sums' rounding otherwise), the QAT
    codes on the shards are the whole leaf's, g_wq the reference's
    Σ g·I_t over the whole row, and the zero count the reference's."""
    leaves, cot, ranks = shard_stats
    rows = leaves[name]
    x, jx = _pair(rows, dtype)
    jcodes, jdenom, jdelta = _jax_rows(jx)
    jcodes = np.asarray(jcodes, np.float32)
    for rank, out in enumerate(ranks):
        got = out[f"{name}-{dtype}"]
        np.testing.assert_array_equal(got["denom"].reshape(-1),
                                      np.asarray(jdenom, np.float32).reshape(-1))
        if name == "held" or name == "one_row":
            np.testing.assert_array_equal(got["delta"].reshape(-1),
                                          np.asarray(jdelta, np.float32).reshape(-1))
        else:
            _close(got["delta"].reshape(-1), np.asarray(jdelta, np.float32), dtype, "Δ")
        half = rows.shape[1] // 2
        np.testing.assert_array_equal(got["codes"], 0.3 * jcodes[:, rank * half:(rank + 1) * half]
                                      .astype(np.float32) if dtype == "float32" else
                                      np.asarray(jnp.asarray(0.3, jnp.bfloat16) * jcodes[
                                          :, rank * half:(rank + 1) * half].astype(
                                          ml_dtypes.bfloat16), np.float32))
        g = _pair(cot[: rows.shape[0]], dtype)[1]
        want_gwq = np.asarray(jnp.sum(g * jcodes.astype(g.dtype), axis=1), np.float32)
        _close(got["g_wq"], want_gwq, dtype, "g_wq")
        if name == "one_row":
            assert got["stats"] == jfttq.ternary_stats({"w": jx}, jfttq.FTTQConfig())


# --------------------------------------------------------------------------
# Each fold of the rule, by enumeration: every bf16 bit pattern and a seeded
# fp32 sample holding subnormals of every magnitude, against XLA.
# --------------------------------------------------------------------------


def _fold_inputs(dtype: str) -> np.ndarray:
    """Every bf16 bit pattern, or the fp32 sample of ``_patterns`` with the
    binade edges (2^-126 and its neighbours, 2^-149, 1 and its neighbours)
    added, as numpy bits."""
    if dtype == "bfloat16":
        return _bf16_bits()
    bits, _ = _patterns("fp32")
    edges = np.array([0x00800000, 0x007FFFFF, 0x00800001, 0x00000001, 0x3F800000, 0x3F7FFFFF,
                      0x3F800001, 0x00000000], np.uint32)
    return np.concatenate([bits, edges, edges | np.uint32(0x80000000)])


def _denoms(dtype: str) -> list:
    """Denominators: one in every binade of fp32's normal range that a
    denom = max|θ| + 1e-8 can take (a seeded significand each, in the
    dtype), and the edges 1e-8, 1 − ulp, 1, 1 + ulp, 2^-126-scaled tops."""
    rng = np.random.default_rng(17)
    vals = [float(np.ldexp(1.0 + rng.integers(0, 2 ** 23) / 2 ** 23, e)) for e in range(-27, 100)]
    vals += [1e-8, 1.0 - 2 ** -24, 1.0, 1.0 + 2 ** -23, 0.5, 2.0, 3.0]
    t = torch.tensor(vals, dtype=torch.float32).to(DTYPES[dtype])
    return sorted(set(t.float().tolist()))


def _jax_from_bits(bits: np.ndarray, dtype: str):
    if dtype == "bfloat16":
        return jnp.asarray(bits.view(ml_dtypes.bfloat16))
    return jnp.asarray(bits.view(np.float32))


def _f64(x: torch.Tensor) -> np.ndarray:
    return x.double().numpy()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_scaled_abs_fold_on_bit_patterns(dtype):
    """``fttq.scaled_abs`` (|θ_s| read as XLA reads it, by a per-row cut on
    |θ|; proof beside ``_quotient_cut``) equals |θ / d| as XLA divides it, for
    every input pattern and every denom of ``_denoms`` (NaNs as NaNs); and
    ``scaled_codes`` equals the reference's ternarize of that quotient at
    a zero, a subnormal, a negative, a normal and a NaN Δ, bit for bit, NaN
    codes of NaN inputs included."""
    bits = _fold_inputs(dtype)
    x = _torch_x(bits, DTYPES[dtype])
    jx = _jax_from_bits(bits, dtype)
    denoms = _denoms(dtype)
    rows = x.reshape(1, -1).expand(len(denoms), -1)
    d = torch.tensor(denoms, dtype=torch.float32).to(x.dtype).reshape(-1, 1)
    jd = jnp.asarray(np.asarray(denoms, np.float32)).astype(jx.dtype).reshape(-1, 1)
    _same_or_both_nan(fttq.scaled_abs(rows, d), jnp.abs(jx[None, :] / jd), "scaled_abs")
    for delta in (0.0, 1e-39, -0.25, 0.05, float("nan")):
        dl = torch.full((len(denoms), 1), delta).to(x.dtype)
        ref = jfttq.ternarize(jx[None, :] / jd, jnp.asarray(dl.float().numpy()).astype(jx.dtype))
        _same_or_both_nan(fttq.scaled_codes(rows, d, dl), ref, f"codes at Δ {delta}")


def _qat_rows_reference(x: np.ndarray, w: np.ndarray, coeff: np.ndarray):
    """The reference's codes, θ_t, loss Σ θ_t · coeff and its gradients of
    a (L, m) fp32 leaf quantized per row (one factor a row, vmapped as its
    ``quantize_tree`` does a stacked leaf)."""
    def codes(t):
        ts = jfttq.scale_layer(t)
        return jfttq.ternarize(ts, jfttq.fttq_threshold(ts, 0.7))

    def loss(t, s):
        q = jax.vmap(lambda r, f: jfttq.fttq_quantize(r, f, 0.7))(t, s)
        return jnp.sum(q * coeff), q

    (val, q), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    return (np.asarray(jax.vmap(codes)(jnp.asarray(x))), np.asarray(q), float(val),
            [np.asarray(g) for g in grads])


def _qat_rows_port(x: np.ndarray, w: np.ndarray, coeff: np.ndarray):
    theta = torch.from_numpy(x.copy()).requires_grad_()
    wq = torch.from_numpy(w.copy()).requires_grad_()
    q = fttq.FTTQQuantize.apply(theta, wq, 0.7)
    loss = (q * torch.from_numpy(coeff)).sum()
    loss.backward()
    return (fttq.row_codes(torch.from_numpy(x), 0.7), q.detach(), float(loss.detach()),
            [theta.grad, wq.grad])


@pytest.mark.parametrize("value", [float("nan"), float("inf"), -float("inf")],
                         ids=["nan", "inf", "-inf"])
def test_qat_code_of_a_nan_weight(value):
    """A NaN or ±inf weight at x[1, 3] of a (4, 16) fp32 leaf trained with a
    factor a row: XLA's code is sign(θ_s) · 0 = NaN wherever θ_s is NaN,
    which for a NaN weight is its whole row (the row's denom is NaN) and
    for ±inf that element (inf / inf). The port's row codes, θ_t, loss
    and gradients are NaN exactly where the reference's are; elsewhere the
    codes, θ_t and g_θ equal the reference's bit for bit (the ±inf row's
    other codes are zeros of their weights' signs, its Δ being NaN) and
    g_wq, a sum of 16 terms in another order, is within ``_close``'s
    rtol; the one-leaf ``ternarize`` agrees."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(4, 16)).astype(np.float32)
    x[1, 3] = np.float32(value)
    w = np.abs(rng.normal(size=(4,))).astype(np.float32)
    coeff = rng.normal(size=(4, 16)).astype(np.float32)
    jcodes, jq, jloss, jgrads = _qat_rows_reference(x, w, coeff)
    codes, q, loss, grads = _qat_rows_port(x, w, coeff)
    if np.isnan(value):
        assert np.isnan(jcodes[1]).all()
    else:
        assert np.isnan(jcodes[1, 3]) and not np.isnan(np.delete(jcodes[1], 3)).any()
    assert not np.isnan(jcodes[[0, 2, 3]]).any()
    _same_or_both_nan(codes, jcodes, "codes")
    np.testing.assert_array_equal(np.isnan(codes.numpy()), np.isnan(jcodes))
    np.testing.assert_array_equal(_raw(codes)[~np.isnan(jcodes).reshape(-1)],
                                  _raw(jcodes)[~np.isnan(jcodes).reshape(-1)])
    _same_or_both_nan(q, jq, "θ_t")
    np.testing.assert_array_equal(np.isnan(q.numpy()), np.isnan(jq))
    assert np.isnan(jloss) and np.isnan(loss)
    for got, want, what in zip(grads, jgrads, ("g_θ", "g_wq")):
        np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want), err_msg=what)
    _same_or_both_nan(grads[0], jgrads[0], "g_θ")
    _close(grads[1], jgrads[1], "float32", "g_wq")
    ts = fttq.scale_layer(torch.from_numpy(x[1]))
    _same_or_both_nan(fttq.ternarize(ts, fttq.fttq_threshold(ts, 0.7)), jcodes[1], "ternarize")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ternarize_cut_on_bit_patterns(dtype):
    """``fttq.ternarize`` on any θ_s (flushed or not): |θ_s| against
    max(flush(Δ), the largest subnormal) (or Δ' itself when negative), a
    zero code with θ_s's sign and a NaN code for a NaN θ_s, equals the
    reference's ternarize bit for bit on every input pattern at Δ of ±0,
    ±subnormal, 2^-126, 0.05, 0.7, −0.3, inf and NaN (NaNs as NaNs)."""
    bits = _fold_inputs(dtype)
    x = _torch_x(bits, DTYPES[dtype])
    jx = _jax_from_bits(bits, dtype)
    for delta in (0.0, -0.0, 1e-39, -1e-39, 2.0 ** -126, 0.05, 0.7, -0.3, float("inf"),
                  float("nan")):
        d = torch.tensor(delta, dtype=torch.float32).to(x.dtype)
        jd = jnp.asarray(np.float32(delta)).astype(jx.dtype)
        _same_or_both_nan(fttq.ternarize(x, d), jfttq.ternarize(jx, jd), f"Δ {delta}")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_backward_product_fold_on_bit_patterns(dtype):
    """The backward's g · scale (``dtypes.flushed_product``, the scale 1 or
    a flushed w_q): bf16 computes XLA's step (operands flushed, fp32
    product flushed, rounded); fp32 keeps the product where |g| reaches the
    scale's cut (g normal and the exact product at least KEEP). Against
    XLA's g · scale on every input pattern, bit for bit (NaNs as NaNs), at
    scales 1, 0.3, 2^-126, a subnormal, −0.7, 1 − ulp, 0, 4 and 2^100."""
    bits = _fold_inputs(dtype)
    g = _torch_x(bits, DTYPES[dtype])
    jg = _jax_from_bits(bits, dtype)
    for s in [1.0, 0.3, 2.0 ** -126, 1e-39, -0.7, 1.0 - 2 ** -24, 0.0, 4.0, 2.0 ** 100]:
        # the caller passes 1 or a flushed w_q
        st = flush_subnormal(torch.tensor(s, dtype=torch.float32).to(g.dtype))
        js = jnp.asarray(np.float32(s)).astype(jg.dtype)
        _same_or_both_nan(flushed_product(g, st), jg * js, f"scale {s}")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_xla_op_and_the_abs_read_on_bit_patterns(dtype):
    """``dtypes.xla_op`` (the residuals' add and subtract, the statistics'
    products and quotients) against XLA's add, subtract, multiply and
    divide of every input pattern with a shuffled partner and with 2^-126 ·
    (1 ± ulp) and 1 − 2^-25 (NaNs as NaNs; bit for bit, the products and
    quotients that IEEE rounding takes up to 2^-126 and XLA flushes
    included, and the fp32 edges do reach them); and ``dtypes.flushed_abs``
    (|x| with subnormals as zeros, the read of the means and maxima in
    ``fttq``, ``fttq_scalars`` and the collectives) against XLA's |x| · 1,
    which reads |x| through the flush."""
    bits = _fold_inputs(dtype)
    x = _torch_x(bits, DTYPES[dtype])
    jx = _jax_from_bits(bits, dtype)
    perm = np.random.default_rng(21).permutation(bits.size)
    partners = [(x[torch.from_numpy(perm)], jx[perm])]
    for v in (TINY * (1 - 2.0 ** -23), TINY * (1 + 2.0 ** -23), 1.0 - 2.0 ** -24):
        t = torch.full_like(x, v)
        partners.append((t, jnp.asarray(t.float().numpy()).astype(jx.dtype)))
    windows = 0
    for y, jy in partners:
        for op, jop in ((torch.add, jnp.add), (torch.sub, jnp.subtract),
                        (torch.mul, jnp.multiply), (torch.div, jnp.divide)):
            want = jop(jx, jy)
            _same_or_both_nan(xla_op(op, x, y), want, op.__name__)
            ieee = flush_subnormal(op(flush_subnormal(x).float(), flush_subnormal(y).float()))
            windows += int(((ieee.abs() == TINY) & torch.from_numpy(
                np.asarray(want, np.float32) == 0)).sum())
    assert dtype == "bfloat16" or windows > 0     # the fp32 edges reach the window
    _same_or_both_nan(flushed_abs(x), jnp.abs(jx) * jnp.ones_like(jx), "|x| read")


# --------------------------------------------------------------------------
# The window: an exact product or quotient in [2^-126 − 2^-150, KEEP), which
# IEEE rounding takes up to 2^-126 and XLA flushes, through every function of
# the port that forms one.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["mul", "div"])
def test_flushed_op_and_xla_op_on_the_window(op):
    """Every pair of ``window_pairs`` (the enumerated window and its fp32
    neighbours): ``xla_op`` and ``flushed_op`` (elementwise partner, and one
    scalar partner at a time for a few of them) equal XLA bit for bit; in
    the window IEEE gives ±2^-126 and XLA ±0."""
    a, b = window_pairs(op)
    n = len(window_operands(op)[0])
    top, jop = (torch.mul, jnp.multiply) if op == "mul" else (torch.div, jnp.divide)
    want = np.asarray(jop(jnp.asarray(a), jnp.asarray(b)))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert (np.abs(top(ta, tb).numpy()[:n]) == TINY).all() and (want[:n] == 0).all()
    _same_bits(xla_op(top, ta, tb), want, "xla_op")
    _same_bits(flushed_op(top, ta, tb), want, "flushed_op")
    for i in range(0, n, max(1, n // 16)):
        _same_bits(flushed_op(top, ta[i::n], float(b[i])), want[i::n], f"scalar {b[i]}")


def test_statistics_and_codes_on_the_window():
    """The FTTQ functions that divide by a denom or multiply by a scale, on
    the window: ``scaled_abs`` and ``scaled_codes`` (Δ = 0) of weights whose
    quotient by d = 2^k lies in it, ``_flushed_product`` of cotangents whose
    product with a scale < 1 does, and ``_times_tk``'s product of a
    statistic with T_k, against the reference's quotient, ternarize and
    product, bit for bit."""
    a, b = window_pairs("div")
    rows, d = torch.from_numpy(a).reshape(-1, 1), torch.from_numpy(b).abs().reshape(-1, 1)
    ja, jd = jnp.asarray(a).reshape(-1, 1), jnp.asarray(np.abs(b)).reshape(-1, 1)
    _same_bits(fttq.scaled_abs(rows, d), jnp.abs(ja / jd), "scaled_abs")
    zero = torch.zeros_like(d)
    _same_bits(fttq.scaled_codes(rows, d, zero), jfttq.ternarize(ja / jd, jnp.zeros_like(jd)),
               "scaled_codes")
    g, s = window_pairs("mul")
    _same_bits(flushed_product(torch.from_numpy(g), torch.from_numpy(s)),
               jnp.asarray(g) * jnp.asarray(s), "flushed_product")
    a, t = window_pairs("mul")
    n = len(window_operands("mul")[0])
    for i in range(0, n // 2, max(1, n // 32)):     # T_k < 1 on a statistic ≥ 0
        stat = np.abs(np.array([a[i], a[i + n], a[i + 2 * n], TINY, 0.0, np.nan], np.float32))
        got = fttq._times_tk(float(t[i]), torch.from_numpy(stat), torch.float32)
        _same_or_both_nan(got, float(t[i]) * jnp.asarray(stat), f"_times_tk at {t[i]}")
    stat = np.array([TINY, 2 * TINY, 3e-38, 1e-39, 0.0], np.float32)
    _same_bits(fttq._times_tk(0.7, torch.from_numpy(stat), torch.float32),
               0.7 * jnp.asarray(stat), "_times_tk at 0.7")


@pytest.mark.parametrize("kernel", ["quantize_pack", "ternary_quantize"])
def test_kernel_plain_versions_on_the_window(kernel):
    """The plain versions of ``quantize_pack`` (x / denom) and
    ``ternary_quantize`` (x · 1/max) against the Pallas kernels in
    interpret mode at Δ = 0, so that a quotient or product kept at 2^-126
    would code ±1 where XLA's flushed one codes 0: quantize_pack at denoms
    2^k (k = 1, 40, 90, 127) on the weights whose quotient lies in the
    window, and their neighbours; ternary_quantize at 16 of the enumerated
    scales on theirs. Bytes, tile counts, codes and θ_t bit for bit."""
    if kernel == "quantize_pack":
        a, b = window_pairs("div")
        for k in (1, 40, 90, 127):
            x = a[np.abs(b) == np.float32(2.0 ** k)]
            x = np.concatenate([x, np.zeros((-x.size) % 8, np.float32)])
            jpacked, jmoments, n = jquantize_pack(jnp.asarray(x), jnp.float32(2.0 ** k),
                                                  jnp.float32(0.0), interpret=True)
            packed, moments = quantize_pack_plain(torch.from_numpy(x),
                                                  torch.tensor([2.0 ** k, 0.0]))
            np.testing.assert_array_equal(packed.numpy(),
                                          np.asarray(jpacked).reshape(-1)[: (n + 3) // 4])
            np.testing.assert_array_equal(moments[:, 1].numpy(), np.asarray(jmoments)[:, 1])
        return
    g, s = window_pairs("mul")
    n = len(window_operands("mul")[0])
    for i in range(0, n // 2, max(1, n // 32)):
        x = np.array([g[i], -g[i], g[i + n], g[i + 2 * n]] * 64, np.float32).reshape(-1, 256)
        ji, jt = jternary_quantize(jnp.asarray(x), jnp.float32(s[i]), jnp.float32(0.0),
                                   jnp.float32(0.5), interpret=True)
        it, tt = ternary_quantize_plain(torch.from_numpy(x), float(s[i]), 0.0, 0.5)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ji))
        _same_bits(tt, jt, f"θ_t at {s[i]}")
