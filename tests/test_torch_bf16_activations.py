"""The models' elementwise steps at bf16 (``repro_torch.models.elementwise``)
against the reference's on the CPU: every bf16 bit pattern (finite values,
±0, ±inf, NaN) through silu, gelu and relu, forward and VJP at fixed
cotangents, bit for bit with ``jax.nn``; the other steps that see bf16 in a
bf16 model, each held to the reference at bf16 (the vlm's tanh gates,
the residual adds, the QAT backward's Σ g·I_t) or, where the reference
computes them in fp32 (the MoE router's softmax, Mamba2's exp(a_log) and
softplus), within the last fp32 bits their reduction order and library
leave; and an fp32 sample through the activations, which keep PyTorch's
functions and their parity with the reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core.fttq import fttq_quantize as jfttq_quantize
from repro_torch.core.fttq import fttq_quantize
from repro_torch.models import elementwise as ew
from repro_torch.models.common import act_fn
from repro_torch.models.mamba2 import softplus

torch.set_num_threads(1)

BITS = np.arange(1 << 16, dtype=np.uint16)
JNN = {"silu": jax.nn.silu, "gelu": jax.nn.gelu, "relu": jax.nn.relu}


def _bf16(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)


def _cotangents() -> dict:
    """Fixed bf16 cotangents: 1, −0.75 and a seeded sample over 40 binades."""
    rng = np.random.default_rng(0)
    rand = rng.normal(size=BITS.size) * np.exp2(rng.integers(-20, 20, BITS.size))
    return {"one": np.ones(BITS.size), "minus_0.75": np.full(BITS.size, -0.75),
            "seeded": rand}


COTANGENTS = _cotangents()


def _to_bf16_bits(v: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(v, jnp.float32).astype(jnp.bfloat16)).view(np.uint16)


def _assert_bits(got: torch.Tensor, want, what: str):
    """Equal bits, a NaN of either payload counting as NaN."""
    g = got.detach().contiguous().view(torch.int16).numpy().view(np.uint16)
    w = np.asarray(want).view(np.uint16)
    nan = np.isnan(got.detach().float().numpy()) & np.isnan(np.asarray(want, np.float32))
    bad = (g != w) & ~nan
    assert not bad.any(), f"{what}: {int(bad.sum())} of {bad.size} differ, e.g. inputs " \
        f"{BITS[bad][:4]}"


def _jax_vjp(f, x_bits: np.ndarray, g_bits: np.ndarray):
    jx = jnp.asarray(x_bits).view(jnp.bfloat16)
    jg = jnp.asarray(g_bits).view(jnp.bfloat16)
    return jax.jit(lambda x, g: jax.vjp(f, x)[1](g)[0])(jx, jg)


def _torch_vjp(f, x_bits: np.ndarray, g_bits: np.ndarray) -> torch.Tensor:
    x = _bf16(x_bits).requires_grad_(True)
    f(x).backward(_bf16(g_bits))
    return x.grad


@pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
def test_activation_forward_is_xla_bit_for_bit(name):
    """All 65,536 bf16 patterns, through the model's ``act_fn``: the
    reference's bits (PyTorch's own functions differ on 1,866 finite inputs
    for silu, 1,518 for gelu, 128 for relu: subnormals and −0)."""
    want = jax.jit(JNN[name])(jnp.asarray(BITS).view(jnp.bfloat16))
    got = act_fn(name)(_bf16(BITS))
    assert got.dtype == torch.bfloat16
    _assert_bits(got, want, name)


@pytest.mark.parametrize("cot", sorted(COTANGENTS))
@pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
def test_activation_vjp_is_xla_bit_for_bit(name, cot):
    """The VJP at every bf16 input for a fixed cotangent, against
    ``jax.vjp`` of the same function: bit for bit."""
    g = _to_bf16_bits(COTANGENTS[cot])
    _assert_bits(_torch_vjp(act_fn(name), BITS, g), _jax_vjp(JNN[name], BITS, g),
                 f"{name} vjp")


def test_tanh_gate_forward_and_vjp_are_xla():
    """The vlm's gates, tanh of a bf16 parameter: forward and VJP bit for
    bit at every bf16 input (PyTorch's backward g·(1 − t²) rounds once and
    differs on 9,143 of them at the seeded cotangent)."""
    _assert_bits(ew.tanh(_bf16(BITS)), jax.jit(jnp.tanh)(jnp.asarray(BITS).view(jnp.bfloat16)),
                 "tanh")
    for cot in COTANGENTS.values():
        g = _to_bf16_bits(cot)
        _assert_bits(_torch_vjp(ew.tanh, BITS, g), _jax_vjp(jnp.tanh, BITS, g), "tanh vjp")


def test_mamba_decay_exp_within_fp32_ulps():
    """Mamba2's A = −exp(a_log): the reference keeps a_log in fp32 even in a
    bf16 model (``repro.models.mamba2``), so the port's PyTorch exp runs
    there: within 1 fp32 ulp forward and 2 in the VJP of XLA's on a seeded
    2^20 sample over [−20, 20] (measured: 100,518 and 80,443 inputs at one
    ulp, 10,162 at two; XLA's fp32 exp, no repair)."""
    x = np.random.default_rng(6).uniform(-20, 20, 1 << 20).astype(np.float32)
    c = np.random.default_rng(7).normal(size=x.size).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: -jnp.exp(a))(x))
    want_g = np.asarray(jax.jit(lambda a, b: jax.vjp(lambda z: -jnp.exp(z), a)[1](b)[0])(x, c))
    t = torch.from_numpy(x).requires_grad_(True)
    y = -torch.exp(t)
    y.backward(torch.from_numpy(c))
    for got, ref, ulps in ((y.detach().numpy(), want, 1), (t.grad.numpy(), want_g, 2)):
        d = np.abs(got.view(np.int32).astype(np.int64) - ref.view(np.int32).astype(np.int64))
        assert d.max() <= ulps


def test_residual_add_is_xla():
    """a + b at bf16: every pair of the 1,024 patterns in the three
    binades from zero up (subnormals, and normals whose sums cancel into
    them), and a seeded sample of 2^16 pairs of normals, bit for bit; the
    cotangent reaches both operands unchanged."""
    small = np.concatenate([np.arange(0, 3 * 128, dtype=np.uint16),
                            np.arange(0x8000, 0x8000 + 3 * 128, dtype=np.uint16)])
    small = np.concatenate([small, small + 3 * 128])[:1024]
    a = np.repeat(small, small.size)
    b = np.tile(small, small.size)
    rng = np.random.default_rng(2)
    a = np.concatenate([a, _to_bf16_bits(rng.normal(size=1 << 16))])
    b = np.concatenate([b, _to_bf16_bits(rng.normal(size=1 << 16))])
    want = jax.jit(jnp.add)(jnp.asarray(a).view(jnp.bfloat16), jnp.asarray(b).view(jnp.bfloat16))
    ta, tb = _bf16(a).requires_grad_(True), _bf16(b).requires_grad_(True)
    got = ew.residual_add(ta, tb)
    g = np.asarray(got.detach().view(torch.int16).numpy()).view(np.uint16)
    w = np.asarray(want).view(np.uint16)
    assert (g == w).all(), f"{int((g != w).sum())} of {g.size} sums differ"
    cot = torch.linspace(-1, 1, a.size).to(torch.bfloat16)
    got.backward(cot)
    assert torch.equal(ta.grad, cot) and torch.equal(tb.grad, cot)


@pytest.mark.parametrize("e", [8, 64, 128])
def test_router_softmax_within_fp32_rounding(e):
    """The MoE router's softmax runs on fp32 logits in both packages (the
    bf16 router matmul's output cast up): the probabilities within 1e-6
    (measured ≤ 4.8e-7) and the VJP within 1e-6 of the row's largest
    |cotangent| (measured ≤ 2.2e-7): XLA's fp32 exp and its reduction order
    differ from PyTorch's in the last bits; no repair."""
    rng = np.random.default_rng(e)
    logits = (rng.normal(size=(4096, e)) * 2).astype(np.float32)
    g = rng.normal(size=(4096, e)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jax.nn.softmax(a, -1))(logits))
    want_g = np.asarray(jax.jit(lambda a, c: jax.vjp(lambda z: jax.nn.softmax(z, -1), a)[1](c)[0])(
        logits, g))
    t = torch.from_numpy(logits).requires_grad_(True)
    y = torch.softmax(t, dim=-1)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=0, atol=1e-6)
    scale = np.abs(g).max(axis=-1, keepdims=True)
    assert (np.abs(t.grad.numpy() - want_g) <= 1e-6 * scale).all(), \
        (np.abs(t.grad.numpy() - want_g) / scale).max()


def test_mamba_softplus_within_fp32_ulps():
    """Mamba2's softplus runs on fp32 (dt_raw cast up plus dt_bias) in both
    packages: within 4 fp32 ulps of ``jax.nn.softplus`` on a seeded 2^20
    sample (measured: 3 ulps at 19 inputs, 2 at 8,079, 1 at 68,280; XLA's
    log1p and exp against PyTorch's logaddexp); no repair."""
    x = (np.random.default_rng(4).normal(size=1 << 20) * 4).astype(np.float32)
    want = np.asarray(jax.jit(jax.nn.softplus)(x))
    got = softplus(torch.from_numpy(x)).numpy()
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 4


@pytest.mark.parametrize("shape", [(64, 48), (3, 1000)])
def test_qat_backward_bf16_sum_is_xla_within_its_order(shape):
    """The reference's straight-through backward on a bf16 leaf: g_θ bit
    for bit, and Σ g·I_t (``jnp.sum`` on bf16, which XLA accumulates in
    fp32 and rounds once, as PyTorch's bf16 sum does) within one bf16 ulp
    of its value: the summation order only."""
    rng = np.random.default_rng(shape[1])
    theta = jnp.asarray(rng.normal(size=shape), jnp.bfloat16)
    wq = jnp.asarray(0.37, jnp.bfloat16)
    g = jnp.asarray(rng.normal(size=shape), jnp.bfloat16)
    _, pull = jax.vjp(lambda t, w: jfttq_quantize(t, w, 0.05), theta, wq)
    jg_theta, jg_wq = pull(g)
    tt = torch.from_numpy(np.asarray(theta).view(np.int16).copy()).view(torch.bfloat16)
    tw = torch.from_numpy(np.asarray(wq).view(np.int16).copy()).view(torch.bfloat16)
    tt.requires_grad_(True)
    tw.requires_grad_(True)
    fttq_quantize(tt, tw, 0.05).backward(torch.from_numpy(np.asarray(g).view(np.int16).copy())
                                         .view(torch.bfloat16))
    assert tt.grad.dtype == tw.grad.dtype == torch.bfloat16
    _assert_bits(tt.grad.reshape(-1), np.asarray(jg_theta).reshape(-1), "g_θ")
    a, b = float(tw.grad), float(np.asarray(jg_wq, np.float32))
    assert abs(a - b) <= 2.0 ** (np.floor(np.log2(abs(b))) - 7)


def _fp32_sample() -> np.ndarray:
    """2^20 seeded fp32 values over 18 binades, and the edges: ±0, ±inf,
    NaN, the subnormal range, 2^-126 and its neighbours, ±88 (where exp(−x)
    leaves fp32's range), ±1e30."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=1 << 20) * np.exp2(rng.integers(-10, 8, 1 << 20))
    tiny = 2.0 ** -126
    edges = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 1e-39, -1e-39, tiny,
             -tiny, tiny * (1 + 2 ** -23), tiny * (1 - 2 ** -23), 88.0, -88.0, 89.0, -89.0,
             1e30, -1e30]
    return np.concatenate([x, edges]).astype(np.float32)


@pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
def test_fp32_activations_keep_their_parity(name):
    """fp32 keeps PyTorch's functions, bit for bit as before, and their
    parity with ``jax.nn`` on the sample: within 2^-21·|x| + 2^-125 of the
    reference's value (measured ≤ 2^-22·|x| where both results are
    normal: XLA's fp32 exp and tanh differ from PyTorch's, and gelu's
    1 + tanh cancels for negative x; the 2^-125 covers the results XLA
    flushes), NaN where it is NaN."""
    x = _fp32_sample()
    got = act_fn(name)(torch.from_numpy(x))
    torch_fn = {"silu": F.silu, "gelu": lambda v: F.gelu(v, approximate="tanh"),
                "relu": F.relu}[name]
    assert torch.equal(got.view(torch.int32), torch_fn(torch.from_numpy(x)).view(torch.int32))
    want = np.asarray(jax.jit(JNN[name])(x))
    g = got.numpy()
    assert (np.isnan(g) == np.isnan(want)).all()
    ok = ~np.isnan(want)
    err = np.abs(g[ok].astype(np.float64) - want[ok])
    with np.errstate(invalid="ignore"):
        bound = 2.0 ** -21 * np.abs(x[ok].astype(np.float64)) + 2.0 ** -125
    assert ((err <= bound) | (g[ok] == want[ok])).all()
