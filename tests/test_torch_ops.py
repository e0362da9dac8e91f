"""Port vs reference: the ``ops`` kernels — ``ternary_quantize``,
``pack2bit`` and ``unpack2bit`` — as plain versions against the Pallas
kernels (interpret mode) and ``repro.kernels.ref``; ``pad_to_packable`` /
``unpack_padded``; ``ops.fttq_apply`` end to end; and the quickstart on the
CPU. The CUDA kernels are held against their plain versions in
test_torch_gpu.py."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import pack2bit as jpack
from repro.kernels import ref as jref
from repro.kernels.ternary_quantize import ternary_quantize as jternary_quantize
from repro_torch.kernels import ops
from repro_torch.kernels.pack2bit import (
    pack2bit, pack2bit_plain, pad_to_packable, unpack2bit, unpack2bit_plain, unpack_padded,
)
from repro_torch.kernels.ternary_quantize import ternary_quantize, ternary_quantize_plain
from repro_torch.launch.quickstart import main as quickstart_main

torch.set_num_threads(1)

DTYPES = {"float32": (np.float32, torch.float32, np.uint32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, np.uint16)}


def _bits(a: np.ndarray, view) -> np.ndarray:
    return np.ascontiguousarray(a).view(view)


def _torch_from(a: np.ndarray, tdt: torch.dtype) -> torch.Tensor:
    if tdt == torch.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _to_np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _layer_scalars(theta32: np.ndarray, t_k: float = 0.7):
    """The test_kernels.py statistics, as fp32 numpy scalars."""
    absw = jnp.abs(jnp.asarray(theta32))
    mx = jnp.max(absw) + 1e-8
    inv = 1.0 / mx
    d = t_k * jnp.mean(absw) * inv
    sel = absw * inv > d
    wq = jnp.sum(jnp.where(sel, absw * inv, 0.0)) / (jnp.sum(sel) + 1e-8)
    return tuple(np.float32(np.asarray(v)) for v in (inv, d, wq))


@pytest.mark.parametrize("shape", [(128, 128), (100, 260), (64, 384)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ternary_quantize_plain_bit_identical_to_pallas(shape, dtype):
    """The same fp32 scalars into both: codes and θ_t identical bit for bit,
    in fp32 and in bf16 (exact zeros and −0.0 included)."""
    ndt, tdt, view = DTYPES[dtype]
    rng = np.random.default_rng(sum(shape))
    theta32 = rng.normal(size=shape).astype(np.float32)
    theta32[0, :5] = [0.0, -0.0, 0.0, -0.0, 0.0]
    theta = theta32.astype(ndt)
    scalars = _layer_scalars(theta32)
    it_k, tt_k = jternary_quantize(jnp.asarray(theta), *map(jnp.asarray, scalars),
                                   interpret=True)
    it, tt = ternary_quantize_plain(_torch_from(theta, tdt), *map(torch.tensor, scalars))
    assert it.dtype == torch.int8 and tt.dtype == tdt and tt.shape == shape
    np.testing.assert_array_equal(it.numpy(), np.asarray(it_k))
    np.testing.assert_array_equal(_bits(_to_np(tt), view), _bits(np.asarray(tt_k), view))
    it_r, tt_r = jref.ternary_quantize_ref(jnp.asarray(theta), *map(jnp.asarray, scalars))
    np.testing.assert_array_equal(it.numpy(), np.asarray(it_r))
    # the wrapper takes the plain version for a CPU tensor (Python floats too)
    before = ternary_quantize.launches
    it2, tt2 = ternary_quantize(_torch_from(theta, tdt), *(float(s) for s in scalars))
    assert ternary_quantize.launches == before
    assert torch.equal(it2, it) and torch.equal(tt2.view(torch.uint8), tt.view(torch.uint8))


def test_ternary_quantize_negative_delta_keeps_signed_zeros():
    """Δ < 0 passes every element, and sign(±0) = ±0 as in the reference."""
    theta = np.array([[0.0, -0.0, 0.5, -0.25]], np.float32)
    it_k, tt_k = jternary_quantize(jnp.asarray(theta), jnp.float32(2.0), jnp.float32(-0.1),
                                   jnp.float32(0.3), interpret=True)
    it, tt = ternary_quantize_plain(torch.from_numpy(theta), 2.0, -0.1, 0.3)
    np.testing.assert_array_equal(it.numpy(), np.asarray(it_k))
    np.testing.assert_array_equal(tt.numpy().view(np.uint32), np.asarray(tt_k).view(np.uint32))


def test_wrappers_reject_other_devices():
    x = torch.zeros(8, 4, dtype=torch.int8)
    for call in (lambda: ternary_quantize(x.float().to("meta"), 1.0, 0.1, 0.2),
                 lambda: pack2bit(x.to("meta")),
                 lambda: unpack2bit(torch.zeros(2, 4, dtype=torch.uint8).to("meta"))):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    with pytest.raises(ValueError, match="K % 4"):
        pack2bit(torch.zeros(6, 4, dtype=torch.int8))


@pytest.mark.parametrize("k,n", [(128, 128), (512, 256), (1024, 130), (260, 64)])
def test_pack_unpack_plain_match_pallas(k, n):
    """pack2bit and unpack2bit (int8, fp32, bf16) bit for bit with the
    Pallas kernels and the ref oracles; the round trip is exact."""
    rng = np.random.default_rng(k + n)
    it = rng.integers(-1, 2, size=(k, n)).astype(np.int8)
    packed_k = np.asarray(jops.pack2bit(jnp.asarray(it), interpret=True))
    before = pack2bit.launches
    packed = pack2bit(torch.from_numpy(it))
    assert pack2bit.launches == before
    assert packed.dtype == torch.uint8 and packed.shape == (k // 4, n)
    np.testing.assert_array_equal(packed.numpy(), packed_k)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jref.pack2bit_ref(jnp.asarray(it))))
    for jdt, tdt in ((jnp.int8, torch.int8), (jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jops.unpack2bit(jnp.asarray(packed_k), dtype=jdt, interpret=True))
        got = unpack2bit(packed, tdt)
        assert got.dtype == tdt and got.shape == (k, n)
        np.testing.assert_array_equal(_to_np(got).astype(np.float32), want.astype(np.float32))
        np.testing.assert_array_equal(
            _to_np(unpack2bit_plain(packed, tdt)).astype(np.float32),
            np.asarray(jref.unpack2bit_ref(jnp.asarray(packed_k), jdt)).astype(np.float32))
    assert torch.equal(unpack2bit(packed), torch.from_numpy(it))


def test_pack_keeps_the_low_byte_of_non_ternary_codes():
    """Codes outside {−1, 0, 1} pack as the Pallas kernel packs them: the
    int OR of I_t + 1, low 8 bits."""
    it = np.array([[2], [-2], [1], [5]], np.int8)
    want = np.asarray(jpack.pack2bit(jnp.asarray(it), interpret=True))
    np.testing.assert_array_equal(pack2bit_plain(torch.from_numpy(it)).numpy(), want)


@pytest.mark.parametrize("shape", [(5,), (3, 7, 11), (512,), (2, 300)])
def test_pad_to_packable_and_unpack_padded_match_reference(shape):
    rng = np.random.default_rng(len(shape))
    x = rng.integers(-1, 2, size=shape).astype(np.int8)
    tiled_j, n_j = jpack.pad_to_packable(jnp.asarray(x))
    tiled, n = pad_to_packable(torch.from_numpy(x))
    assert n == n_j == x.size
    np.testing.assert_array_equal(tiled.numpy(), np.asarray(tiled_j))
    packed = pack2bit(tiled)
    got = unpack_padded(packed, n)
    want = jpack.unpack_padded(jnp.asarray(packed.numpy()), n_j, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), x.reshape(-1))
    assert unpack_padded(packed, n, dtype=torch.float32).dtype == torch.float32


@pytest.mark.parametrize("shape", [(256, 128), (100, 260)])
def test_fttq_apply_matches_reference(shape):
    """ops.fttq_apply end to end: its statistics are reductions in another
    order than XLA's, so w_q is held within rtol 1e-6 and a code may flip
    only where |θ·s| lies within an ulp of Δ (≤ 1 in 10,000)."""
    theta = np.asarray(jax.random.normal(jax.random.PRNGKey(4), shape))
    it_j, tt_j, wq_j = jops.fttq_apply(jnp.asarray(theta), 0.7, interpret=True)
    it, tt, wq = ops.fttq_apply(torch.from_numpy(theta.copy()), 0.7)
    np.testing.assert_allclose(float(wq), float(wq_j), rtol=1e-6)
    same = it.numpy() == np.asarray(it_j)
    assert int((~same).sum()) <= theta.size // 10_000
    np.testing.assert_allclose(tt.numpy()[same], np.asarray(tt_j)[same], rtol=1e-6, atol=0)


def test_quickstart_runs_on_cpu(monkeypatch, capsys):
    out = quickstart_main(["--device", "cpu"])
    assert out["codes_differ_core"] == 0 and out["unpack_roundtrip"] and out["global_finite"]
    assert out["matmul_rel_err"] < 1e-5
    assert out["layer_wire_bytes"] == 512 * 256 // 4 + 4
    assert len(out["upload_bytes"]) == 3 and min(out["upload_bytes"]) > 0
    assert "Algorithm 2 complete" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart_main([])
