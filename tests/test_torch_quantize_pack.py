"""Port vs reference: the quantize→pack kernel's plain version against the
Pallas kernel (interpret mode) and the tree-level ternary compression
against ``repro.core.compression``. The CUDA kernel is held against its
plain version in test_torch_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import olmo_1b as jax_olmo
from repro.core import CodecSpec as JCodecSpec
from repro.core import FTTQConfig as JFTTQConfig
from repro.core import compress_pytree as jcompress
from repro.core import fttq as jfttq
from repro.core.ternary import TernaryTensor as JTernary
from repro.kernels.quantize_pack import (
    BLOCK_S, LANES, quantize_pack_segments, stage_encode,
)
from repro.kernels.quantize_pack import scale_from_moments as jscale_from_moments
from repro.models import transformer as jtf
from repro_torch.convert import params_from_jax
from repro_torch.core.compression import CodecSpec, compress_pytree
from repro_torch.core.encode import leaf_scalars
from repro_torch.core.fttq import FTTQConfig
from repro_torch.core.ternary import TernaryTensor, unpack_codes
from repro_torch.kernels.quantize_pack import (
    n_tiles, quantize_pack, quantize_pack_plain, quantize_pack_segments_plain,
    scale_from_moments, segment_layout,
)
from repro_torch.kernels.quantize_pack import quantize_pack_segments as qp_segments
from repro_torch.tree import flatten_with_path

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [5, 32768, 40001, 70000])
def test_plain_matches_pallas_kernel(n):
    """Same (denom, Δ): identical wire bytes and tile counts, tile sums
    within rtol 1e-5 (only the float reduction order differs)."""
    x = np.random.default_rng(n).normal(size=(n,)).astype(np.float32)
    denom = np.float32(np.abs(x).max() + np.float32(1e-8))
    delta = np.float32(0.7 * np.mean(np.abs(x / denom)))
    staged, _ = stage_encode(jnp.asarray(x))
    g = staged.shape[0] // BLOCK_S
    scal = jnp.broadcast_to(jnp.asarray([denom, delta], jnp.float32)[None], (g, 2))
    jpacked, jmoments = quantize_pack_segments(staged, scal, interpret=True)
    ref_bytes = np.asarray(jpacked).reshape(-1)[: (n + 3) // 4]
    jmoments = np.asarray(jmoments)

    packed, moments = quantize_pack_plain(
        torch.from_numpy(x), torch.tensor([denom, delta], dtype=torch.float32))
    assert g == n_tiles(n) == moments.shape[0]
    np.testing.assert_array_equal(packed.numpy(), ref_bytes)
    np.testing.assert_array_equal(moments[:, 1].numpy(), jmoments[:, 1])
    np.testing.assert_allclose(moments[:, 0].numpy(), jmoments[:, 0], rtol=1e-5)


SEGMENT_SETS = {
    "ragged": [5, 32768, 40001, 7],              # n % 4 != 0, a full tile, two tiles
    "resnet_like": [576, 12288, 12288, 640, 3],
    "one": [70001],
}


@pytest.mark.parametrize("name", list(SEGMENT_SETS))
def test_plain_segments_match_pallas_kernel(name):
    """Many segments at once against the reference kernel on the
    concatenated ``stage_encode`` staging with per-block (denom, Δ) rows:
    per segment, wire bytes identical, tile counts exact, tile sums and the
    scale within rtol 1e-6."""
    sizes = SEGMENT_SETS[name]
    rng = np.random.default_rng(len(sizes) + sum(sizes))
    segs = [rng.normal(size=(n,)).astype(np.float32) * rng.uniform(0.01, 2.0) for n in sizes]
    scal = np.zeros((len(segs), 2), np.float32)
    staged, rows = [], []
    for i, x in enumerate(segs):
        denom = np.float32(np.abs(x).max() + np.float32(1e-8))
        scal[i] = denom, np.float32(0.7 * np.mean(np.abs(x / denom)))
        st, _ = stage_encode(jnp.asarray(x))
        staged.append(st)
        rows.append(st.shape[0])
    block_scal = np.concatenate([np.broadcast_to(scal[i], (r // BLOCK_S, 2))
                                 for i, r in enumerate(rows)])
    jpacked, jmoments = quantize_pack_segments(jnp.concatenate(staged), jnp.asarray(block_scal),
                                               interpret=True)
    jbytes = np.asarray(jpacked).reshape(-1)
    jmoments = np.asarray(jmoments)

    packed, moments, scales = quantize_pack_segments_plain(
        [torch.from_numpy(x) for x in segs], torch.from_numpy(scal), with_scales=True)
    lay = segment_layout(sizes)
    assert packed.shape == (lay.n_bytes,) and moments.shape == (lay.n_tiles, 2)
    row0 = 0
    for i, n in enumerate(sizes):
        b, t, g = lay.byte_offsets[i], lay.tile_starts[i], n_tiles(n)
        assert g == rows[i] // BLOCK_S
        ref_bytes = jbytes[row0 * LANES // 4: row0 * LANES // 4 + (n + 3) // 4]
        np.testing.assert_array_equal(packed[b:b + (n + 3) // 4].numpy(), ref_bytes)
        ref_m = jmoments[row0 // BLOCK_S: row0 // BLOCK_S + g]
        np.testing.assert_array_equal(moments[t:t + g, 1].numpy(), ref_m[:, 1])
        np.testing.assert_allclose(moments[t:t + g, 0].numpy(), ref_m[:, 0], rtol=1e-6)
        ref_scale = np.asarray(jscale_from_moments(jnp.asarray(ref_m), jnp.float32(scal[i, 0])))
        np.testing.assert_allclose(scales[i].numpy(), ref_scale, rtol=1e-6)
        row0 += rows[i]


def test_segments_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors the multi-segment wrapper is the plain version,
    writes through ``out`` and launches nothing; its table layout puts the
    segments back to back."""
    rng = np.random.default_rng(3)
    segs = [torch.from_numpy(rng.normal(size=(n,)).astype(np.float32)) for n in (9, 40000, 3)]
    scal = torch.tensor([[3.0, 0.1], [4.0, 0.2], [2.0, 0.3]])
    lay = segment_layout([9, 40000, 3])
    assert lay.byte_offsets == (0, 3, 10003) and lay.tile_starts == (0, 1, 3)
    assert (lay.n_bytes, lay.n_tiles) == (10004, 4)
    before = quantize_pack.launches
    out = torch.full((lay.n_bytes,), 0xA5, dtype=torch.uint8)
    got = qp_segments(segs, scal, out=out, with_scales=True)
    want = quantize_pack_segments_plain(segs, scal, with_scales=True)
    assert quantize_pack.launches == before
    assert got[0].data_ptr() == out.data_ptr()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for i, x in enumerate(segs):
        p, m = quantize_pack_plain(x, scal[i])
        b, t = lay.byte_offsets[i], lay.tile_starts[i]
        assert torch.equal(out[b:b + p.numel()], p)
        assert torch.equal(want[1][t:t + m.shape[0]], m)
        assert want[2][i].item() == scale_from_moments(m, scal[i, 0]).item()
    with pytest.raises(ValueError, match="unsupported device"):
        qp_segments([torch.empty(8, device="meta")], torch.empty(1, 2, device="meta"))


def test_wrapper_takes_plain_version_on_cpu():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(9, 7)).astype(np.float32))
    scal = torch.tensor([3.0, 0.1])
    before = quantize_pack.launches
    got = quantize_pack(x, scal)
    want = quantize_pack_plain(x, scal)
    assert quantize_pack.launches == before   # no kernel launched for a CPU tensor
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _ulp_distance(a: np.ndarray, b: np.float32) -> np.ndarray:
    return np.abs(a - b) / np.spacing(np.abs(b))


def test_compress_pytree_matches_reference_on_olmo_tree():
    """Tree-level compression vs the JAX fused path on the same weights:
    Δ and w_q within rtol 1e-6; codes identical except at elements whose
    |θ_s| lies within 2 ulp of Δ."""
    jparams = jtf.init_params(jax_olmo.reduced(), jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    jwire, _ = jcompress(jparams, JCodecSpec(kind="ternary", fttq=JFTTQConfig()))
    wire, _ = compress_pytree(params_from_jax(np_params, "cpu"),
                              CodecSpec(kind="ternary", fttq=FTTQConfig()))
    jpairs = jax.tree_util.tree_flatten_with_path(
        jwire, is_leaf=lambda x: isinstance(x, JTernary))[0]
    pairs = flatten_with_path(wire, is_leaf=lambda x: isinstance(x, TernaryTensor))
    assert len(jpairs) == len(pairs)
    n_ternary = 0
    for (_, jleaf), (path, leaf) in zip(jpairs, pairs):
        if not isinstance(leaf, TernaryTensor):
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(jleaf))
            continue
        n_ternary += 1
        assert isinstance(jleaf, JTernary)
        assert leaf.shape == tuple(jleaf.shape) and leaf.dtype == jleaf.dtype
        theta = np.array(np_params["blocks"][path[1][1]][path[2][1]])
        scal, denom = leaf_scalars(torch.from_numpy(theta), FTTQConfig())
        jdelta = np.asarray(jfttq.fttq_threshold(jfttq.scale_layer(theta), 0.7))
        np.testing.assert_allclose(scal[1].numpy(), jdelta, rtol=1e-6)
        np.testing.assert_allclose(leaf.w_q.numpy(), np.asarray(jleaf.w_q), rtol=1e-6)
        codes = unpack_codes(leaf.packed, leaf.n_elements).numpy()
        jcodes = unpack_codes(torch.from_numpy(np.array(jleaf.packed)),
                              leaf.n_elements).numpy()
        differ = codes != jcodes
        if differ.any():
            theta_s = (theta.reshape(-1) / np.float32(denom.item()))[differ]
            assert (_ulp_distance(np.abs(theta_s), np.float32(jdelta)) <= 2).all()
    assert n_ternary == 7


def test_scale_from_moments_counts_as_integers():
    moments = torch.tensor([[1.5, 3.0], [2.5, 5.0]])
    got = scale_from_moments(moments, torch.tensor(2.0))
    assert got.item() == pytest.approx(4.0 / 8.0 * 2.0)
