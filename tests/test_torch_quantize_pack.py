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
    BLOCK_S, quantize_pack_segments, stage_encode,
)
from repro.models import transformer as jtf
from repro_torch.convert import params_from_jax
from repro_torch.core.compression import CodecSpec, compress_pytree
from repro_torch.core.encode import leaf_scalars
from repro_torch.core.fttq import FTTQConfig
from repro_torch.core.ternary import TernaryTensor, unpack_codes
from repro_torch.kernels.quantize_pack import (
    n_tiles, quantize_pack, quantize_pack_plain, scale_from_moments,
)
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
