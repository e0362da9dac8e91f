"""Port vs reference: the flat 2-bit wire pack, FTTQ layer statistics, the
quantization policy and tree order, parameter shapes, device resolution,
and the port's import isolation from JAX."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import olmo_1b as jax_olmo
from repro.core import fttq as jfttq
from repro.core import ternary as jternary
from repro.models import transformer as jtf
from repro_torch.configs import olmo_1b
from repro_torch.core import fttq, ternary
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.tree import flatten_with_path, path_str

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


@pytest.mark.parametrize("n", [1, 3, 4, 5, 127, 1000, 4097])
def test_pack2bit_unpack2bit_byte_identical(n):
    it = np.random.default_rng(n).integers(-1, 2, size=(n,)).astype(np.int8)
    ref = np.asarray(jternary.pack2bit(jnp.asarray(it)))
    got = ternary.pack2bit(torch.from_numpy(it)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.size == ternary.packed_nbytes(n) == jternary.packed_nbytes(n)
    back = ternary.unpack2bit(torch.from_numpy(got), n).numpy()
    np.testing.assert_array_equal(back, it)
    np.testing.assert_array_equal(
        back, np.asarray(jternary.unpack2bit(jnp.asarray(ref), n)))


def test_ternary_tensor_dequantize_matches_reference():
    rng = np.random.default_rng(3)
    it = rng.integers(-1, 2, size=(3, 8, 5)).astype(np.int8)
    wq = np.array([0.2, 0.3, 0.4], np.float32).reshape(3, 1, 1)
    ref = jternary.encode_ternary(jnp.asarray(it), jnp.asarray(wq))
    got = ternary.encode_ternary(torch.from_numpy(it), torch.from_numpy(wq))
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(ref.packed))
    np.testing.assert_array_equal(got.dequantize().numpy(), np.asarray(ref.dequantize()))


@pytest.mark.parametrize("rule", ["mean", "max"])
def test_fttq_statistics_match_reference(rule):
    theta = np.random.default_rng(7).normal(size=(48, 40)).astype(np.float32)
    cfg = fttq.FTTQConfig(threshold_rule=rule)
    jcfg = jfttq.FTTQConfig(threshold_rule=rule)
    t = torch.from_numpy(theta)
    ts = fttq.scale_layer(t)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(jfttq.scale_layer(theta)))
    d = fttq.fttq_threshold(ts, cfg.t_k, rule)
    jd = jfttq.fttq_threshold(jfttq.scale_layer(theta), jcfg.t_k, rule)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6)
    np.testing.assert_array_equal(fttq.ternarize(ts, d).numpy(),
                                  np.asarray(jfttq.ternarize(jfttq.scale_layer(theta), jd)))
    np.testing.assert_allclose(fttq.init_wq(t, cfg).numpy(),
                               np.asarray(jfttq.init_wq(theta, jcfg)), rtol=1e-6)


@pytest.fixture(scope="module")
def olmo_trees():
    jcfg = jax_olmo.reduced()
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    params = tf.init_params(olmo_1b.reduced(), seed=0, device="cpu")
    return jparams, params


def test_tree_paths_order_and_policy_match_reference(olmo_trees):
    """Flatten order (sorted dict keys), path strings and the quantization
    policy agree leaf by leaf over the olmo tree."""
    jparams, params = olmo_trees
    jpairs = jax.tree_util.tree_flatten_with_path(jparams)[0]
    pairs = flatten_with_path(params)
    assert [jfttq._path_str(p) for p, _ in jpairs] == [path_str(p) for p, _ in pairs]
    for (jp, jleaf), (p, leaf) in zip(jpairs, pairs):
        assert tuple(jleaf.shape) == tuple(leaf.shape)
        for cfg, jcfg in [(fttq.FTTQConfig(), jfttq.FTTQConfig()),
                          (fttq.FTTQConfig(quantize_embed=True, exclude_patterns=("w_out",)),
                           jfttq.FTTQConfig(quantize_embed=True, exclude_patterns=("w_out",)))]:
            assert fttq.is_quantizable(p, leaf, cfg) == jfttq.is_quantizable(jp, jleaf, jcfg)
    assert sum(fttq.is_quantizable(p, leaf, fttq.FTTQConfig()) for p, leaf in pairs) == 7


@pytest.mark.parametrize("which", ["reduced", "config"])
def test_param_count_matches_reference(which):
    assert tf.param_count(getattr(olmo_1b, which)()) == jtf.param_count(
        getattr(jax_olmo, which)())


def test_full_width_olmo_quantizes_2_to_the_30_weights():
    cfg = fttq.FTTQConfig()
    shapes = tf.param_shapes(olmo_1b.config())
    pairs = flatten_with_path(shapes, is_leaf=lambda x: isinstance(x, tuple))
    n = sum(int(np.prod(s)) for p, s in pairs
            if fttq.is_quantizable(p, np.empty((0,) * len(s)), cfg))
    assert n == 2 ** 30


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.init_params(olmo_1b.reduced())
    assert resolve_device("cpu") == torch.device("cpu")


def test_port_imports_neither_jax_nor_reference():
    """Importing every port module leaves jax, repro and msgpack (which the
    card machine lacks) out of sys.modules."""
    code = (
        "import pkgutil, importlib, sys, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro', 'msgpack'))\n"
        "assert len(mods) >= 20, mods\n"
        "need = {'repro_torch.' + m for m in ('core.tfedavg', 'core.encode', 'fed.aggregator',\n"
        "        'fed.simulation', 'fed.availability', 'kernels.aggregate', 'parallel.fanin',\n"
        "        'models.paper_models', 'optim.optimizers', 'data.federated', 'data.synthetic',\n"
        "        'comm.channel', 'launch.federated', 'comm.transport', 'comm.faults',\n"
        "        'fed.mp_server', 'models.moe', 'models.mamba2', 'models.frontends',\n"
        "        'configs.shapes', 'configs.gemma3_4b', 'configs.qwen3_moe_30b',\n"
        "        'configs.hubert_xlarge', 'launch.serve_loop', 'train.trainer',\n"
        "        'train.checkpoint', 'train.fault', 'train._msgpack', 'launch.train',\n"
        "        'launch.mesh', 'launch.steps', 'parallel.collectives', 'parallel.sharding',\n"
        "        'models.moe_a2a', 'launch.dryrun', 'launch.env', 'parallel.tensor')}\n"
        "assert need <= set(mods), sorted(need - set(mods))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_kernel_libraries_are_named_by_source_hash(monkeypatch, tmp_path):
    """A built library is found by a hash of its source, under build/ at the
    root of the checkout; without nvcc the build raises, never falls back."""
    from repro_torch.kernels import _build

    for name in _build.KERNELS:
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR and path.name.startswith(name + "-")
        assert (_build.CSRC / f"{name}.cu").exists()
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
