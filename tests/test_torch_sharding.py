"""The port's sharding rules against the reference's, for every
architecture at full and reduced size, on a (2, 4) ("data", "model") mesh
and a (2, 2, 2) ("pod", "data", "model") mesh: ``param_specs`` entry for
entry (the reference's ``param_specs`` over ``jax.eval_shape`` of its
``init_params``), ``batch_specs`` and ``cache_specs`` for every shape cell.
A mesh here is its shape and axis names; the reference reads no more of
one."""

import types

import jax
import numpy as np
import pytest

import repro.configs as JC
from repro.configs.shapes import SHAPES as JSHAPES
from repro.parallel.sharding import (
    batch_specs as jbatch_specs, cache_specs as jcache_specs, param_specs as jparam_specs,
)
import repro_torch.configs as TC
from repro_torch.launch.mesh import MeshSpec
from repro_torch.models.transformer import param_shapes
from repro_torch.parallel.sharding import (
    NamedSharding, P, batch_specs, cache_specs, is_spec, logical_batch_axes, param_shardings,
    param_specs,
)
from repro_torch.tree import flatten_with_path, path_str

MESHES = [((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]
CASES = [(arch, full) for arch in TC.ARCH_IDS for full in (True, False)]


def _fake(shape, axes):
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def _configs(arch: str, full: bool):
    if full:
        return JC.get_config(arch), TC.get_config(arch)
    return JC.get_reduced(arch), TC.get_reduced(arch)


def _plain(spec_tree):
    """Specs (the reference's PartitionSpec or the port's) as tuples, in a
    tree of dicts."""
    if isinstance(spec_tree, dict):
        return {k: _plain(v) for k, v in spec_tree.items()}
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e for e in spec_tree)


@pytest.mark.parametrize("arch,full", CASES)
def test_param_specs_match_reference(arch, full):
    jcfg, cfg = _configs(arch, full)
    shapes = dict(flatten_with_path(param_shapes(cfg), is_leaf=lambda x: isinstance(x, tuple)))
    for shape, axes in MESHES:
        ref = jparam_specs(jcfg, _fake(shape, axes))
        ref_flat = {jax.tree_util.keystr(p, simple=True, separator="/"): tuple(s)
                    for p, s in jax.tree_util.tree_flatten_with_path(
                        ref, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
        got = {path_str(p): s for p, s in flatten_with_path(param_specs(cfg, MeshSpec(shape, axes)),
                                                            is_leaf=is_spec)}
        assert {k: tuple(v) for k, v in got.items()} == ref_flat, (arch, shape)
        # the reference test's property: every sharded dim divides by its axis
        sizes = dict(zip(axes, shape))
        for path, spec in got.items():
            assert len(spec) in (0, len(shapes[_key(shapes, path)]))
            for d, entry in enumerate(spec):
                if entry is not None:
                    assert shapes[_key(shapes, path)][d] % sizes[entry] == 0, (arch, path, spec)


def _key(shapes: dict, path: str):
    return next(p for p in shapes if path_str(p) == path)


@pytest.mark.parametrize("arch,full", CASES)
def test_batch_and_cache_specs_match_reference(arch, full):
    jcfg, cfg = _configs(arch, full)
    for shape, axes in MESHES:
        fake, mesh = _fake(shape, axes), MeshSpec(shape, axes)
        for name in JSHAPES:
            assert _plain(batch_specs(cfg, name, mesh)) == _plain(
                jbatch_specs(jcfg, name, fake)), (arch, name, shape)
        for sharded in (True, False):
            assert _plain(cache_specs(cfg, mesh, batch_sharded=sharded)) == _plain(
                jcache_specs(jcfg, fake, batch_sharded=sharded)), (arch, shape, sharded)


def test_param_shardings_give_dtensor_placements():
    """A spec becomes one DTensor placement per mesh dim: ``Shard(d)``
    where the spec puts that axis on tensor dim d, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = MeshSpec((2, 2, 2), ("pod", "data", "model"))
    cfg = TC.get_reduced("olmo-1b")
    sh = param_shardings(cfg, mesh)
    wq = sh["blocks"]["attn"]["wq"]
    assert isinstance(wq, NamedSharding) and tuple(wq.spec) == (None, "data", "model")
    assert wq.placements == (Replicate(), Shard(1), Shard(2))
    assert NamedSharding(mesh, P()).placements == (Replicate(),) * 3
    assert NamedSharding(mesh, P(("pod", "data"), None)).placements == (
        Shard(0), Shard(0), Replicate())
    assert logical_batch_axes(mesh) == ("pod", "data")
    assert logical_batch_axes(MeshSpec((4,), ("model",))) == ()
