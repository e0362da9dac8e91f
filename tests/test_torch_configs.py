"""Port vs reference: the architecture registry (every config() and
reduced() field for field), parameter counts at full width, the per-layer
patterns, the (arch × shape) applicability table and the input specs (meta
tensors in the port, ShapeDtypeStruct in the reference)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import transformer as jtf
import repro_torch.configs as TC
from repro_torch.models import transformer as tf
from repro_torch.tree import flatten_with_path

torch.set_num_threads(1)


def test_registry_holds_the_reference_archs():
    assert TC.ARCH_IDS == JC.ARCH_IDS
    assert len(TC.ARCH_IDS) == 10
    with pytest.raises(KeyError, match="unknown arch"):
        TC.get_config("gpt-2")


@pytest.mark.parametrize("which", ["config", "reduced"])
@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_config_fields_match_reference(arch, which):
    getter = "get_config" if which == "config" else "get_reduced"
    ref = dataclasses.asdict(getattr(JC, getter)(arch))
    got = dataclasses.asdict(getattr(TC, getter)(arch))
    assert got == ref
    cfg, jcfg = getattr(TC, getter)(arch), getattr(JC, getter)(arch)
    for prop in ("resolved_head_dim", "n_cross", "n_attn_apps"):
        assert getattr(cfg, prop) == getattr(jcfg, prop)
    np.testing.assert_array_equal(tf.layer_windows(cfg), jtf.layer_windows(jcfg))
    np.testing.assert_array_equal(tf.cross_gates(cfg), jtf.cross_gates(jcfg))
    np.testing.assert_array_equal(tf.attn_flags(cfg), jtf.attn_flags(jcfg))


def test_model_config_has_the_reference_fields_and_defaults():
    ref = {f.name: f.default for f in dataclasses.fields(jtf.ModelConfig)}
    got = {f.name: f.default for f in dataclasses.fields(tf.ModelConfig)}
    assert got == ref


def test_overrides_reach_the_config():
    cfg = TC.get_reduced("qwen3-moe-30b-a3b", capacity_factor=16.0)
    assert cfg.capacity_factor == 16.0
    assert cfg == tf.ModelConfig(**dataclasses.asdict(JC.get_reduced(
        "qwen3-moe-30b-a3b", capacity_factor=16.0)))


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_param_count_and_shapes_match_reference(arch):
    """Exact integers at full width, and the reduced tree's paths and shapes
    against the reference's eval_shape."""
    assert tf.param_count(TC.get_config(arch)) == jtf.param_count(JC.get_config(arch))
    jcfg = JC.get_reduced(arch)
    ref = jax.eval_shape(lambda k: jtf.init_params(jcfg, k), jax.random.PRNGKey(0))
    ref_pairs = [(tuple(str(getattr(e, "key", e)) for e in p), tuple(l.shape))
                 for p, l in jax.tree_util.tree_flatten_with_path(ref)[0]]
    got_pairs = [(tuple(str(k) for _, k in p), s) for p, s in flatten_with_path(
        tf.param_shapes(TC.get_reduced(arch)), is_leaf=lambda x: isinstance(x, tuple))]
    assert got_pairs == ref_pairs
    params = tf.init_params(TC.get_reduced(arch), seed=0, device="cpu")
    assert [(tuple(str(k) for _, k in p), tuple(t.shape), t.dtype)
            for p, t in flatten_with_path(params)] == [
        (path, shape, torch.float32) for path, shape in ref_pairs]


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_applicable_agrees_on_every_cell(arch):
    for cfg, jcfg in [(TC.get_config(arch), JC.get_config(arch)),
                      (TC.get_reduced(arch), JC.get_reduced(arch))]:
        for shape in JC.SHAPES:
            assert TC.applicable(cfg, shape) == JC.applicable(jcfg, shape)
    assert {k: dataclasses.asdict(v) for k, v in TC.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JC.SHAPES.items()}


def _flat_specs(tree, is_torch):
    out = []
    if is_torch:
        for path, leaf in flatten_with_path(tree):
            assert leaf.device.type == "meta"
            out.append((tuple(k for _, k in path), tuple(leaf.shape),
                        str(leaf.dtype).replace("torch.", "")))
    else:
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            assert isinstance(leaf, jax.ShapeDtypeStruct)
            out.append((tuple(getattr(e, "key", e) for e in path), tuple(leaf.shape),
                        str(leaf.dtype)))
    return out


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_input_specs_match_reference_as_meta_tensors(arch):
    cfg, jcfg = TC.get_config(arch), JC.get_config(arch)
    for shape in JC.SHAPES:
        if not JC.applicable(jcfg, shape)[0]:
            continue
        got = _flat_specs(TC.input_specs(cfg, shape), True)
        ref = _flat_specs(JC.input_specs(jcfg, shape), False)
        assert got == ref, (arch, shape)
