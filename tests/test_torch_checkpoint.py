"""The port's checkpoints (``repro_torch.train.checkpoint``), fault helpers
and MessagePack subset: the seven tests of ``tests/test_checkpoint.py`` on
the port, ``_msgpack`` against the ``msgpack`` package both ways, and
checkpoints across the two packages in both directions, raw and ternary,
for a TrainState with ``None`` w_q leaves.

Leaf records: raw records are byte-identical to the reference's. Ternary
records are identical in every field but ``w_q``: the packed codes are the
same bytes, and the port's scales (sums of |θ| in another order than XLA's,
ROADMAP Queue 3) are within rtol 1e-6 of the reference's."""

import os

import jax
import msgpack
import numpy as np
import pytest
import torch

from repro.core.compression import CodecSpec as JCodecSpec
from repro.models.transformer import ModelConfig as JModelConfig
from repro.optim import adam as jadam
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import init_train_state as jinit_train_state
from repro.train import make_train_step as jmake_train_step
from repro.train import restore_checkpoint as jrestore_checkpoint
from repro.train import save_checkpoint as jsave_checkpoint
from repro_torch.convert import train_state_from_jax
from repro_torch.core.compression import CodecSpec
from repro_torch.models.transformer import ModelConfig
from repro_torch.optim import adam
from repro_torch.train import (
    TrainerConfig, init_train_state, latest_step, make_train_step, restore_checkpoint,
    save_checkpoint,
)
from repro_torch.train import _msgpack
from repro_torch.train.checkpoint import flatten
from repro_torch.train.fault import StragglerDeadline, elastic_reshard, retrying
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

CFG_KW = dict(name="ckpt-test", family="dense", n_layers=2, d_model=32, vocab_size=64,
              n_heads=4, n_kv_heads=2, d_ff=64)
CFG = ModelConfig(**CFG_KW)


def _batch():
    rng = np.random.default_rng(1)
    return {"tokens": torch.from_numpy(rng.integers(0, 64, (2, 8)).astype(np.int32)),
            "labels": torch.from_numpy(rng.integers(0, 64, (2, 8)).astype(np.int32))}


def _state_and_step():
    tcfg = TrainerConfig(qat=True, pod_compression=False)
    opt = adam(1e-3)
    state = init_train_state(CFG, tcfg, opt, seed=0, device="cpu")
    return state, make_train_step(CFG, tcfg, opt), _batch()


def _leaves(state):
    return [leaf for _, leaf in flatten(state)]


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert (x is None) == (y is None)
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y)


def _dir_size(d):
    return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(d) for f in fs)


# --------------------------------------------------------------------------
# The reference's seven tests, on the port.
# --------------------------------------------------------------------------


def test_save_restore_roundtrip(tmp_path):
    state, step, batch = _state_and_step()
    state, _ = step(state, batch)
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, state, metadata={"data_cursor": 17})
    restored, meta = restore_checkpoint(d, example_state=state, device="cpu")
    assert meta["data_cursor"] == 17
    _assert_same(state, restored)
    assert restored.residuals is None and restored.wq["embed"]["table"] is None


def test_resume_training_bitexact(tmp_path):
    """Crash and restart: resuming from the checkpoint repeats the
    uninterrupted run exactly."""
    state, step, batch = _state_and_step()
    s1, _ = step(state, batch)
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, s1)
    s2, _ = step(s1, batch)
    restored, _ = restore_checkpoint(d, example_state=s1, device="cpu")
    s2r, _ = step(restored, batch)
    _assert_same(s2, s2r)


def test_atomicity_keep_and_latest(tmp_path):
    state, _, _ = _state_and_step()
    d = str(tmp_path / "ckpt")
    for s in (1, 2, 3, 4):
        save_checkpoint(d, s, state, keep=2)
    assert latest_step(d) == 4
    steps = sorted(int(n[5:]) for n in os.listdir(d) if n.startswith("step_"))
    assert steps == [3, 4]
    assert not any(n.endswith(".tmp") for n in os.listdir(d))


def test_ternary_compressed_checkpoint(tmp_path):
    """Ternary on-disk codec: ~16× smaller weight payload, restorable."""
    state, step, batch = _state_and_step()
    state, _ = step(state, batch)
    d_fp, d_t = str(tmp_path / "fp"), str(tmp_path / "tern")
    save_checkpoint(d_fp, 1, state.params)
    save_checkpoint(d_t, 1, state.params, compression=CodecSpec(kind="ternary"))
    assert _dir_size(d_t) < 0.55 * _dir_size(d_fp)  # embed stays fp32
    restored, _ = restore_checkpoint(d_t, example_state=state.params,
                                     compression=CodecSpec(kind="ternary"), device="cpu")
    a = restored["blocks"]["attn"]["wq"].numpy()
    b = state.params["blocks"]["attn"]["wq"].numpy()
    assert a.shape == b.shape
    assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.6


def test_retrying_recovers():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return "ok"

    assert retrying(flaky, max_attempts=5, backoff_s=0.0)() == "ok"
    assert calls["n"] == 3

    def always_fails():
        raise RuntimeError("permanent")

    with pytest.raises(RuntimeError):
        retrying(always_fails, max_attempts=2, backoff_s=0.0)()


def test_elastic_reshard_single_device():
    """Re-placement onto one device keeps every leaf; a tree that is not
    one of shardings is refused (the mesh case is
    ``tests/test_torch_elastic.py``)."""
    state, _, _ = _state_and_step()
    out = elastic_reshard(state.params, "cpu")
    assert torch.equal(out["embed"]["table"], state.params["embed"]["table"])
    whole = elastic_reshard(state, torch.device("cpu"))
    _assert_same(whole, state)
    with pytest.raises(TypeError, match="not a sharding tree"):
        elastic_reshard(state.params, {"embed": "cpu"})


def test_straggler_deadline():
    d = StragglerDeadline(1000.0)
    assert not d.exceeded()
    assert d.remaining() > 0
    d2 = StragglerDeadline(0.0)
    assert d2.exceeded()


# --------------------------------------------------------------------------
# The MessagePack subset.
# --------------------------------------------------------------------------

_INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1, -1, -32,
         -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]
_OBJECTS = [None, True, False, "", "a" * 31, "a" * 32, "é" * 200, "b" * 300,
            "c" * 70_000, b"", b"x" * 255, b"x" * 256, b"y" * 70_000, list(range(15)),
            list(range(16)), list(range(70_000)), {str(i): i for i in range(15)},
            {str(i): i for i in range(16)}, {str(i): [i, -i * 1000003, b"z" * i, "q" * i]
                                              for i in range(300)},
            {"leaves": [{"__nd__": True, "data": b"abc", "dtype": "<f4", "shape": [2, 3]},
                        {"__none__": True}], "treedef": "x"}] + _INTS


@pytest.mark.parametrize("obj", _OBJECTS, ids=range(len(_OBJECTS)))
def test_msgpack_subset_matches_msgpack(obj):
    """packb writes msgpack's bytes, and each side reads the other's."""
    want = msgpack.packb(obj, use_bin_type=True)
    assert _msgpack.packb(obj) == want
    assert _msgpack.unpackb(want) == msgpack.unpackb(want, raw=False) == obj


def test_msgpack_subset_refuses_what_it_does_not_carry():
    with pytest.raises(TypeError):
        _msgpack.packb({1, 2})
    with pytest.raises(TypeError):
        _msgpack.packb(1.5)
    with pytest.raises(ValueError):
        _msgpack.unpackb(msgpack.packb(1.5))
    with pytest.raises(ValueError):
        _msgpack.unpackb(msgpack.packb(msgpack.ExtType(1, b"x")))
    with pytest.raises(ValueError):
        _msgpack.unpackb(msgpack.packb([1, 2]) + b"\x00")


# --------------------------------------------------------------------------
# Across the two packages.
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def both_states():
    """The reference's TrainState after one QAT step (w_q with None leaves,
    Adam moments nonzero), the same state carried into the port, and the
    reference's jitted step."""
    cfg = JModelConfig(**CFG_KW)
    tcfg = JTrainerConfig(qat=True, pod_compression=False)
    state = jinit_train_state(cfg, tcfg, jadam(1e-3), jax.random.PRNGKey(0))
    jstep = jax.jit(jmake_train_step(cfg, tcfg, jadam(1e-3)))
    state, _ = jstep(state, _jax_batch())
    port = train_state_from_jax(jax.tree_util.tree_map(np.asarray, state), "cpu")
    assert port.wq["embed"]["table"] is None and port.residuals is None
    return state, port, jstep


def _jax_batch():
    return {k: jax.numpy.asarray(v.numpy()) for k, v in _batch().items()}


def _records(d):
    with open(os.path.join(d, "step_000000000001", "state.msgpack"), "rb") as f:
        return msgpack.unpackb(f.read(), raw=False)["leaves"]


def _jax_leaves(state):
    return jax.tree_util.tree_leaves(state, is_leaf=lambda x: x is None)


def _assert_equal_to_jax(port_state, jax_state):
    want, got = _jax_leaves(jax_state), _leaves(port_state)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
            assert b.numpy().dtype == np.asarray(a).dtype


@pytest.mark.parametrize("what", ["state", "params"])
def test_raw_records_are_the_references_bytes(tmp_path, both_states, what):
    jstate, pstate, _ = both_states
    if what == "params":
        jstate, pstate = jstate.params, pstate.params
    jsave_checkpoint(str(tmp_path / "j"), 1, jstate)
    save_checkpoint(str(tmp_path / "p"), 1, pstate)
    want, got = _records(str(tmp_path / "j")), _records(str(tmp_path / "p"))
    assert len(got) == len(want) == len(_jax_leaves(jstate))
    assert [msgpack.packb(r) for r in got] == [msgpack.packb(r) for r in want]
    if what == "state":
        assert sum("__none__" in r for r in got) >= 3      # w_q Nones and residuals


@pytest.mark.parametrize("what", ["state", "params"])
def test_ternary_records_match_the_references(tmp_path, both_states, what):
    """Every field of every record equal, except the ternary scales, which
    are within rtol 1e-6; the packed codes are the same bytes."""
    jstate, pstate, _ = both_states
    if what == "params":
        jstate, pstate = jstate.params, pstate.params
    jsave_checkpoint(str(tmp_path / "j"), 1, jstate, compression=JCodecSpec(kind="ternary"))
    save_checkpoint(str(tmp_path / "p"), 1, pstate, compression=CodecSpec(kind="ternary"))
    want, got = _records(str(tmp_path / "j")), _records(str(tmp_path / "p"))
    assert len(got) == len(want)
    n_tern = 0
    for a, b in zip(want, got):
        assert list(a) == list(b)
        if "__tern__" in a:
            n_tern += 1
            np.testing.assert_allclose(np.frombuffer(b["w_q"], np.float32),
                                       np.frombuffer(a["w_q"], np.float32), rtol=1e-6)
            a, b = dict(a, w_q=None), dict(b, w_q=None)
        assert msgpack.packb(a) == msgpack.packb(b)
    assert n_tern >= 7


@pytest.mark.parametrize("codec", ["none", "ternary"])
def test_the_reference_saves_and_the_port_restores(tmp_path, both_states, codec):
    jstate, pstate, _ = both_states
    d = str(tmp_path / "ckpt")
    spec = JCodecSpec(kind="ternary") if codec == "ternary" else None
    jsave_checkpoint(d, 1, jstate, compression=spec, metadata={"data_cursor": 5})
    restored, meta = restore_checkpoint(d, example_state=pstate, device="cpu")
    assert meta == {"data_cursor": 5, "step": 1, "compressed": codec == "ternary"}
    want, _ = jrestore_checkpoint(d, example_state=jstate)
    _assert_equal_to_jax(restored, want)
    if codec == "none":
        _assert_equal_to_jax(restored, jstate)


@pytest.mark.parametrize("codec", ["none", "ternary"])
def test_the_port_saves_and_the_reference_restores(tmp_path, both_states, codec):
    jstate, pstate, jstep = both_states
    d = str(tmp_path / "ckpt")
    spec = CodecSpec(kind="ternary") if codec == "ternary" else None
    save_checkpoint(d, 1, pstate, compression=spec, metadata={"data_cursor": 5})
    restored, meta = jrestore_checkpoint(d, example_state=jstate)
    assert meta == {"data_cursor": 5, "step": 1, "compressed": codec == "ternary"}
    mine, _ = restore_checkpoint(d, example_state=pstate, device="cpu")
    _assert_equal_to_jax(mine, restored)
    if codec == "none":
        _assert_equal_to_jax(pstate, restored)
    # the restored reference state steps on in the reference
    _, m = jstep(restored, _jax_batch())
    assert np.isfinite(float(m["loss"]))


def test_bfloat16_raw_leaves_are_written_as_the_reference_writes_them(tmp_path):
    """The reference records a bf16 raw leaf as dtype '<V2'; the port writes
    the same record and reads it back as bfloat16, which the reference's
    restore cannot."""
    import jax.numpy as jnp

    x = np.random.default_rng(0).normal(size=(3, 5)).astype(np.float32)
    jsave_checkpoint(str(tmp_path / "j"), 1, {"w": jnp.asarray(x, jnp.bfloat16)})
    t = torch.from_numpy(x).to(torch.bfloat16)
    save_checkpoint(str(tmp_path / "p"), 1, {"w": t})
    want, got = _records(str(tmp_path / "j")), _records(str(tmp_path / "p"))
    assert got == want and got[0]["dtype"] == "<V2"
    back, _ = restore_checkpoint(str(tmp_path / "p"), example_state={"w": t}, device="cpu")
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], t)
    # the reference cannot read its own record back (a void dtype); not mirrored
    with pytest.raises(TypeError):
        jrestore_checkpoint(str(tmp_path / "j"), example_state={"w": jnp.asarray(x, jnp.bfloat16)})


def test_restore_needs_an_example_and_refuses_a_sharding(tmp_path):
    state, _, _ = _state_and_step()
    d = str(tmp_path / "ckpt")
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(d, example_state=state, device="cpu")
    save_checkpoint(d, 1, state)
    with pytest.raises(ValueError):
        restore_checkpoint(d, device="cpu")
    with pytest.raises(ValueError):
        restore_checkpoint(d, example_state=state.params, device="cpu")
    with pytest.raises(TypeError, match="not a sharding tree"):
        restore_checkpoint(d, example_state=state, sharding=object(), device="cpu")
    assert len(tree_leaves(state.params)) == 12
