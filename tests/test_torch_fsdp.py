"""FSDP over the mesh's "data" axis (``parallel.tensor``,
``parallel.collectives.reduce_scatter``), on two and four ``gloo`` CPU
ranks: the gather / reduce-scatter pair, ``reduce_scatter`` itself, FTTQ's
whole-leaf statistics and the global norm on data and data x model shards,
one train step against one device, the step's refusal of a whole state,
checkpoints from data shards (the one-device file, restored by the
reference), ``elastic_reshard`` of a (2, 2) state, prefill and decode on
data shards, and ``launch/train.py`` with ``WORLD_SIZE`` 2 and
``--model 1``. Each shard-side result is held to the port's one-device
function on the whole leaves, which the other test files hold to the
reference."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import repro.configs as JC
from repro.optim import adam as jadam
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import init_train_state as jinit_train_state
from repro.train import restore_checkpoint as jrestore_checkpoint
from _torch_dist import REPO, _env, run_ranks

LR = 3e-3
MAX, GEN = 12, 3


def _batch(rows: int) -> dict:
    rng = np.random.default_rng(0)
    return {k: rng.integers(0, 128, (rows, 16)).astype(np.int32) for k in ("tokens", "labels")}


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp2")
    return run_ranks("fsdp_basics", 2, tmp, timeout=150, ckpt=str(tmp / "ckpt"),
                     batch=_batch(4), lr=LR, max_seq=MAX, gen=GEN), str(tmp / "ckpt")


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp4")
    return run_ranks("fsdp_basics", 4, tmp, timeout=150, ckpt=str(tmp / "ckpt"),
                     batch=_batch(4), lr=LR, max_seq=MAX, gen=GEN)


def _runs(two, four, world):
    return two[0] if world == 2 else four


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [] if tree is None else [np.asarray(tree)]


@pytest.mark.parametrize("world", [2, 4])
def test_gather_and_reduce_scatter_pair(two, four, world):
    """Exact: the forward concatenates every rank's block along the dim
    (1, then 0), the backward gives each rank the sum over ranks of the
    upstream gradients' chunk at its index."""
    ups = [np.arange(6.0 * world).reshape(2, 3 * world) * (r + 1) for r in range(world)]
    xs = [np.arange(6.0).reshape(2, 3) + 10 * r for r in range(world)]
    total = sum(ups)
    for r, out in enumerate(_runs(two, four, world)):
        y, g = out["pair1"]
        np.testing.assert_array_equal(y, np.concatenate(xs, axis=1))
        np.testing.assert_array_equal(g, total[:, 3 * r:3 * r + 3])
        y, g = out["pair0"]
        np.testing.assert_array_equal(y, np.concatenate(xs, axis=0))
        np.testing.assert_array_equal(g, total.reshape(2 * world, 3)[2 * r:2 * r + 2])


@pytest.mark.parametrize("world", [2, 4])
def test_reduce_scatter_on_gloo(two, four, world):
    """``reduce_scatter`` on ``gloo`` (an all-to-all and a local sum) equals
    an all-reduce then this rank's slice, along dim 0 and dim 1, gives the
    same bits when called again, and counts (P−1)/P of the tensor's bytes
    under "reduce_scatter" (and nothing as an all-to-all)."""
    for out in _runs(two, four, world):
        rs = out["reduce_scatter"]
        for dim in ("dim0", "dim1"):
            np.testing.assert_array_equal(*rs[dim])
        assert rs["again"]
        assert rs["wire"] == {"reduce_scatter": (world - 1) * rs["bytes"] // world}


# g_wq sums a stacked leaf's layer over up to 32,768 shard elements, four
# shards apart: a reordered fp32 sum (1.02e-6 of the largest measured on
# qwen3-moe's expert stack over (2, 2)), as the pods test allows 2e-6
_REL = {"q": 0.0, "g_theta": 1e-6, "g_wq": 2e-6}


def _check_fttq(f: dict):
    for name in ("q", "g_theta", "g_wq", "init_wq"):
        whole, shard = f[name]
        for a, b in zip(_leaves(whole), _leaves(shard)):
            assert a.shape == b.shape
            tol = _REL.get(name, 0.0) * max(np.abs(a).max(), 1e-30)
            if name == "init_wq":
                np.testing.assert_allclose(b, a, rtol=1e-6)
            else:
                assert np.abs(a - b).max() <= tol, name
    assert f["stats"][0] == f["stats"][1]
    np.testing.assert_allclose(f["norm"][1], f["norm"][0], rtol=1e-6)


@pytest.mark.parametrize("arch", ["granite-20b", "qwen3-moe-30b-a3b"])
@pytest.mark.parametrize("mesh", [(2, 1), (4, 1), (2, 2)])
def test_fttq_on_data_shards_uses_whole_leaf_statistics(two, four, mesh, arch):
    """The QAT codes of every rank's data (or data x model) shards, from
    statistics reduced over every axis that cuts the leaf, are the whole
    leaves' exactly; the θ gradient within 1e-6 of its largest, g_wq (the
    shards' sums over both axes) too; init_wq_tree within rtol 1e-6;
    ternary_stats' counts exact; the global norm within rtol 1e-6. The
    attention and MLP leaves are cut on D over "data" (qwen3-moe's router
    and expert stacks too)."""
    runs = two[0] if mesh == (2, 1) else four
    for out in runs:
        f = out["fttq"][mesh][arch]
        _check_fttq(f)
        assert "data" in f["cut"]["blocks/attn/wq"]
        if arch.startswith("qwen3"):
            assert "data" in f["cut"]["blocks/moe/router"]
            assert "data" in f["cut"]["blocks/moe/w_in"]
        if mesh == (2, 2):
            assert f["cut"]["blocks/attn/wq"] == ("model", "data")


@pytest.mark.parametrize("world", [2, 4])
def test_train_step_on_data_shards_matches_one_device(two, four, world):
    """One step of olmo-1b (reduced) from the seed-0 state on (world, 1):
    loss within rtol 1e-6 of one device, the clip's global norm (each
    shard's Σg² summed over "data") within rtol 1e-5, the w_q after their
    step (divided by the whole leaf's count) within rtol 1e-5, the params
    within 1e-6 except where |g| < 1e-6, which Adam's first step moves by
    up to lr either way (``assert_step_matches``'s rule); every 2-D weight
    is cut over "data"."""
    for out in _runs(two, four, world):
        st = out["step"]
        np.testing.assert_allclose(st["loss"][1], st["loss"][0], rtol=1e-6)
        np.testing.assert_allclose(st["grad_norm"][1], st["grad_norm"][0], rtol=1e-5)
        for a, b in zip(_leaves(st["wq"][0]), _leaves(st["wq"][1])):
            np.testing.assert_allclose(b, a, rtol=1e-5)
        for a, b, m in zip(_leaves(st["params"][0]), _leaves(st["params"][1]),
                           _leaves(st["m"])):
            small = np.abs(m) < 1e-7
            np.testing.assert_allclose(b[~small], a[~small], rtol=0, atol=1e-6)
            assert np.all(np.abs(b[small] - a[small]) <= 2 * LR)
        assert all(c == ("data",) for c in st["shards"].values())
        assert "blocks/mlp/w_out" in st["shards"]


def test_step_refuses_a_whole_state(two):
    """A state made without the mesh is not this rank's shards: the step
    raises ``ValueError`` naming the leaf."""
    for out in two[0]:
        assert out["layout_error"] is not None
        assert ".params/blocks/attn/wk" in out["layout_error"]


@pytest.mark.parametrize("kind", ["raw", "tern"])
def test_checkpoint_from_data_shards_is_the_one_device_file(two, kind):
    """A TrainState (raw) and its params (ternary: one encode of the
    gathered leaves) saved from two data ranks' shards: the same bytes as
    the one-device save; restored with the mesh, every shard equal."""
    ranks, ckpt = two
    step = "step_000000000001"
    for name in ("state.msgpack", "meta.json"):
        with open(os.path.join(ckpt, f"fsdp-{kind}", step, name), "rb") as f:
            got = f.read()
        with open(os.path.join(ckpt, f"one-{kind}", step, name), "rb") as f:
            assert got == f.read(), name
    assert all(r["restored_equal"] for r in ranks)


def test_reference_restores_the_fsdp_checkpoint(two):
    """The reference reads the raw file saved from data shards into its own
    TrainState: every param and moment equals the port's whole state."""
    ranks, ckpt = two
    example = jinit_train_state(JC.get_reduced("olmo-1b"), JTrainerConfig(pod_compression=False),
                                jadam(LR), jax.random.PRNGKey(0))
    state, _ = jrestore_checkpoint(os.path.join(ckpt, "fsdp-raw"), example_state=example)
    want = ranks[0]["state"]
    for got, ref in ((state.params, want["params"]), (state.opt_state["m"],
                                                      want["opt_state"]["m"]),
                     (state.opt_state["v"], want["opt_state"]["v"])):
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
            np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_elastic_reshard_of_an_fsdp_state(four, shape):
    """A (2, 2) FSDP x TP state, gathered and re-placed as DTensors onto
    two ranks (Shard on "model" or "data" where the specs say), takes the
    same step bit for bit as its ``shard_state`` shards there."""
    assert all(r["elastic"][shape] for r in four[:2])


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-moe-30b-a3b", "zamba2-1.2b",
                                  "llama-3.2-vision-11b"])
def test_prefill_and_decode_on_data_shards_match_one_device(two, arch):
    """Prefill and greedy decode on (2, 1) data shards (each layer gathers
    its weights, the batch and cache whole): logits within 1e-5 of max
    |logits| of one device, the same greedy tokens, both ranks alike; the
    converted shards equal ``init_params(..., mesh=)``'s."""
    ranks, _ = two
    for r in ranks:
        got = r["serve"][arch]
        assert got["converted_shards_equal"]
        for a, b in zip(got["fsdp"]["logits"], got["one"]["logits"]):
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
        for a, b in zip(got["fsdp"]["tokens"], got["one"]["tokens"]):
            np.testing.assert_array_equal(a, b)


def _held_to_one_device(out: dict) -> None:
    """``fsdp_step``'s results: loss within rtol 2e-6 of one device, the
    params within 1e-6 where |g| ≥ 1e-6 and within Adam's first-step bound
    2·lr elsewhere (``assert_step_matches``'s rule)."""
    for arch, got in out.items():
        np.testing.assert_allclose(got["loss"][1], got["loss"][0], rtol=2e-6, err_msg=arch)
        for a, b, m in zip(_leaves(got["params"][0]), _leaves(got["params"][1]),
                           _leaves(got["m"])):
            small = np.abs(m) < 1e-7
            assert np.abs(a - b)[~small].max(initial=0.0) <= 1e-6, arch
            assert np.abs(a - b)[small].max(initial=0.0) <= 2 * 3e-3, arch


def test_fsdp_step_gathers_and_reduce_scatters_each_weight_once(tmp_path):
    """One FSDP step of olmo-1b and qwen3-moe-30b-a3b (reduced) from the
    state made on the (2, 1) mesh, held to the one-device step; under remat
    "none" each data-cut weight is all-gathered once in the forward (the
    other rank's half: (P−1) · its shard's bytes) and its gradient
    reduce-scattered once ((P−1)/P of the whole leaf's bytes): both counters
    are half the data-cut leaves' bytes. olmo's all-gathers are its
    weights' alone; qwen3-moe's MoE also gathers the ranks' routing rows."""
    ranks = run_ranks("fsdp_step", 2, tmp_path, timeout=120)
    for out in ranks:
        _held_to_one_device(out)
        for arch, got in out.items():
            half = got["data_cut_bytes"] // 2
            assert got["wire"]["reduce_scatter"] == half, arch
            if arch == "olmo-1b":
                assert got["wire"]["all_gather"] == half
            else:
                assert got["wire"]["all_gather"] > half


def _cli(rank: int, world: int, rdv: str, *extra) -> subprocess.Popen:
    env = _env({"RANK": str(rank), "WORLD_SIZE": str(world)})
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--preset", "1m",
         "--steps", "3", "--log-every", "3", "--batch", "4", "--seq", "32",
         "--init-method", f"file://{rdv}", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)


def _final(out: str) -> float:
    return float(out.strip().splitlines()[-1].split(":")[-1])


def test_train_cli_with_two_data_ranks(tmp_path):
    """``WORLD_SIZE=2 --model 1 --preset 1m`` on two processes (mesh (1, 2,
    1): FSDP over "data"): rank 0 prints, and the final loss equals the
    one-process CLI's within rtol 1e-5."""
    procs = [_cli(r, 2, str(tmp_path / "rdv"), "--model", "1") for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), logs
    assert "ranks=2 model=1" in logs[0] and logs[1].strip() == ""
    one = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
                          "--preset", "1m", "--steps", "3", "--log-every", "3", "--batch", "4",
                          "--seq", "32"], capture_output=True, text=True, env=_env(), cwd=REPO,
                         timeout=120)
    assert one.returncode == 0, one.stdout + one.stderr
    np.testing.assert_allclose(_final(logs[0]), _final(one.stdout), rtol=1e-5)
