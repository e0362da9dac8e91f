"""Tensor parallelism beyond the train step, on two ``gloo`` CPU ranks: the
prefill and decode steps of ``launch/steps.py`` on a (1, 2) mesh against
one device, from the reference's weights; a checkpoint saved from the
ranks' shards against the one-device file (raw and ternary) and restored by
the reference; a state re-placed by ``elastic_reshard`` onto the mesh and
onto one rank; and ``launch/train.py --model 2`` against the one-process
CLI."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import repro.configs as JC
from repro.models import transformer as jtf
from repro.optim import adam as jadam
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import init_train_state as jinit_train_state
from repro.train import restore_checkpoint as jrestore_checkpoint
from _torch_dist import REPO, _env, run_ranks

ARCHS = ["olmo-1b", "granite-20b", "llama-3.2-vision-11b", "hubert-xlarge"]
B, S, MAX, GEN = 2, 8, 12, 3
LR = 3e-3


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp-serve")
    params = {}
    for arch in ARCHS:
        p = jtf.init_params(JC.get_reduced(arch), jax.random.PRNGKey(0))
        if arch.startswith("llama"):
            for gate in ("gate_attn", "gate_mlp"):
                p["cross"][gate] = p["cross"][gate] + 0.5
        params[arch] = jax.tree_util.tree_map(np.asarray, p)
    rng = np.random.default_rng(0)
    cfg = JC.get_reduced("llama-3.2-vision-11b")
    kw = dict(
        params=params, toks=rng.integers(0, 128, (B, S)).astype(np.int32),
        emb=(rng.normal(size=(B, S, 64)) * 0.02).astype(np.float32),
        vis=(rng.normal(size=(B, cfg.n_patches, 64)) * 0.02).astype(np.float32),
        max_seq=MAX, gen=GEN, ckpt=str(tmp / "ckpt"), lr=LR,
        batch={"tokens": rng.integers(0, 128, (B, 16)).astype(np.int32),
               "labels": rng.integers(0, 128, (B, 16)).astype(np.int32)})
    return run_ranks("tp_serve", 2, tmp, timeout=150, **kw), str(tmp / "ckpt")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_one_device(served, arch):
    """Next-token logits (B, 1, V) of the prefill and of each greedy decode
    step within 1e-5 of max |logits| of one device, the same greedy tokens,
    both ranks alike; the cache holds the rank's kv heads (olmo-1b 2 of 4;
    granite's MQA its one head; the vlm 1 of 2); hubert is one encoder
    forward (B, S, V), its vocabulary of 37 left whole by the guard."""
    ranks, _ = served
    for r in ranks:
        tp, one = r["serve"][arch]["tp"], r["serve"][arch]["one"]
        assert len(tp["logits"]) == len(one["logits"]) == (1 if arch == "hubert-xlarge"
                                                          else 1 + GEN)
        for a, b in zip(tp["logits"], one["logits"]):
            assert a.shape == b.shape and a.shape[-1] == JC.get_reduced(arch).vocab_size
            assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
        for a, b in zip(tp["tokens"], one["tokens"]):
            np.testing.assert_array_equal(a, b)
        if arch != "hubert-xlarge":
            n_kv = {"olmo-1b": 2, "granite-20b": 1, "llama-3.2-vision-11b": 1}[arch]
            assert tp["cache_k"][3] == n_kv and one["cache_k"][3] == JC.get_reduced(
                arch).n_kv_heads
    for a, b in zip(*(r["serve"][arch]["tp"]["logits"] for r in ranks)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["raw", "tern"])
def test_checkpoint_from_shards_is_the_one_device_file(served, kind):
    """A TrainState (raw) and its params (ternary: one encode of the
    gathered leaves) saved from the two ranks' shards: the same bytes as
    the one-device save; restored with the mesh, every shard equal."""
    ranks, ckpt = served
    step = "step_000000000001"
    for name in ("state.msgpack", "meta.json"):
        with open(os.path.join(ckpt, f"tp-{kind}", step, name), "rb") as f:
            got = f.read()
        with open(os.path.join(ckpt, f"one-{kind}", step, name), "rb") as f:
            assert got == f.read(), name
    assert all(r["restored_equal"] for r in ranks)


def test_reference_restores_the_tensor_parallel_checkpoint(served):
    """The reference reads the raw file saved from shards into its own
    TrainState: every leaf equals the port's whole state."""
    ranks, ckpt = served
    jcfg = JC.get_reduced("olmo-1b")
    example = jinit_train_state(jcfg, JTrainerConfig(pod_compression=False), jadam(LR),
                                jax.random.PRNGKey(0))
    state, _ = jrestore_checkpoint(os.path.join(ckpt, "tp-raw"), example_state=example)
    want = ranks[0]["state"]
    for a, b in zip(jax.tree_util.tree_leaves(state.params),
                    jax.tree_util.tree_leaves(want["params"])):
        np.testing.assert_array_equal(np.asarray(a), b)
    for a, b in zip(jax.tree_util.tree_leaves(state.opt_state["m"]),
                    jax.tree_util.tree_leaves(want["opt_state"]["m"])):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_elastic_reshard_of_a_tensor_parallel_state(served):
    """A state re-placed as DTensors (Shard on "model" where the specs say)
    takes the same TP step bit for bit as its ``shard_state`` shards; the TP
    result re-placed onto a one-rank mesh takes a one-device step bit for
    bit."""
    ranks, _ = served
    assert all(r["dtensor_step_identical"] for r in ranks)
    assert ranks[0]["one_rank_step_identical"]


def _cli(rank: int, world: int, rdv: str, *extra) -> subprocess.Popen:
    env = _env({"RANK": str(rank), "WORLD_SIZE": str(world)})
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--preset", "1m",
         "--steps", "3", "--log-every", "3", "--batch", "4", "--seq", "32",
         "--init-method", f"file://{rdv}", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)


def _final(out: str) -> float:
    return float(out.strip().splitlines()[-1].split(":")[-1])


def test_train_cli_with_two_model_ranks(tmp_path):
    """``--model 2 --preset 1m`` on two processes (mesh (1, 1, 2)): rank 0
    prints, and the final loss equals the one-process CLI's within rtol
    1e-5."""
    procs = [_cli(r, 2, str(tmp_path / "rdv"), "--model", "2") for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), logs
    assert "ranks=2 model=2" in logs[0] and logs[1].strip() == ""
    one = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
                          "--preset", "1m", "--steps", "3", "--log-every", "3", "--batch", "4",
                          "--seq", "32"], capture_output=True, text=True, env=_env(), cwd=REPO,
                         timeout=120)
    assert one.returncode == 0, one.stdout + one.stderr
    np.testing.assert_allclose(_final(logs[0]), _final(one.stdout), rtol=1e-5)
