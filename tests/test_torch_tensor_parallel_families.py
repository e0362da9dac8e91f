"""Tensor parallelism for the moe, ssm and hybrid families, module by
module, on two ``gloo`` CPU ranks of a (1, 2) data x model mesh, each
against the port's one-device function (which the other test files hold to
the reference): the MoE layer with local experts, the Mamba2 block with
gathered weights, zamba2's loss and shared block, FTTQ on the new shards,
prefill and decode, a checkpoint saved from shards (and restored by the
reference), ``elastic_reshard`` of a moe state, and ``launch/train.py
--model 2`` for a moe and an ssm arch (``tests/_torch_dist_cases.py``'s
``tp_families``)."""

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
GEN = 3


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp-families")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 128, (2, 16)).astype(np.int32),
             "labels": rng.integers(0, 128, (2, 16)).astype(np.int32)}
    return run_ranks("tp_families", 2, tmp, timeout=150, ckpt=str(tmp / "ckpt"), lr=LR,
                     batch=batch, gen_steps=GEN), str(tmp / "ckpt")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [] if tree is None else [np.asarray(tree)]


def _close(got, want, tol):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("case", ["qwen3", "deepseek", "deepseek_whole_experts"])
def test_moe_layer_with_local_experts(ranks, case):
    """The MoE layer's output plus its aux loss within 1e-6 of the largest
    |value| of one device's, and the gradients of x and of every leaf
    (expert and shared shards gathered) within 1e-6 of each one's largest;
    every rank routed the tokens as one device (the same top-k indices).
    qwen3-moe's and deepseek-moe's expert stacks are split by expert,
    deepseek's shared experts by their hidden units; with 5 experts the
    guard leaves the stacks whole, and only the shared experts are split."""
    split = {"qwen3": (0, None), "deepseek": (0, 1), "deepseek_whole_experts": (None, 1)}[case]
    for out in ranks[0]:
        m = out["moe"][case]
        assert (m["split"]["experts"], m["split"]["shared"]) == split
        _close(m["y"][1], m["y"][0], 1e-6)
        for a, b in zip(*m["grads"]):
            _close(b, a, 1e-6)
        np.testing.assert_array_equal(m["idx"], m["idx_one"])


@pytest.mark.parametrize("case", ["mamba2", "one_head", "odd"])
def test_mamba_block_with_gathered_weights(ranks, case):
    """The Mamba2 block forward and backward on its shards equals one device
    bit for bit: the gathered weights make every rank compute the whole
    block. mamba2-370m (reduced) splits in_proj's 276 columns, conv_w's 144
    channels and out_proj's 128 rows; with one SSM head in_proj's 273
    columns stay whole while conv_w and out_proj split; with d_model 63 and
    expand 1 every leaf stays whole."""
    dims = {"mamba2": {"in_proj": 1, "conv_w": 1, "out_proj": 0},
            "one_head": {"in_proj": None, "conv_w": 1, "out_proj": 0},
            "odd": {"in_proj": None, "conv_w": None, "out_proj": None}}[case]
    for out in ranks[0]:
        m = out["mamba"][case]
        assert m["dims"] == dims
        np.testing.assert_array_equal(m["y"][1], m["y"][0])
        for a, b in zip(*m["grads"]):
            np.testing.assert_array_equal(b, a)


def test_hybrid_loss_collectives_and_shared_block(ranks):
    """zamba2 (reduced: 5 Mamba2 layers, the shared block applied 3 times):
    the TP loss equals one device's within rtol 2e-6; every gradient,
    gathered, within 2e-5 of its leaf's largest (the summation orders of
    the row-parallel shared block, amplified through the backbone: 5.7e-6
    to 8.2e-6 measured); the forward and backward take exactly 4 + 4·3
    all-reduces (the embedding's, the CE's two and the logits' copy; per
    application of the shared block two forward and two backward) and 3·5
    all-gathers (each Mamba2 layer's three weights): no collective per
    application beyond its attention and MLP. The shared block alone on a
    cache: its output within 1e-6, and its cache holding the rank's 2 of 4
    kv heads, which gathered are one device's."""
    for out in ranks[0]:
        z = out["zamba2"]
        np.testing.assert_allclose(z["loss"][1], z["loss"][0], rtol=2e-6)
        for a, b in zip(*z["grads"]):
            _close(b, a, 2e-5)
        assert z["apps"] == 3
        assert z["counts"] == {"all_reduce": 4 + 4 * 3, "all_gather": 3 * 5}
        _close(z["shared"]["y"][1], z["shared"]["y"][0], 1e-6)
        np.testing.assert_array_equal(z["shared"]["k"][1], z["shared"]["k"][0])


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "zamba2-1.2b"])
def test_fttq_on_expert_mamba_and_shared_block_shards(ranks, arch):
    """The QAT forward on the shards, from each leaf's whole statistics,
    gathered equals the whole leaves' bit for bit: expert stacks (L, E/2,
    D, F) and conv_w (L, W, C/2) with a factor per layer, in_proj and
    out_proj shards, and the shared block's 2-D leaves with one factor;
    init_wq_tree within rtol 1e-6 and ternary_stats exact."""
    want = {"deepseek-moe-16b": {"blocks/moe/w_in", "blocks/moe/w_out",
                                 "blocks/moe/shared/w_in"},
            "zamba2-1.2b": {"blocks/mamba/conv_w", "blocks/mamba/in_proj",
                            "blocks/mamba/out_proj", "shared_attn/attn/wq",
                            "shared_attn/mlp/w_out"}}[arch]
    for out in ranks[0]:
        f = out["fttq"][arch]
        assert want <= set(f["sharded"])
        for a, b in zip(_leaves(f["q"][0]), _leaves(f["q"][1])):
            np.testing.assert_array_equal(b, a)
        for a, b in zip(_leaves(f["init_wq"][0]), _leaves(f["init_wq"][1])):
            np.testing.assert_allclose(b, a, rtol=1e-6)
        assert f["stats"][0] == f["stats"][1]


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b", "qwen3-moe-30b-a3b"])
def test_prefill_and_decode_match_one_device(ranks, arch):
    """Next-token logits (B, 1, V) of the prefill and of each greedy decode
    step within 1e-5 of max |logits| of one device, the same tokens, both
    ranks alike; the SSM cache cut as the reference's ``cache_specs`` cuts
    it, each rank's conv window half the channels and its SSD state half
    the heads (mamba2-370m and zamba2-1.2b decode on them), the attention
    caches holding the rank's kv heads (zamba2's shared block 2 of 4,
    qwen3-moe's 1 of 2). The shards are ``params_from_jax(...,
    mesh=, specs=)`` of the whole params, equal to ``init_params(...,
    mesh=)``'s."""
    for out in ranks[0]:
        assert out["serve"][arch]["converted_shards_equal"]
        tp, one = out["serve"][arch]["tp"], out["serve"][arch]["one"]
        assert len(tp["logits"]) == len(one["logits"]) == 1 + GEN
        for a, b in zip(tp["logits"], one["logits"]):
            assert a.shape == b.shape == (2, 1, 128)
            assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
        for a, b in zip(tp["tokens"], one["tokens"]):
            np.testing.assert_array_equal(a, b)
        for key, shape in one["cache"].items():
            got = tp["cache"][key]
            if key == "conv":
                assert got[3] * 2 == shape[3] and got[:3] == shape[:3]
            elif key == "ssd":
                assert got[2] * 2 == shape[2] and got[:2] == shape[:2] \
                    and got[3:] == shape[3:]
            else:
                assert got[3] * 2 == shape[3] and got[:3] == shape[:3]
    for a, b in zip(*(r["serve"][arch]["tp"]["logits"] for r in ranks[0])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["raw", "tern"])
def test_moe_checkpoint_from_shards_is_the_one_device_file(ranks, kind):
    """A deepseek-moe TrainState (raw) and its params (ternary: one encode of
    the gathered leaves) saved from the two ranks' expert and shared-expert
    shards: the same bytes as the one-device save; restored with the mesh,
    every shard equal."""
    out, ckpt = ranks
    step = "step_000000000001"
    for name in ("state.msgpack", "meta.json"):
        with open(os.path.join(ckpt, f"tp-{kind}", step, name), "rb") as f:
            got = f.read()
        with open(os.path.join(ckpt, f"one-{kind}", step, name), "rb") as f:
            assert got == f.read(), name
    assert all(r["restored_equal"] for r in out)


def test_reference_restores_the_moe_tensor_parallel_checkpoint(ranks):
    """The reference reads the raw deepseek-moe file saved from shards into
    its own TrainState: every param and first moment equals the port's
    whole state."""
    out, ckpt = ranks
    jcfg = JC.get_reduced("deepseek-moe-16b")
    example = jinit_train_state(jcfg, JTrainerConfig(pod_compression=False), jadam(LR),
                                jax.random.PRNGKey(0))
    state, _ = jrestore_checkpoint(os.path.join(ckpt, "tp-raw"), example_state=example)
    want = out[0]["state"]
    for a, b in zip(jax.tree_util.tree_leaves(state.params),
                    jax.tree_util.tree_leaves(want["params"])):
        np.testing.assert_array_equal(np.asarray(a), b)
    for a, b in zip(jax.tree_util.tree_leaves(state.opt_state["m"]),
                    jax.tree_util.tree_leaves(want["opt_state"]["m"])):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_elastic_reshard_of_a_moe_tensor_parallel_state(ranks):
    """A deepseek-moe state re-placed as DTensors (Shard on "model" of the
    expert dim and of the shared experts' hidden dim) takes the same TP step
    bit for bit as its ``shard_state`` shards; that step against the
    one-device step: loss within rtol 2e-6, params within 1e-5 of each
    leaf's largest."""
    out, _ = ranks
    assert all(r["dtensor_step_identical"] for r in out)
    for r in out:
        l0, l1, p0, p1 = r["step_vs_one"]
        np.testing.assert_allclose(l1, l0, rtol=2e-6)
        for a, b in zip(_leaves(p0), _leaves(p1)):
            _close(b, a, 1e-5)


def _cli(arch: str, rank: int | None, rdv: str | None):
    env = _env({} if rank is None else {"RANK": str(rank), "WORLD_SIZE": "2"})
    extra = [] if rank is None else ["--model", "2", "--init-method", f"file://{rdv}"]
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--arch", arch,
         "--steps", "3", "--log-every", "3", "--batch", "4", "--seq", "16", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mamba2-370m"])
def test_train_cli_with_two_model_ranks(tmp_path, arch):
    """``--model 2 --arch`` on two processes (mesh (1, 1, 2)): rank 0 prints,
    and the final loss equals the one-process CLI's within rtol 1e-5."""
    procs = [_cli(arch, r, str(tmp_path / "rdv")) for r in range(2)] + [_cli(arch, None, None)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), logs
    assert "ranks=2 model=2" in logs[0] and logs[1].strip() == ""
    final = [float(log.strip().splitlines()[-1].split(":")[-1]) for log in (logs[0], logs[2])]
    np.testing.assert_allclose(final[0], final[1], rtol=1e-5)
