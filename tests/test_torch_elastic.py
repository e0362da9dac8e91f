"""The elastic re-mesh after a pod loss and the ``--pods`` train CLI, on
``gloo`` CPU ranks (the port only; the reference's own elastic test fails,
so the port is held to its one-process step)."""

import subprocess
import sys

import numpy as np

from _torch_dist import REPO, _env, run_ranks

LR = 2e-3
CFG = dict(name="t", family="dense", n_layers=2, d_model=64, vocab_size=128, n_heads=4,
           n_kv_heads=2, head_dim=16, d_ff=128)
TCFG = dict(qat=True, pod_compression=True, error_feedback=True)


def test_elastic_reshard_after_pod_loss(tmp_path):
    """One compressed step on 2 pods, then the whole state (params, w_q,
    Adam's moments and step, the gathered residuals, the step counter)
    re-placed onto a 1-pod mesh of the surviving rank as DTensors: bit for
    bit the state it was, and its next step bit for bit a one-process step
    from that state."""
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, 128, (8, 16)).astype(np.int32),
             "labels": rng.integers(0, 128, (8, 16)).astype(np.int32)}
    ranks = run_ranks("elastic", 2, tmp_path, timeout=120, cfg=CFG, tcfg=TCFG, batch=batch,
                      lr=LR)
    r = ranks[0]
    assert r["all_dtensors"] and r["n_leaves"] > 0
    assert r["identical"]
    assert r["next_identical"] and r["loss1"] == r["loss0"]
    assert r["residual_shape"] == (2, 128, 64)
    assert np.isfinite(r["loss1"]) and ranks[1]["loss2"] == r["loss2"]


def _cli(rank: int, world: int, rdv: str, *extra) -> subprocess.Popen:
    env = _env({"RANK": str(rank), "WORLD_SIZE": str(world)})
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--preset", "1m",
         "--steps", "3", "--log-every", "3", "--batch", "4", "--seq", "32",
         "--init-method", f"file://{rdv}", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)


def _final(out: str) -> float:
    return float(out.strip().splitlines()[-1].split(":")[-1])


def test_train_cli_with_two_pods(tmp_path):
    """``--pods 2`` on two processes with a file rendezvous: it trains,
    rank 0 prints, and the exact-sync run (``--no-pod-compression``) ends
    where one process on the same global batches ends, within rtol 1e-5."""
    outs = {}
    for name, extra in (("compressed", ["--pods", "2"]),
                        ("exact", ["--pods", "2", "--no-pod-compression"])):
        procs = [_cli(r, 2, str(tmp_path / f"rdv-{name}"), *extra) for r in range(2)]
        try:
            logs = [p.communicate(timeout=120)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        assert all(p.returncode == 0 for p in procs), logs
        assert "pods=2 ranks=2" in logs[0] and logs[1].strip() == ""
        outs[name] = _final(logs[0])
    one = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
                          "--preset", "1m", "--steps", "3", "--log-every", "3", "--batch", "4",
                          "--seq", "32"], capture_output=True, text=True, env=_env(), cwd=REPO,
                         timeout=120)
    assert one.returncode == 0, one.stdout + one.stderr
    np.testing.assert_allclose(outs["exact"], _final(one.stdout), rtol=1e-5)
    assert np.isfinite(outs["compressed"])
