"""Helpers for the port's multi-device tests on the CPU.

``run_ranks`` starts ``world`` processes of ``_torch_dist_cases.py`` (torch
and the port only, no JAX), each a ``gloo`` rank that meets the others
through a ``file://`` rendezvous in the test's ``tmp_path`` (no port is
fixed), runs one case and writes its results to ``tmp_path``. Every rank
has a deadline: a rank that fails or hangs fails the test, and every
process is killed. ``run_jax`` runs reference code in a subprocess whose
JAX sees ``n`` forced host devices, as ``tests/test_parallel.py`` does.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import textwrap
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = os.path.join(REPO, "tests", "_torch_dist_cases.py")


def _env(extra: dict | None = None) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra or {})
    return env


def run_ranks(case: str, world: int, tmp_path, timeout: float = 90.0, **kwargs) -> list:
    """Run ``case`` on ``world`` gloo ranks; returns each rank's results in
    rank order. ``kwargs`` (picklable) reach the case as its arguments."""
    work = str(tmp_path / f"{case}-{world}")
    os.makedirs(work, exist_ok=True)
    with open(os.path.join(work, "args.pkl"), "wb") as f:
        pickle.dump(kwargs, f)
    logs = [os.path.join(work, f"log{r}.txt") for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen([sys.executable, CASES, case, str(r), str(world), work],
                                          stdout=log, stderr=subprocess.STDOUT, env=_env()))
    deadline = time.monotonic() + timeout
    try:
        for r, p in enumerate(procs):
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
            if p.returncode != 0:
                with open(logs[r]) as f:
                    raise AssertionError(f"rank {r} of {case!r} exited {p.returncode}:\n"
                                         f"{f.read()[-3000:]}")
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{case!r} on {world} ranks did not finish in {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for r in range(world):
        with open(os.path.join(work, f"out{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def run_jax(code: str, n: int, tmp_path, timeout: float = 240.0):
    """Run ``code`` (which pickles its results to the path in ``OUT``) in a
    subprocess with ``n`` forced host devices; returns those results."""
    out = str(tmp_path / f"jax-{n}-{abs(hash(code))}.pkl")
    env = _env({"XLA_FLAGS": f"--xla_force_host_platform_device_count={n}",
                "JAX_PLATFORMS": "cpu"})
    run = subprocess.run(
        [sys.executable, "-c", f"OUT = {out!r}\n" + textwrap.dedent(code)],
        capture_output=True, text=True, env=env, timeout=timeout)
    assert run.returncode == 0, run.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)
