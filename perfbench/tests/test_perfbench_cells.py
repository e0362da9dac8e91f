"""Every driver end to end on the CPU at tiny sizes, as the harness runs a
cell: the result line, ``correct`` on sound runs, ``correct`` false under
each planted fault and under the control, a cell and a per-layer metric
added from files alone, and the command's refusals."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
FAULTS = {"tiny.train": ("state_unchanged", "half_batch"),
          "tiny.fed_tfedavg": ("state_unchanged", "half_batch", "answer_altered", "half_fold"),
          "tiny.fed_fedavg": ("state_unchanged", "half_batch", "answer_altered", "half_fold"),
          "tiny.score": ("answer_altered", "half_batch")}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", sorted(tiny.TINY_CELLS))
def test_tiny_cell_is_correct(root, cell, trace):
    path, bench = root
    line = tiny.run_tiny(path, bench, cell, trace=trace)
    assert list(line)[-1] == "checks"
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    if trace:
        assert line["device"]["window_s"] > 0 and "breakdown" in line
        assert line["metrics"] and all(v["unit"] == "%" or v["value"] >= 0
                                       for v in line["metrics"].values())
        kind = {"train": "train", "fed": "fed", "score": "serve"}[
            tiny.TINY_CELLS[cell][1]["driver"]]
        assert line["metrics"][f"mfu.{kind}"]["value"] > 0
    else:
        driver = tiny.TINY_CELLS[cell][1]["driver"]
        want = {"train": "train_tokens_per_s", "fed": "fed_samples_per_s",
                "score": "serve_tokens_per_s"}[driver]
        assert line["metrics"][want]["value"] > 0
        assert line["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in sorted(FAULTS.items()) for f in fs])
def test_a_planted_fault_is_not_correct(root, cell, fault):
    path, bench = root
    line = tiny.run_tiny(path, bench, cell, faults=(fault,))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", ["tiny.score", "tiny.train"])
def test_the_control_is_not_correct(root, cell):
    """The plain reference in fp8 in the program's place fails the bf16
    cells. (A float32 configuration's control, TF32, has no CPU kernel.)"""
    path, bench = root
    line = tiny.run_tiny(path, bench, cell, control=True)
    assert not line["correct"], line["checks"]


def test_a_traced_run_measures_its_stages_apart():
    """A traced run's stages, in order: ``host`` with nothing attached,
    ``spans`` with the synchronizing timers on, ``trace`` under the
    profiler alone; each of whole units and at least ``--seconds`` long."""
    import time

    from perfbench import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    r = harness.Run(ROOT, bench, "resnet18.fed_tfedavg", 1, 0.02, True, "cpu",
                    time.perf_counter())
    r.plan(spans=True)
    assert r.stages == ("host", "spans", "trace")
    r.begin_window()
    seen = []
    while True:
        seen.append((r.stage, r.instrumented, r.prof is not None))
        with r.span("unit"):
            time.sleep(0.005)
        if r.unit_done(10.0):
            break
    stages = [s for s, _, _ in seen]
    assert stages == sorted(stages, key=["host", "spans", "trace"].index)
    assert {(s, i, p) for s, i, p in seen} == {("host", False, False), ("spans", True, False),
                                               ("trace", False, True)}
    assert len(r.spans["unit"]) == r.stats["spans"]["units"]
    for name, st in r.stats.items():
        assert st["seconds"] >= 0.02 and st["work"] == 10.0 * st["units"]
    assert r.window_s == r.stats["trace"]["seconds"] and r.rate() is None
    untraced = harness.Run(ROOT, bench, "resnet18.fed_tfedavg", 1, 0.0, False, "cpu",
                           time.perf_counter())
    untraced.plan(spans=True)
    untraced.begin_window()
    assert not untraced.instrumented and untraced.unit_done(4.0)
    assert untraced.stages == ("window",) and untraced.rate() > 0


def test_a_cell_and_a_metric_are_added_by_files_alone(tmp_path):
    path, bench = tiny.make_root(tmp_path)
    (path / "perfbench" / "metrics" / "window_units.tiny.py").write_text(
        "def read(data):\n    return data['stages']['trace']['units'] or None\n")
    bench["per_layer"].append({"name": "window_units.tiny", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "trainer step", "moves": "train_tokens_per_s",
                               "workloads": ["tiny.train"]})
    (path / "BENCHMARK.json").write_text(json.dumps(bench))
    line = tiny.run_tiny(path, bench, "tiny.train", trace=True)
    assert 1 <= line["metrics"]["window_units.tiny"]["value"] < line["attempted"]
    assert line["metrics"]["window_units.tiny"]["unit"] == "steps"


def _command(cwd: Path, env_extra: dict | None = None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           "resnet18.fed_fedavg", "--seed", str(2 ** 31 + 7), "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_the_command_refuses_without_a_card():
    out = _command(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_command_fails_with_only_the_benchmarks_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
