"""On the card, at each cell's own size: the control (the plain reference
at the precision below the configuration's, in the program's place) and
every fault the cell's driver can plant come out ``correct`` false, and a
sound run comes out true. Marked ``gpu``; each test skips where torch sees
no CUDA device.

    PYTHONPATH=src python -m pytest -q -m gpu perfbench/tests/test_perfbench_gpu.py
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2 ** 31 + 12345


def _driver(cell: str):
    spec = json.loads((ROOT / "perfbench" / "workloads" / f"{cell}.json").read_text())
    return harness.load_module(ROOT / "perfbench" / "drivers" / f"{spec['driver']}.py",
                               f"perfbench_driver_{spec['driver']}")


CASES = [(w["name"], mode) for w in BENCH["workloads"]
         for mode in ("sound", "control") + tuple(_driver(w["name"]).FAULTS)]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    os.environ.update(harness.cache_env(ROOT))


@pytest.mark.gpu
@pytest.mark.parametrize("cell,mode", CASES)
def test_control_and_faults_fail_at_the_cells_size(card, cell, mode):
    faults = () if mode in ("sound", "control") else (mode,)
    line = harness.run_cell(ROOT, BENCH, cell, SEED, 2.0, False, t0=time.perf_counter(),
                            device="cuda", faults=faults, control=mode == "control")
    assert line["correct"] == (mode == "sound"), line["checks"]
