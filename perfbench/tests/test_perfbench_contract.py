"""``BENCHMARK.json`` against the benchmark's contract: its keys, names,
units, bounds and limits, and that every name it holds finds its file."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _text(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32 and all(_text(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _text(c["source"]) and _text(c["why"]) and c["file"] not in files
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
        files.add(c["file"])


def test_workloads_find_their_files():
    names = [w["name"] for w in BENCH["workloads"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(names)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(names) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _text(w["why"])
        assert w["chips"] in (1, 4)
        spec = json.loads((ROOT / "perfbench" / "workloads" / f"{w['name']}.json").read_text())
        assert (ROOT / "perfbench" / "drivers" / f"{spec['driver']}.py").is_file()
        assert spec["limits"] and all(v >= 0 for v in spec["limits"].values())


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    e2e = {}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        e2e[m["name"]] = set(m.get("workloads", cells))
    assert BENCH["end_to_end"][-1]["name"] == "setup_s" or "setup_s" in e2e
    assert e2e["setup_s"] == cells
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert _text(m["layer"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= e2e[m["moves"]]
        stem = m["name"].split(".")[0]
        assert any((ROOT / "perfbench" / "metrics" / f"{n}.py").is_file()
                   for n in (m["name"], stem))
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline") and m["unit"] == "%"
        for w in m["workloads"]:
            layers.setdefault(w, []).append(m["name"])
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for cell in cells:
        assert "setup_s" in {k for k, v in e2e.items() if cell in v}
        assert len([k for k, v in e2e.items() if cell in v]) >= 2
        assert layers.get(cell)
        assert any("mfu" in n for n in layers[cell])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_limit_is_held_by_the_driver(cell):
    spec = json.loads((ROOT / "perfbench" / "workloads" / f"{cell}.json").read_text())
    src = (ROOT / "perfbench" / "drivers" / f"{spec['driver']}.py").read_text()
    for name in spec["limits"]:
        assert f'lim["{name}"]' in src, name
