"""Nothing the benchmark runs imports JAX, Flax or the JAX package
(``repro``), and the plain references import nothing of the program
(``repro_torch``) either: each checked in a fresh interpreter, by the
top-level names of ``sys.modules`` compared whole."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "perfbench"

_PROBE = """
import importlib.util, json, sys
sys.path[:0] = {paths!r}
for name in {modules!r}:
    importlib.import_module(name)
for i, path in enumerate({files!r}):
    spec = importlib.util.spec_from_file_location(f"probe_{{i}}", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_after(modules: list, files: list = ()) -> set:
    code = _PROBE.format(paths=[str(ROOT / "src"), str(ROOT)], modules=modules,
                         files=[str(f) for f in files])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _modules(sub: str) -> list:
    return [f"perfbench.{sub}.{p.stem}" for p in sorted((PB / sub).glob("*.py"))]


def test_harness_and_drivers_import_no_jax():
    mods = (["perfbench", "perfbench.harness", "perfbench.trace", "perfbench.common",
             "perfbench.readings"] + _modules("drivers") + _modules("counts")
            + _modules("reference")
            # what the drivers import of the program, at module level
            + ["repro_torch.train", "repro_torch.fed.simulation",
               "repro_torch.launch.serve_loop", "repro_torch.models.paper_models",
               "repro_torch.kernels._build"])
    files = [PB / "run.py"] + sorted((PB / "metrics").glob("*.py"))
    found = _top_level_after(mods, files)
    assert not found & {"jax", "jaxlib", "flax", "repro"}, sorted(found)


def test_reference_imports_nothing_of_the_program():
    found = _top_level_after(_modules("reference") + _modules("counts"))
    assert not found & {"jax", "jaxlib", "flax", "repro", "repro_torch"}, sorted(found)


def test_forbidden_modules_compares_whole_names():
    from perfbench import harness

    saved = {k: sys.modules.get(k) for k in ("repro", "repro_torch_probe")}
    try:
        sys.modules["repro_torch_probe"] = sys.modules[__name__]
        assert "repro" not in harness.forbidden_modules()
        sys.modules["repro"] = sys.modules[__name__]
        assert "repro" in harness.forbidden_modules()
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
