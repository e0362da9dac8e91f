"""The harness of the port's benchmark: it finds a cell's files by the names
in ``BENCHMARK.json``, checks the card, times set-up and the measured
window, reads the trace, runs the per-layer readers, decides ``correct``
and prints the result line.

Everything that belongs to one configuration, one cell or one per-layer
metric is a file of its own, found by name:

- ``perfbench/configs/<config>.json`` (the path is the config's ``file``),
- ``perfbench/workloads/<cell>.json`` (its ``driver`` and parameters),
- ``perfbench/drivers/<driver>.py`` (``run(r: Run) -> Outcome``),
- ``perfbench/metrics/<metric>.py`` (``read(data: dict) -> float | None``),
  or the reader of the metric's stem, ``perfbench/metrics/<stem>.py``.

A driver sets up, calls ``Run.begin_window``, runs whole units, each ended
by ``Run.unit_done``, until that returns True, frees the program's state
and compares what the window produced with the plain reference
(``perfbench/reference``). The harness never imports JAX or the JAX
package, and refuses to print a result if either was loaded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Any

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
EXIT_NO_CARD = 3
EXIT_FORBIDDEN = 4


def sub_seed(seed: int, *salt) -> int:
    """A 63-bit seed drawn from ``seed`` and ``salt``: any whole ``seed``,
    however large, gives the same sub-seeds on every run."""
    digest = hashlib.sha256(repr((int(seed),) + tuple(salt)).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def cache_env(root: Path) -> dict:
    """Build and kernel caches at fixed paths inside the checkout, so only a
    cell's first run there builds or compiles. The port's own kernels build
    into ``build/repro_torch`` of the checkout (``kernels/_build.py``)."""
    base = root / "build" / "perfbench"
    return {"TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
            "TRITON_CACHE_DIR": str(base / "triton"),
            "PYTORCH_KERNEL_CACHE_PATH": str(base / "torch_kernels"),
            "CUDA_CACHE_PATH": str(base / "nv_compute_cache")}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & FORBIDDEN)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Check:
    """One number compared with its limit: correct while ``value <= limit``
    (a NaN is never correct)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: units attempted and failed in the window,
    its end-to-end values by metric name, what the per-layer readers read
    (``layer``), and the checks that decide ``correct``."""

    attempted: int
    failed: int
    e2e: dict
    layer: dict
    checks: list


class Run:
    """One run of one cell: its files, seed and window, and the clock.

    An untraced run measures one window. A traced run measures three
    stages, each ``--seconds`` long and each of whole units: ``host`` with
    nothing attached (what ``mfu`` divides by), ``spans`` with the
    program's synchronizing timers on (``Run.instrumented``; only for a
    driver that sets ``SPANS``) and ``trace`` under ``torch.profiler``
    alone. A driver calls ``begin_window`` at the end of set-up, then
    ``unit_done`` after each whole unit until it returns True."""

    def __init__(self, root: Path, bench: dict, name: str, seed: int, seconds: float,
                 trace: bool, device: str, t0: float, faults: tuple = (),
                 control: bool = False, overrides: dict | None = None):
        self.root = Path(root)
        self.bench = bench
        self.cell = next((w for w in bench["workloads"] if w["name"] == name), None)
        if self.cell is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        conf = next(c for c in bench["configs"] if c["name"] == self.cell["config"])
        self.config = json.loads((self.root / conf["file"]).read_text())
        self.spec = json.loads((self.root / "perfbench" / "workloads" / f"{name}.json")
                               .read_text())
        self.spec.update(overrides or {})
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.t0 = t0
        self.faults = tuple(faults)
        self.control = control
        self.stages: tuple = ("window",)
        self.stats: dict[str, dict] = {}
        self.spans: dict[str, list[float]] = {}
        self.setup_s = None
        self.window_s = None
        self.setup_peak = 0
        self.window_peak = 0
        self.prof = None
        self._stage = -1
        self._s0 = None

    def plan(self, spans: bool) -> None:
        """The stages of this run: one window, or a traced run's three (two
        for a driver with no spans)."""
        if self.trace:
            self.stages = ("host",) + (("spans",) if spans else ()) + ("trace",)

    # -- seeds ---------------------------------------------------------
    def seeded(self, *salt) -> int:
        return sub_seed(self.seed, self.name, *salt)

    # -- the device clock ----------------------------------------------
    @property
    def cuda(self) -> bool:
        return str(self.device).startswith("cuda")

    @property
    def stage(self) -> str | None:
        return self.stages[self._stage] if 0 <= self._stage < len(self.stages) else None

    @property
    def instrumented(self) -> bool:
        """Whether the program's synchronizing timers are on: in the
        ``spans`` stage of a traced run alone."""
        return self.stage == "spans"

    def sync(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize()

    @contextlib.contextmanager
    def span(self, name: str):
        """Host seconds of the block, synchronized at both ends, kept under
        ``name``: in the ``spans`` stage only, so every other stage keeps
        the program's own overlap."""
        if not self.instrumented:
            yield
            return
        self.sync()
        t = time.perf_counter()
        try:
            yield
        finally:
            self.sync()
            self.spans.setdefault(name, []).append(time.perf_counter() - t)

    def mark(self, name: str):
        """A ``bench.<name>`` range in the trace stage's host trace (what
        the idle gaps are named by); nothing elsewhere."""
        if self.stage != "trace":
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(f"bench.{name}")

    def begin_window(self) -> None:
        """End of set-up: synchronize, record ``setup_s`` and the set-up
        peak, reset the peak, open the first stage."""
        import torch

        self.sync()
        if self.cuda:
            self.setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        self.setup_s = time.perf_counter() - self.t0
        self._open(0)

    def _open(self, i: int) -> None:
        self._stage = i
        if self.stage == "trace":
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
            self.prof = profile(activities=acts)
            self.prof.start()
            if self.cuda:
                # the session's first device event can be lost: this is it
                torch.ones(1, device=self.device).fill_(2.0)
            self.sync()
        self.stats[self.stage] = {"seconds": 0.0, "units": 0, "work": 0.0, "failed": 0}
        self._s0 = time.perf_counter()

    def unit_done(self, work: float, failed: int = 0) -> bool:
        """Count one whole unit and its work (tokens, samples) in the open
        stage; close the stage once ``--seconds`` have passed, and say
        whether the last stage has closed."""
        if self.stage is None:
            return True
        st = self.stats[self.stage]
        st["units"] += 1
        st["work"] += work
        st["failed"] += int(failed)
        if time.perf_counter() - self._s0 < self.seconds:
            return False
        self.sync()
        st["seconds"] = time.perf_counter() - self._s0
        last = self._stage == len(self.stages) - 1
        if last:
            self._close()
        else:
            self._open(self._stage + 1)
        return last

    def _close(self) -> None:
        import torch

        self.window_s = self.stats[self.stages[-1]]["seconds"]
        if self.cuda:
            self.window_peak = torch.cuda.max_memory_allocated()
        if self.prof is not None:
            self.prof.stop()
        self._stage = len(self.stages)

    def total(self, key: str) -> float:
        """``key`` summed over every stage."""
        return sum(st[key] for st in self.stats.values())

    def rate(self) -> float | None:
        """The untraced window's work a second."""
        st = self.stats.get("window")
        return st["work"] / st["seconds"] if st and st["seconds"] else None


def _metric_applies(metric: dict, cell: str, e2e_cells: dict) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or cell in e2e_cells.get(moves, ())


def e2e_cells(bench: dict) -> dict:
    """{end-to-end metric: the cells that report it}."""
    every = [w["name"] for w in bench["workloads"]]
    return {m["name"]: tuple(m.get("workloads", every)) for m in bench["end_to_end"]}


def run_cell(root: Path, bench: dict, name: str, seed: int, seconds: float, trace: bool, *,
             t0: float, device: str = "cuda", faults: tuple = (),
             control: bool = False, overrides: dict | None = None) -> dict:
    """One run of cell ``name``; returns the result line as a dict, its
    ``checks`` key last. ``overrides`` replaces keys of the cell's file (for
    readings only; the benchmark's runs pass none)."""
    r = Run(root, bench, name, seed, seconds, trace, device, t0, faults, control, overrides)
    if r.cuda:
        from repro_torch.kernels import _build

        _build.build_all()      # every kernel at once on a checkout's first run; else a lookup
    driver = load_module(r.root / "perfbench" / "drivers" / f"{r.spec['driver']}.py",
                         f"perfbench_driver_{r.spec['driver']}")
    r.plan(getattr(driver, "SPANS", False))
    out: Outcome = driver.run(r)
    cells = e2e_cells(bench)
    metrics: dict[str, Any] = {}
    device_info: dict[str, Any] = device_line(r)
    breakdown = None
    if not trace:
        for m in bench["end_to_end"]:
            if name not in cells[m["name"]]:
                continue
            if control and m["name"] not in out.e2e:
                continue        # the control has no window
            value = r.setup_s if m["name"] == "setup_s" else out.e2e[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        from perfbench import trace as trace_mod

        summary = trace_mod.reduce(r.prof, r.window_s) if r.prof is not None else None
        data = {"trace": summary, "stages": r.stats, "spans": r.spans,
                "config": r.config, "spec": r.spec, **out.layer}
        for m in bench["per_layer"]:
            if not _metric_applies(m, name, cells):
                continue
            value = metric_reader(r.root, m["name"]).read(data)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if summary is not None:
            device_info["busy_s"] = summary["busy_s"]
            device_info["window_s"] = r.window_s
            breakdown = {"device_ops": summary["device_ops"],
                         "idle_gaps": summary["idle_gaps"]}
    line = {"correct": all(c.ok for c in out.checks) and out.failed == 0,
            "attempted": out.attempted, "failed": out.failed, "metrics": metrics,
            "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in out.checks}
    return line


def metric_reader(root: Path, name: str):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, or
    where there is none the reader of its stem, ``metrics/<stem>.py`` (the
    name up to its first dot), which serves every cell kind."""
    base = Path(root) / "perfbench" / "metrics"
    path = base / f"{name}.py"
    if not path.is_file():
        path = base / f"{name.split('.')[0]}.py"
    return load_module(path, f"perfbench_metric_{path.stem.replace('.', '_')}")


def device_line(r: Run) -> dict:
    if not r.cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": int(r.cell.get("chips", 1)),
            "memory_peak_bytes": int(max(r.setup_peak, r.window_peak))}


def main(args, *, t0: float, root: Path) -> int:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    need = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"this cell needs {need} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return EXIT_NO_CARD
    line = run_cell(root, bench, args.workload, args.seed, args.seconds, bool(args.trace),
                    t0=t0)
    found = forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded in this process: {found}", file=sys.stderr)
        return EXIT_FORBIDDEN
    for cname, c in line["checks"].items():
        print(f"check {cname}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line))
    return 0
