"""Readings for the limits that decide ``correct``: a cell's compared numbers
over many seeds in one process, for the program as it is (``sound``), for
the control (the plain reference at the precision below the configuration's,
in the program's place: ``--control``) and for each planted fault
(``--fault NAME``, as the cell's driver names them).

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,3 --seconds 2 \\
        [--control | --fault state_unchanged] [--set batch_size=250]

Prints one JSON line a seed: the mode, the seed, the checks and, for a run
with a window, its end-to-end values. The benchmark's own runs never run
the control or a fault.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated whole numbers")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", action="append", default=[])
    ap.add_argument("--set", action="append", default=[],
                    help="KEY=JSON: replace a key of the cell's file for these readings")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench import harness

    os.environ.update(harness.cache_env(ROOT))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    mode = "control" if args.control else ("fault:" + "+".join(args.fault) if args.fault
                                           else "sound")
    overrides = {k: json.loads(v) for k, v in (s.split("=", 1) for s in args.set)}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        line = harness.run_cell(ROOT, bench, args.workload, seed, args.seconds,
                                bool(args.trace), t0=t0, device=args.device,
                                faults=tuple(args.fault), control=args.control,
                                overrides=overrides)
        print(json.dumps({"workload": args.workload, "mode": mode, "seed": seed,
                          "set": overrides, "device": line["device"],
                          "breakdown": line.get("breakdown"),
                          "correct": line["correct"], "seconds": time.perf_counter() - t0,
                          "checks": {k: v["value"] for k, v in line["checks"].items()},
                          "metrics": {k: v["value"] for k, v in line["metrics"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
