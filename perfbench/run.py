"""Run one cell of the port's benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic driver and parameters are found by the
names in ``BENCHMARK.json`` (see ``perfbench/harness.py``). The run draws its
inputs and weights from ``--seed``, warms up the cell's own shapes, measures
whole units for ``--seconds``, checks what the window produced against the
plain reference and prints one JSON line: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics from a
``torch.profiler`` window. It exits non-zero, printing no result, without
the CUDA devices the cell asks for.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench import harness

    os.environ.update(harness.cache_env(ROOT))
    return harness.main(args, t0=T0, root=ROOT)


if __name__ == "__main__":
    sys.exit(main())
