"""``repro_torch.launch.env`` against ``repro.launch.env``: without the
re-exec, ``pin_runtime`` reports the same tcmalloc entry on this host (the
same candidates, present or not), sets the same allocation-report
threshold, and imports no jax; each package runs in its own clean
subprocess with the same environment."""

import json
import subprocess
import sys

from _torch_dist import REPO, _env

_PROBE = """
import json, os, sys
from {mod} import find_tcmalloc, pin_runtime
applied = pin_runtime(reexec=False)
print(json.dumps({{"tcmalloc": applied["tcmalloc"], "found": find_tcmalloc(),
                  "threshold": os.environ["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"],
                  "jax": any(k.split(".")[0] in ("jax", "jaxlib") for k in sys.modules)}}))
"""


def _probe(mod: str) -> dict:
    env = _env()
    for key in ("LD_PRELOAD", "REPRO_ENV_PINNED", "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"):
        env.pop(key, None)
    run = subprocess.run([sys.executable, "-c", _PROBE.format(mod=mod)], capture_output=True,
                         text=True, env=env, timeout=120, cwd=REPO)
    assert run.returncode == 0, run.stderr[-2000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


def test_pin_runtime_matches_the_reference_and_imports_no_jax():
    port, ref = _probe("repro_torch.launch.env"), _probe("repro.launch.env")
    assert port["tcmalloc"] == ref["tcmalloc"]
    assert port["found"] == ref["found"]
    assert port["threshold"] == ref["threshold"]
    assert not port["jax"]
