"""Pinned runtime configuration for benchmark runs (port of
``repro.launch.env``).

Numbers are comparable only when the process environment is: allocator
churn moves the measured microseconds. ``pin_runtime()`` applies the
standard config once, at the top of a benchmark's entry point:

  - ``LD_PRELOAD`` tcmalloc where the library exists on the host (a faster
    malloc for the host's staging and packing paths), by re-exec'ing the
    interpreter, since a preload cannot take effect after the process
    started; a host without tcmalloc skips it;
  - ``TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD`` raised so large staging
    buffers do not print allocation reports.

Two settings of the reference have no counterpart here. Its XLA log level
(``TF_CPP_MIN_LOG_LEVEL``) quiets XLA and TSL, which PyTorch does not
load. Its ``host_devices`` forces XLA's host-platform device count for its
512-device dry-run; the port's dry-run runs rank 0 of a one-process
"fake" process group instead (``launch.dryrun``), so no device count is
forced.
"""

from __future__ import annotations

import os
import sys

# re-exec guard: the environment variable survives the exec, a global does not
_REEXEC_MARKER = "REPRO_ENV_PINNED"

_TCMALLOC_CANDIDATES = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
    "/usr/lib/libtcmalloc.so.4",
)


def find_tcmalloc() -> str | None:
    """The first tcmalloc shared object present on this host, if any."""
    for path in _TCMALLOC_CANDIDATES:
        if os.path.exists(path):
            return path
    return None


def pin_runtime(*, tcmalloc: bool = True, reexec: bool = True) -> dict:
    """Apply the pinned runtime; returns what was applied. ``tcmalloc``
    preloads tcmalloc by one re-exec where the library exists and the
    process is not already running under it; ``reexec=False`` only reports
    (``"tcmalloc"`` is then None where it would have re-exec'd)."""
    applied: dict = {}
    os.environ.setdefault("TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD", "60000000000")
    lib = find_tcmalloc() if tcmalloc else None
    applied["tcmalloc"] = lib
    if lib and lib not in os.environ.get("LD_PRELOAD", ""):
        if reexec and not os.environ.get(_REEXEC_MARKER):
            os.environ[_REEXEC_MARKER] = "1"
            preload = os.environ.get("LD_PRELOAD", "")
            os.environ["LD_PRELOAD"] = f"{lib} {preload}".strip()
            sys.stdout.flush()
            sys.stderr.flush()
            os.execv(sys.executable, [sys.executable] + sys.argv)
        applied["tcmalloc"] = None     # present but not preloaded this run
    return applied
