"""One bf16 train step of the port against the reference's, per arch, on the
CPU: the measurements behind the tolerances of
``tests/_torch_train_parity.py::assert_bf16_step_matches``.

For each arch at its reduced config, in the reference's production train
cell (bf16 params and compute, remat "full", ``TrainerConfig(qat=True)``,
adam(1e-4)), one step from the reference's state on the same batch, the
port's against the reference's step compiled two ways: with each bf16 op
rounded as its program writes it (``xla_allow_excess_precision=False``,
what the tests hold the port to) and with XLA's default, which lets a
fusion skip some of those roundings. It prints, per arch and compile: the
loss's and grad norm's relative gaps, the worst leaf's Adam m and v gap
relative to the leaf's largest value, the worst leaf's w_q gap relative to
its value, and the params' largest gap in bf16 ulps of the reference's
value; and the reference's own loss gap between its two compiles.

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tools/bf16_train_parity.py [arch ...]

It imports the JAX reference (CPU only). A run of all ten archs takes a
few minutes; ``--microbatches 2`` runs the microbatched cell.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

import _torch_train_parity as P
from repro_torch.configs import ARCH_IDS


def _gaps(ref, port) -> dict:
    (jnew, jm), (new, m) = ref, port
    out = {"loss": abs(float(m["loss"]) / float(jm["loss"]) - 1),
           "grad_norm": abs(float(m["grad_norm"]) / float(jm["grad_norm"]) - 1)}
    for name in ("m", "v"):
        out[name] = max(float(np.abs(b - a).max() / (np.abs(a).max() + 1e-30))
                        for a, b in P.pairs(jnew.opt_state[name], new.opt_state[name]))
    out["wq"] = max(float((np.abs(b - a) / np.abs(a).clip(1e-30)).max())
                    for a, b in P.pairs(jnew.wq, new.wq))
    out["params_ulps"] = max(float((np.abs(b - a) / P._ulp(a)).max())
                             for a, b in P.pairs(jnew.params, new.params))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("archs", nargs="*", default=list(ARCH_IDS))
    ap.add_argument("--microbatches", type=int, default=1)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    for arch in args.archs:
        row = {"arch": arch}
        for name, options in (("per_op", P.PER_OP), ("default", None)):
            cfg = P.TC.get_reduced(arch, **P.BF16)
            ref, port = P.train_steps(arch, 1, {"qat": True, "microbatches": args.microbatches},
                                      P.batch_np(cfg, b=2 * args.microbatches), P.BF16_LR,
                                      options, **P.BF16)
            row[name] = _gaps(ref[0], port[0])
            row[name + "_loss"] = float(ref[0][1]["loss"])
        row["reference_self_gap"] = abs(row["default_loss"] / row["per_op_loss"] - 1)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
