#!/usr/bin/env python3
"""Time the serving deploy's quantize_pack encode on one NVIDIA GPU.

    python3 tools/quantize_pack_timing.py [--src CHECKOUT] [--dtype bfloat16|float32]

Builds olmo-1b at full width (seed 0) on the card with weights of the given
dtype, stages its quantized leaves as ``launch.serve``'s deploy does (one
segment each, ``chip_smoke.deploy_segments``) and times one
``quantize_pack_segments`` call with scales over them
(``chip_smoke.encode_trace``): the kernel's device ms from a torch.profiler
trace, the eager ms by CUDA events, and the host ms of the segment table.
``--src`` times the port of another checkout (its ``src/repro_torch``, its
kernel sources), so that two trees can be timed in turns in one session on
one card; the timing code is this checkout's. Prints the card and one JSON
line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=ROOT, help="the checkout whose port is timed")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("quantize_pack_timing: no CUDA device is present", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.abspath(args.src), "src"))
    sys.path.insert(1, ROOT)
    import dataclasses

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.core.fttq import FTTQConfig, is_quantizable
    from repro_torch.models.transformer import init_params
    from repro_torch.tree import flatten_with_path

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("olmo-1b"), param_dtype=args.dtype,
                              compute_dtype=args.dtype)
    fcfg = FTTQConfig()
    params = init_params(cfg, seed=0, device=dev)
    leaves = [leaf for p, leaf in flatten_with_path(params) if is_quantizable(p, leaf, fcfg)]
    rows, scal = chip_smoke.deploy_segments(leaves, fcfg)
    trace = chip_smoke.encode_trace(rows, scal, args.reps)
    print(chip_smoke.card_line())
    print(json.dumps({"src": os.path.abspath(args.src), "dtype": args.dtype,
                      "segments": len(rows), "weights": sum(r.numel() for r in rows),
                      **trace}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
