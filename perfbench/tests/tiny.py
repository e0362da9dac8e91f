"""Tiny cells of every driver for the CPU tests: a copy of the benchmark's
files in a scratch root, with configurations and cells small enough for a
CPU, and ``run_tiny`` to run one of them as the harness does."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY_CONFIGS = {
    "olmo-tiny": {
        "source": "test", "dtype": "bfloat16",
        "model": {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "d_ff": 128,
                  "vocab_size": 256, "norm": "nonparam", "gated_mlp": True,
                  "activation": "silu", "tie_embeddings": True, "rope_theta": 10000.0},
        "fttq": {"t_k": 0.7, "server_delta": 0.05}, "reduced": []},
    "resnet-tiny": {
        "source": "test", "dtype": "float32",
        "model": {"width": 32, "blocks": 8, "downsample_blocks": [2, 4, 6], "n_classes": 10,
                  "image_hw": [16, 16, 3], "clients": 8, "samples_per_client": 20, "noise": 3.0},
        "fttq": {"t_k": 0.7, "server_delta": 0.05}, "reduced": []},
}

TINY_CELLS = {
    "tiny.train": ("olmo-tiny", {
        "driver": "train", "batch": 4, "seq": 32, "microbatches": 2, "remat": "full",
        "lr": 1e-3, "reference_steps": 2,
        "limits": {"first_grad_diff": 0.05, "change_norm_gap": 2e-3,
                   "codes_differ_share": 0.0}}),
    "tiny.fed_tfedavg": ("resnet-tiny", {
        "driver": "fed", "algorithm": "tfedavg", "participation": 0.25, "local_epochs": 2,
        "batch_size": 10, "lr": 1e-3,
        "limits": {"upload_scale_gap": 0.01,
                   "upload_change_norm_gap": 0.01, "upload_change_diff": 0.1, "fold_gap": 1e-5,
                   "broadcast_scale_gap": 1e-5}}),
    "tiny.fed_fedavg": ("resnet-tiny", {
        "driver": "fed", "algorithm": "fedavg", "participation": 0.25, "local_epochs": 2,
        "batch_size": 10, "lr": 1e-3,
        "limits": {"upload_change_norm_gap": 0.01, "upload_change_diff": 0.1, "fold_gap": 1e-5,
                   "broadcast_scale_gap": 1e-5}}),
    "tiny.score": ("olmo-tiny", {
        "driver": "score", "max_batch": 4, "prompt_len": 16, "cache_bytes": 1 << 24,
        "residual": "fp16", "samples": 2, "sample_from_forwards": 2,
        "limits": {"logprob_gap": 0.015}}),
}


def make_root(tmp: Path) -> tuple[Path, dict]:
    """A root holding a copy of ``perfbench/`` and a ``BENCHMARK.json`` that
    adds the tiny configurations and cells to the real ones."""
    root = tmp / "root"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, conf in TINY_CONFIGS.items():
        path = f"perfbench/configs/{name}.json"
        (root / path).write_text(json.dumps(conf))
        bench["configs"].append({"name": name, "source": "test", "file": path, "reduced": [],
                                 "why": "a CPU test"})
    for cell, (conf, spec) in TINY_CELLS.items():
        (root / "perfbench" / "workloads" / f"{cell}.json").write_text(json.dumps(spec))
        bench["workloads"].append({"name": cell, "config": conf, "traffic": cell, "chips": 1,
                                   "why": "a CPU test"})
    driver_metric = {"train": "train_tokens_per_s", "fed": "fed_samples_per_s",
                     "score": "serve_tokens_per_s"}
    for cell, (_, spec) in TINY_CELLS.items():
        e2e = driver_metric[spec["driver"]]
        for m in bench["end_to_end"] + bench["per_layer"]:
            moved = m.get("moves", m["name"])
            if moved == e2e or m["name"] == "peak_mem_GiB" and spec["driver"] != "fed":
                if "workloads" in m and not (m["name"] == "qat_backward_roofline.fed"
                                             and spec.get("algorithm") == "fedavg"):
                    m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, bench


def run_tiny(root: Path, bench: dict, cell: str, *, seed: int = 12345, seconds: float = 0.2,
             trace: bool = False, faults: tuple = (), control: bool = False) -> dict:
    from perfbench import harness

    return harness.run_cell(root, bench, cell, seed, seconds, trace, t0=time.perf_counter(),
                            device="cpu", faults=faults, control=control)
