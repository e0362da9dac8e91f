"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's: the cell list, ``param_count``, ``active_param_count`` and
``model_flops`` of every arch and shape, and the per-device train-state
bytes of every arch on the one-pod and two-pod production meshes (bf16
params, QAT, Adam; on two pods the compressed sync's residuals), the
reference's from ``NamedSharding.shard_shape`` of its state's specs in one
subprocess whose JAX sees 512 forced host devices (nothing compiled), the
port's from its fake shards in one subprocess on a one-process "fake"
group. Then the FLOP count of a reduced olmo-1b prefill against its
closed form, one full-width cell's record, and the recorded 14b-iv error
of a default-variant MoE cell."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from _torch_dist import REPO, _env, run_jax

_REFERENCE = """
import pickle
import jax, numpy as np
from repro.configs import ARCH_IDS, SHAPES, applicable, get_config
from repro.launch import dryrun
from repro.launch.mesh import make_production_mesh
from repro.models.transformer import param_count
from repro.optim import adam
from repro.train import TrainerConfig

out = {"cells": [list(c) for c in dryrun.cells()], "counts": {}, "state": {}}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    out["counts"][arch] = (param_count(cfg), dryrun.active_param_count(cfg),
                           {s: dryrun.model_flops(cfg, s) for s in SHAPES})
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    for arch in ARCH_IDS:
        cfg = get_config(arch, param_dtype="bfloat16", compute_dtype="bfloat16")
        tcfg = TrainerConfig(qat=True, pod_compression=multi, error_feedback=multi)
        st = dryrun._train_state_specs(cfg, tcfg, adam(1e-4), mesh, 2 if multi else 1)
        leaves = [x for x in jax.tree_util.tree_leaves(st) if x is not None]
        out["state"][(arch, multi)] = sum(
            int(np.prod(x.sharding.shard_shape(x.shape))) * x.dtype.itemsize for x in leaves)
pickle.dump(out, open(OUT, "wb"))
"""

_PORT = """
import json
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.transformer import param_count
from repro_torch.train import TrainerConfig

out = {"cells": [list(c) for c in dryrun.cells()], "counts": {}, "state": {}}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    out["counts"][arch] = (param_count(cfg), dryrun.active_param_count(cfg),
                           {s: dryrun.model_flops(cfg, s) for s in SHAPES})
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    for arch in ARCH_IDS:
        cfg = get_config(arch, param_dtype="bfloat16", compute_dtype="bfloat16")
        tcfg = TrainerConfig(qat=True, pod_compression=multi, error_feedback=multi)
        out["state"][f"{arch}|{int(multi)}"] = dryrun.state_bytes(cfg, tcfg, mesh.shape,
                                                                  mesh.axis_names)
print(json.dumps(out))
"""


def _python(code: str, timeout: float = 240) -> str:
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_env(), timeout=timeout, cwd=REPO)
    assert run.returncode == 0, run.stderr[-3000:]
    return run.stdout


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor() as pool:
        ref = pool.submit(run_jax, _REFERENCE, 512, tmp_path_factory.mktemp("dryrun"))
        port = pool.submit(_python, _PORT)
        return ref.result(), json.loads(port.result())


def test_cell_list_is_the_reference_cells(both):
    ref, port = both
    assert port["cells"] == ref["cells"]


def test_counts_and_model_flops_equal_the_reference(both):
    ref, port = both
    for arch, (n, n_act, flops) in ref["counts"].items():
        assert port["counts"][arch] == [n, n_act, flops], arch


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_train_state_bytes_equal_the_reference_shards(both, multi):
    """Every arch's per-device train-state bytes, exactly."""
    ref, port = both
    for (arch, m), nbytes in ref["state"].items():
        if m == multi:
            assert port["state"][f"{arch}|{int(m)}"] == nbytes, arch


def test_prefill_flops_equal_the_closed_form():
    """A reduced olmo-1b prefill of 2 × 8 tokens into an 8-slot cache on
    one device: 2 · (the layers' seven matmuls and lm_head) · tokens, plus
    per layer the QKᵀ and PV products over every slot, 2 · 2 · B · H · S ·
    S_max · hd."""
    out = _python(
        "from repro_torch.configs import get_reduced\n"
        "from repro_torch.launch.dryrun import estimate_step\n"
        "cfg = get_reduced('olmo-1b')\n"
        "print(estimate_step(cfg, 'prefill', (2, 8), (1,), ('data',))['hlo']"
        "['flops_per_device'])\n")
    from repro_torch.configs import get_reduced

    cfg = get_reduced("olmo-1b")
    b, s, d, hd = 2, 8, cfg.d_model, cfg.resolved_head_dim
    attn = d * cfg.n_heads * hd * 2 + d * cfg.n_kv_heads * hd * 2
    mlp = 3 * d * cfg.d_ff
    closed = 2 * (cfg.n_layers * (attn + mlp) + d * cfg.vocab_size) * b * s \
        + cfg.n_layers * 2 * 2 * b * cfg.n_heads * s * s * hd
    assert float(out.strip().splitlines()[-1]) == closed


def _cell(tmp_path, *args) -> dict:
    _python("import sys\nfrom repro_torch.launch.dryrun import main\n"
            f"main({list(args) + ['--out', str(tmp_path)]!r})\n", timeout=120)
    tag = f"__{args[args.index('--variant') + 1]}" if "--variant" in args else ""
    name = f"{args[1]}__{args[3]}__{args[5]}{tag}.json"
    with open(os.path.join(tmp_path, name)) as f:
        return json.load(f)


def test_full_width_decode_cell_writes_its_record(tmp_path):
    """olmo-1b × decode_32k × single: status ok; each rank holds 8 rows of
    the cache, 1 of 16 kv heads, so its cache is 1/256 of the whole; the
    roofline carries the H100 constants."""
    r = _cell(tmp_path, "--arch", "olmo-1b", "--shape", "decode_32k", "--mesh", "single")
    assert r["status"] == "ok", r.get("traceback")
    whole_cache = 2 * 16 * 128 * 32768 * 16 * 128 * 2        # k, v; bf16
    params = r["state_bytes_per_device"]
    assert r["memory"]["argument_bytes_per_device"] == params + whole_cache // 256 + 8 * 8
    assert r["memory"]["alias_bytes_per_device"] == whole_cache // 256
    rf = r["roofline"]
    assert (rf["peak_flops"], rf["hbm_bw"], rf["link_bw"]) == (989e12, 3.35e12, 50e9)
    assert r["hlo"]["flops_per_device"] > 0 and r["hlo"]["collective_bytes_per_device"] > 0
    assert np.isfinite(rf["mfu_upper_bound"]) and 0 < rf["useful_flops_ratio"] <= 1


def test_default_variant_moe_cell_records_the_missing_port(tmp_path):
    """The reference's default variant routes the MoE all-to-all under
    "model": the port records the cell's error, naming ROADMAP 14b-iv."""
    r = _cell(tmp_path, "--arch", "qwen3-moe-30b-a3b", "--shape", "decode_32k", "--mesh",
              "single")
    assert r["status"] == "error" and "14b-iv" in r["error"]
