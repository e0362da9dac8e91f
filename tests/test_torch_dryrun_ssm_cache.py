"""The dry-run's decode cells of the ssm and hybrid families count a rank's
part of the serving cache as the reference places it: mamba2-370m and
zamba2-1.2b at full width, ``decode_32k`` and ``long_500k`` on the one-pod
production mesh. The reference's per-device cache bytes come from
``NamedSharding.shard_shape`` of its ``batch_specs`` cache specs on the
abstract cache (a subprocess whose JAX sees 512 forced host devices,
nothing compiled); the port's from its dry-run record (argument bytes less
the params and the rank's token rows) and from ``init_cache`` on rank 0 of
a "fake" group, leaf by leaf. The SSD state dominates: 48 MiB a row for
mamba2-370m over 48 layers, 38 MiB for zamba2-1.2b over 38, of which a rank
of the 16 "model" ranks holds 1/16."""

import json
import subprocess
import sys

import pytest

from _torch_dist import REPO, _env, run_jax

CELLS = [("mamba2-370m", "decode_32k"), ("mamba2-370m", "long_500k"),
         ("zamba2-1.2b", "decode_32k"), ("zamba2-1.2b", "long_500k")]

_REFERENCE = """
import pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding
from repro.configs import SHAPES, get_config
from repro.launch.mesh import make_production_mesh
from repro.models.transformer import init_cache
from repro.parallel.sharding import batch_specs

mesh = make_production_mesh(multi_pod=False)
out = {}
for arch, shape in CELLS:
    cfg = get_config(arch, param_dtype="bfloat16", compute_dtype="bfloat16")
    spec = SHAPES[shape]
    cache = jax.eval_shape(lambda: init_cache(cfg, spec.global_batch, spec.seq_len,
                                              jnp.bfloat16))
    specs = batch_specs(cfg, shape, mesh)
    leaves = {k: tuple(NamedSharding(mesh, specs["cache"][k]).shard_shape(v.shape))
              for k, v in cache.items()}
    nbytes = {k: int(np.prod(leaves[k])) * cache[k].dtype.itemsize for k in cache}
    tokens = NamedSharding(mesh, specs["tokens"]).shard_shape((spec.global_batch, 1))
    out[(arch, shape)] = {"shapes": leaves, "bytes": nbytes, "rows": tokens[0]}
pickle.dump(out, open(OUT, "wb"))
"""

_PORT = """
import json
from repro_torch.configs import SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.transformer import init_cache
from torch._subclasses.fake_tensor import FakeTensorMode

mesh = make_production_mesh(multi_pod=False)
out = {}
for arch, shape in CELLS:
    r = dryrun.run_cell(arch, shape, "single", out_dir=OUT_DIR)
    cfg, _, _ = dryrun.build_cell(arch, shape, mesh, "baseline")
    spec = SHAPES[shape]
    rank0 = dryrun._rank0_mesh(mesh.shape, mesh.axis_names)
    with FakeTensorMode():
        cache = init_cache(cfg, spec.global_batch, spec.seq_len, cfg.cdtype(), device="cpu",
                           mesh=rank0)
        shapes = {k: list(v.shape) for k, v in cache.items()}
    out[f"{arch}|{shape}"] = {"status": r["status"], "error": r.get("error"),
                              "args": r.get("memory", {}).get("argument_bytes_per_device"),
                              "state": r.get("state_bytes_per_device"), "shapes": shapes}
print(json.dumps(out))
"""


def _python(code: str, timeout: float) -> str:
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_env(), timeout=timeout, cwd=REPO)
    assert run.returncode == 0, run.stderr[-3000:]
    return run.stdout


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    import concurrent.futures

    tmp = tmp_path_factory.mktemp("dryrun_ssm")
    head = f"CELLS = {CELLS!r}\n"
    with concurrent.futures.ThreadPoolExecutor() as pool:
        ref = pool.submit(run_jax, head + _REFERENCE, 512, tmp)
        port = pool.submit(_python, head + f"OUT_DIR = {str(tmp)!r}\n" + _PORT, 300)
        return ref.result(), json.loads(port.result().strip().splitlines()[-1])


@pytest.mark.parametrize("arch,shape", CELLS)
def test_ssm_cache_leaves_are_the_reference_shards(both, arch, shape):
    """Rank 0's ``init_cache`` leaves (conv window, SSD state, and zamba2's
    shared-attention keys and values) have the reference's shard shapes:
    the SSD state 1/16 of its heads and the conv window 1/16 of its
    channels."""
    ref, port = both
    want, got = ref[(arch, shape)], port[f"{arch}|{shape}"]
    assert {k: tuple(v) for k, v in got["shapes"].items()} == want["shapes"]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_decode_cell_counts_the_reference_cache_bytes(both, arch, shape):
    """The cell's status is ok and its argument bytes are the params, the
    rank's token rows (int64) and exactly the reference's per-device cache
    bytes."""
    ref, port = both
    want, got = ref[(arch, shape)], port[f"{arch}|{shape}"]
    assert got["status"] == "ok", got["error"]
    assert got["args"] - got["state"] - 8 * want["rows"] == sum(want["bytes"].values())
