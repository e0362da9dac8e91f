"""Port vs reference through the wire: the packed (2-bit, ``ternary_matmul``)
deploy of the dense, vlm and audio archs at their reduced configs against
the reference's packed deploy (the same wire bytes; logits within 1e-4),
the lossy download estimate, and the serving CLI's refusals and runs for
every family."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.core import FTTQConfig as JFTTQConfig
from repro.launch.serve import ternary_deploy as jternary_deploy
from repro.models import transformer as jtf
import repro_torch.configs as TC
from repro_torch.convert import params_from_jax
from repro_torch.core.fttq import FTTQConfig
from repro_torch.kernels.repack import PackedTernary
from repro_torch.launch import serve
from repro_torch.models import transformer as tf
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

B, S = 2, 8


def _setup(arch):
    jcfg, cfg = JC.get_reduced(arch), TC.get_reduced(arch)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    if jcfg.family == "vlm":
        jp["cross"]["gate_attn"] = jnp.full_like(jp["cross"]["gate_attn"], 0.5)
        jp["cross"]["gate_mlp"] = jnp.full_like(jp["cross"]["gate_mlp"], 0.5)
    p = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(1)
    inputs = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        inputs = {"embeds": (rng.normal(size=(B, S, cfg.d_model)) * 0.02).astype(np.float32)}
    if cfg.family == "vlm":
        inputs["vision_embeds"] = (rng.normal(size=(B, cfg.n_patches, cfg.d_model))
                                   * 0.02).astype(np.float32)
    return jcfg, jp, cfg, p, inputs


def _logits(fn, cfg, params, inputs, to):
    kw = {k: to(v) for k, v in inputs.items()}
    return fn(cfg, params, kw.pop("tokens", None), **kw)[0]


def _jnp(a):
    return jnp.asarray(a)


PACKED = [a for a in JC.ARCH_IDS if JC.get_reduced(a).family in ("dense", "vlm", "audio")
          and a != "olmo-1b"]     # olmo-1b: tests/test_torch_serve.py


@pytest.mark.parametrize("arch", PACKED)
def test_packed_deploy_matches_reference_packed_deploy(arch):
    jcfg, jp, cfg, p, inputs = _setup(arch)
    jserved, jbytes, _, _ = jternary_deploy(jp, JFTTQConfig(), packed=True)
    served, nbytes, _, _ = serve.ternary_deploy(p, FTTQConfig(), packed=True, device="cpu")
    assert nbytes == jbytes
    per_layer = 6 + cfg.gated_mlp
    n_packed = sum(isinstance(x, PackedTernary) for x in tree_leaves(
        served, is_leaf=lambda x: isinstance(x, PackedTernary)))
    assert n_packed == per_layer * (2 if cfg.family == "vlm" else 1)
    want = _logits(jtf.forward, jcfg, jserved, inputs, _jnp)
    got = _logits(tf.forward, cfg, served, inputs, torch.from_numpy)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    dense, _, _, _ = serve.ternary_deploy(p, FTTQConfig(), device="cpu")
    kw = {k: torch.from_numpy(v) for k, v in inputs.items()}
    diff, ref_max = serve.packed_logits_check(cfg, served, dense, kw.pop("tokens", None), **kw)
    assert diff / ref_max <= 1e-4


def test_loss_rate_meters_the_download_over_the_same_link():
    jcfg, jp, cfg, p, _ = _setup("yi-9b")
    _, jbytes, jdl, jlink = jternary_deploy(jp, JFTTQConfig(), loss_rate=0.2)
    _, nbytes, dl, link = serve.ternary_deploy(p, FTTQConfig(), loss_rate=0.2, device="cpu")
    assert nbytes == jbytes
    assert dl == pytest.approx(jdl, rel=1e-12)
    assert dl > link.transfer_time(nbytes)


@pytest.mark.parametrize("arch,packed,message", [
    ("qwen3-moe-30b-a3b", True, "routes its hot matmuls elsewhere"),
    ("deepseek-moe-16b", True, "routes its hot matmuls elsewhere"),
    ("mamba2-370m", True, "routes its hot matmuls elsewhere"),
    ("zamba2-1.2b", True, "routes its hot matmuls elsewhere"),
    ("hubert-xlarge", False, "encoder-only"),
    ("hubert-xlarge", True, "encoder-only"),
])
def test_cli_refusals(arch, packed, message):
    argv = ["--device", "cpu", "--arch", arch, "--ternary"] + (["--packed"] if packed else [])
    with pytest.raises(SystemExit, match=message):
        serve.main(argv)


@pytest.mark.parametrize("arch,flags", [
    ("llama-3.2-vision-11b", ["--ternary", "--packed", "--residual-codec", "fp16"]),
    ("gemma3-4b", ["--ternary", "--packed", "--loss-rate", "0.05"]),
    ("deepseek-moe-16b", ["--ternary"]),
    ("zamba2-1.2b", ["--ternary", "--residual-codec", "bf16"]),
    ("mamba2-370m", []),
])
def test_cli_serves_every_causal_family(arch, flags, capsys):
    serve.main(["--device", "cpu", "--arch", arch, "--batch", "2", "--prompt-len", "6",
                "--gen", "3"] + flags)
    out = capsys.readouterr().out
    assert f"serving {arch}-smoke on cpu" in out and "decode: 2 steps" in out
    assert ("packed-vs-dequant logits" in out) == ("--packed" in flags)
