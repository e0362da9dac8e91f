"""bf16 activations in the port against the reference, on the CPU: the
plain ternary matmul on bf16 x against the Pallas kernel (interpret mode),
a bf16 olmo-1b tree's ternary encode byte for byte against the
reference's, and a packed bf16 serve (prefill and decode) against the
reference's packed deploy on the same weights."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.wire import encode_update as jencode_update
from repro.configs import olmo_1b as jax_olmo
from repro.core import FTTQConfig as JFTTQConfig
from repro.core.compression import CodecSpec as JCodecSpec, compress_pytree as jcompress
from repro.kernels.ternary_matmul import ternary_matmul as jternary_matmul
from repro.launch.serve import ternary_deploy as jternary_deploy
from repro.models import transformer as jtf
from repro_torch.comm.wire import encode_update
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_jax
from repro_torch.core.compression import CodecSpec, compress_pytree
from repro_torch.core.fttq import FTTQConfig
from repro_torch.kernels.ternary_matmul import ternary_matmul, ternary_matmul_plain
from repro_torch.launch import serve
from repro_torch.models import transformer as tf

torch.set_num_threads(1)

B, S, GEN = 2, 8, 5          # prefill and 4 decode steps
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")


def _bf16_bits(x) -> np.ndarray:
    return np.asarray(x).view(np.uint16) if isinstance(x, np.ndarray) else \
        x.view(torch.uint16).numpy()


def _ulp(y: np.ndarray) -> np.ndarray:
    """One bf16 unit in the last place of |y|."""
    m = np.maximum(np.abs(y), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(m)) - 7)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_olmo.reduced(), **BF16)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    return jcfg, jparams, dataclasses.replace(get_reduced("olmo-1b"), **BF16), params, tokens


@pytest.mark.parametrize("m,k,n", [(4, 64, 48), (5, 32, 37), (1, 8, 3), (17, 128, 130),
                                   (17, 64, 48), (129, 64, 40), (129, 128, 300), (31, 36, 70)])
def test_plain_bf16_matches_pallas_kernel(m, k, n):
    """bf16 x → bf16 out, within one bf16 ulp of the Pallas kernel (the
    fp32 accumulation order may differ and move a rounding)."""
    rng = np.random.default_rng(m * k + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    codes = rng.integers(0, 3, size=(k, n)).astype(np.uint8)
    c = codes.reshape(k // 4, 4, n)
    packed = (c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)).astype(np.uint8)
    wq = np.float32(0.37)
    xj = jnp.asarray(x, jnp.bfloat16)
    ref = jternary_matmul(xj, jnp.asarray(packed), jnp.asarray(wq), interpret=True)
    assert ref.dtype == jnp.bfloat16
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = ternary_matmul_plain(xt, torch.from_numpy(packed), torch.tensor(wq))
    assert got.dtype == torch.bfloat16
    assert torch.equal(ternary_matmul(xt, torch.from_numpy(packed), torch.tensor(wq)), got)
    a, b = got.float().numpy(), np.asarray(ref, np.float32)
    assert (np.abs(a - b) <= _ulp(np.maximum(np.abs(a), np.abs(b)))).all()


def test_bf16_tree_encode_bytes_match_reference(setup):
    """The ternary codec over a bf16 olmo-1b tree (the deploy's encode):
    the serialized wire blob equals the reference's byte for byte, bf16
    scales included."""
    jcfg, jparams, cfg, params, _ = setup
    jwire, _ = jcompress(jparams, JCodecSpec(kind="ternary", fttq=JFTTQConfig()))
    wire, _ = compress_pytree(params, CodecSpec(kind="ternary", fttq=FTTQConfig()))
    jblob, blob = jencode_update(jwire), encode_update(wire)
    assert len(blob) == len(jblob)
    assert blob == jblob


def test_packed_bf16_serve_matches_reference(setup):
    """Deploy → packed prefill of 2 × 8 → 4 greedy decode steps, bf16
    weights and activations in both packages: the same wire bytes, logits
    within 2e-2 of max |logits| at every step (measured 0.6–0.9%, about one
    bf16 ulp of the largest logit, since the activations and the attention
    probabilities round as the reference's do, 0.6–1.2% before: what is
    left is the packed matmuls' bf16 outputs, within one ulp of the
    reference kernel's where their fp32 sums' order differs) and the same
    greedy tokens."""
    jcfg, jparams, cfg, params, tokens = setup
    jserved, jbytes, _, _ = jternary_deploy(jparams, JFTTQConfig(), packed=True)
    served, nbytes, _, _ = serve.ternary_deploy(params, FTTQConfig(), packed=True, device="cpu")
    assert nbytes == jbytes

    jcache = jtf.init_cache(jcfg, B, S + GEN)
    jlog, jcache, _ = jtf.forward(jcfg, jserved, jnp.asarray(tokens), cache=jcache, pos=0)
    cache = tf.init_cache(cfg, B, S + GEN, device="cpu")
    log, cache, _ = tf.forward(cfg, served, torch.from_numpy(tokens.astype(np.int64)),
                               cache=cache, pos=0)
    assert log.dtype == torch.bfloat16
    steps = [(np.asarray(jlog, np.float32), log.float().numpy())]
    jtok = jnp.argmax(jlog[:, -1:], axis=-1).astype(jnp.int32)
    tok = torch.argmax(log[:, -1:], dim=-1)
    for i in range(GEN - 1):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        jlog, jcache = jtf.decode_step(jcfg, jserved, jtok, jcache, S + i)
        log, cache = tf.decode_step(cfg, served, tok, cache, S + i)
        steps.append((np.asarray(jlog, np.float32), log.float().numpy()))
        jtok = jnp.argmax(jlog, axis=-1).astype(jnp.int32)
        tok = torch.argmax(log, dim=-1)
    for ref, got in steps:
        assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()


def test_serve_cli_takes_bfloat16(capsys):
    """``launch.serve --dtype bfloat16 --ternary --packed`` deploys and
    serves the bf16 model (here on the CPU at the reduced size)."""
    serve.main(["--device", "cpu", "--ternary", "--packed", "--dtype", "bfloat16",
                "--batch", "1", "--prompt-len", "4", "--gen", "3"])
    out = capsys.readouterr().out
    assert "packed-vs-dequant logits" in out and "decode: 2 steps" in out
