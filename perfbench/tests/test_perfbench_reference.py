"""The plain references held to the port (``repro_torch``) at reduced sizes
on the CPU: FTTQ's statistics, codes and scales, the OLMo forward and its
QAT step, ResNet18*'s forward and a client's local training, the wire
reader, the weighted-mean fold and the server's re-quantization."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import common
from perfbench.reference import compare, fttq, olmo, resnet, wire

TINY_LM = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "d_ff": 128,
           "vocab_size": 256, "norm": "nonparam", "gated_mlp": True, "activation": "silu",
           "tie_embeddings": True, "rope_theta": 10000.0}
# 16 × 16 images keep 2 × 2 pixels in the last blocks: at 1 × 1 a group of
# GroupNorm(8) holds two values, and its gradients are round-off alone
TINY_RESNET = {"width": 32, "blocks": 8, "downsample_blocks": [2, 4, 6], "n_classes": 10,
               "image_hw": [16, 16, 3]}


def _lm_config(dtype="float32", remat="none"):
    from repro_torch.models.transformer import ModelConfig

    return ModelConfig(name="tiny", family="dense", param_dtype=dtype, compute_dtype=dtype,
                       remat=remat, **TINY_LM)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fttq_codes_and_factors_match_the_port(dtype):
    from repro_torch.core import fttq as port

    leaf = (torch.randn(3, 64, 48, generator=torch.Generator().manual_seed(3)) * 0.05).to(dtype)
    rows = leaf.reshape(3, -1)
    assert torch.equal(fttq.codes(rows, 0.7), port.row_codes(rows, 0.7))
    tree = port.init_wq_tree({"w": leaf}, port.FTTQConfig())
    torch.testing.assert_close(fttq.init_factor(leaf, 0.7), tree["w"], rtol=2 ** -7, atol=0)


def test_server_requantize_matches_the_port():
    from repro_torch.core.fttq import FTTQConfig
    from repro_torch.core.tfedavg import server_requantize

    flat = resnet.flatten(resnet.init_params(TINY_RESNET, 5, "cpu"))
    got = server_requantize(resnet.unflatten(flat), FTTQConfig(), fused=False)
    want = resnet.requantize(flat, t_k=0.7, delta=0.05)
    for p, rec in want.items():
        g = resnet.flatten(got)[p]
        if rec[0] == "ternary":
            assert torch.equal(g.ternary().to(torch.int8), rec[1].to(torch.int8)), p
            torch.testing.assert_close(g.w_q.reshape(-1), rec[2], rtol=1e-6, atol=0)
        else:
            assert torch.equal(g, rec[1])


def test_olmo_forward_matches_the_port():
    from repro_torch.models.transformer import forward

    params = common.draw_lm(TINY_LM, 4, torch.float32, "cpu")
    tokens = torch.randint(0, 256, (2, 24), generator=torch.Generator().manual_seed(1))
    got, _, _ = forward(_lm_config(), common.nest(params), tokens)
    with torch.no_grad():
        want = olmo.logits(TINY_LM, params, tokens, remat=False)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


def test_olmo_qat_steps_match_the_port():
    from repro_torch.core.fttq import FTTQConfig
    from repro_torch.optim import adam
    from repro_torch.train import TrainerConfig, init_train_state, make_train_step

    params = common.draw_lm(TINY_LM, 4, torch.float32, "cpu")
    batches = []
    for i in range(3):
        t = common.tokens(256, 4, 33, 100 + i, "cpu")
        batches.append((t[:, :-1], t[:, 1:]))
    cfg = _lm_config(remat="full")
    tcfg = TrainerConfig(qat=True, microbatches=2, fttq=FTTQConfig())
    opt = adam(1e-3)
    state = init_train_state(cfg, tcfg, opt, params=common.nest(params), device="cpu")
    step = make_train_step(cfg, tcfg, opt)
    losses, first = [], None
    for i, (tk, lb) in enumerate(batches):
        state, m = step(state, {"tokens": tk, "labels": lb})
        losses.append(float(m["loss"]))
        if i == 0:
            first = {p: float(x.norm()) / 0.1 for p, x in olmo.flat(state.opt_state["m"]).items()}
    want = olmo.train(TINY_LM, params, batches, lr=1e-3, microbatches=2, t_k=0.7)
    for g, w in zip(losses, want["losses"]):
        assert compare.rel_gap(g, w) < 1e-4
    assert compare.worst_norm_gap(first, want["first_grad_norms"])[0] < 1e-3
    change = {p: float((x - params[p]).norm()) for p, x in olmo.flat(state.params).items()}
    assert compare.worst_norm_gap(change, want["change_norms"])[0] < 1e-3


def test_resnet_forward_and_local_training_match_the_port():
    from repro_torch.fed.simulation import FedConfig, _make_local_steps
    from repro_torch.core.fttq import init_wq_tree, FTTQConfig
    from repro_torch.models.paper_models import resnet_cifar
    from repro_torch.optim import adam

    p = resnet.init_params(TINY_RESNET, 2, "cpu")
    x = torch.randn(20, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    y = torch.randint(0, 10, (20,), generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(resnet.forward(TINY_RESNET, p, x), resnet_cifar(p, x))
    _, qat_step = _make_local_steps(resnet_cifar, adam(1e-3), FedConfig())
    batches = [torch.arange(0, 10)]
    opt = adam(1e-3)
    pp, wq, st = p, init_wq_tree(p, FTTQConfig()), opt.init(p)
    for b in batches:
        pp, wq, st, _ = qat_step(pp, wq, st, x[b], y[b])
    trained, factors = resnet.local_train(TINY_RESNET, resnet.flatten(p), x, y, batches,
                                          qat=True, t_k=0.7)
    # the factors start one rounding apart (an fp32 sum against a correctly
    # rounded one), which Adam's normalized steps carry on: compared as the
    # benchmark compares a client's upload
    got, start = resnet.flatten(pp), resnet.flatten(p)
    codes = {k: fttq.codes(fttq.rows_of(got[k], True), 0.7) for k in factors}
    differ = sum(int((codes[k] != fttq.codes(fttq.rows_of(trained[k], True), 0.7)).sum())
                 for k in factors)
    assert differ <= 1e-3 * sum(got[k].numel() for k in factors)
    change = {k: float((got[k] - start[k]).norm()) for k in trained}
    want = {k: float((trained[k] - start[k]).norm()) for k in trained}
    assert compare.worst_norm_gap(change, want)[0] < 1e-2
    for k, f in factors.items():
        torch.testing.assert_close(resnet.flatten(wq)[k].reshape(-1), f.reshape(-1),
                                   rtol=1e-5, atol=0)


def test_wire_reader_reads_the_ports_buffers():
    from repro_torch.comm.wire import decode_update, encode_update
    from repro_torch.core.compression import CodecSpec, compress_pytree
    from repro_torch.core.fttq import FTTQConfig

    params = common.nest(common.draw_lm(TINY_LM, 6, torch.bfloat16, "cpu"))
    tree, _ = compress_pytree(params, CodecSpec(kind="ternary", residual="fp16",
                                                fttq=FTTQConfig()))
    blob = encode_update(tree)
    got = wire.decode(blob)
    port = resnet.flatten(decode_update(blob))
    assert set(got) == set(port)
    for p, rec in got.items():
        if rec[0] == "ternary":
            assert torch.equal(rec[1].to(torch.int8), port[p].ternary().to(torch.int8))
            assert torch.equal(rec[2].float(), port[p].w_q.reshape(-1).float())
        elif rec[0] == "downcast":
            assert torch.equal(rec[1], port[p].data)
    with pytest.raises(ValueError):
        wire.decode(blob[:-1])
    bad = bytearray(blob)
    bad[-1] ^= 1
    with pytest.raises(ValueError):
        wire.decode(bytes(bad))


def test_deployed_weights_match_the_ports_codec():
    from repro_torch.comm.wire import decode_update, encode_update
    from repro_torch.core.compression import CodecSpec, compress_pytree, decompress_pytree
    from repro_torch.core.fttq import FTTQConfig
    from perfbench.drivers.score import reference_weights

    params = common.draw_lm(TINY_LM, 7, torch.bfloat16, "cpu")
    tree, _ = compress_pytree(common.nest(params), CodecSpec(kind="ternary", residual="fp16",
                                                            fttq=FTTQConfig()))
    port = olmo.flat(decompress_pytree(decode_update(encode_update(tree))))
    want = reference_weights(TINY_LM, params, 0.7)
    for p, w in want.items():
        torch.testing.assert_close(port[p].float(), w, rtol=2 ** -8, atol=0)


def test_fold_matches_the_ports_aggregator():
    from repro_torch.comm.wire import encode_update
    from repro_torch.core.compression import CodecSpec, compress_pytree
    from repro_torch.core.fttq import FTTQConfig, init_wq_tree
    from repro_torch.core.tfedavg import client_update_payload
    from repro_torch.fed.aggregator import Aggregator

    agg = Aggregator(chunk_c=2, device="cpu")
    ups, weights = [], []
    for k in range(3):
        p = resnet.init_params(TINY_RESNET, 10 + k, "cpu")
        payload = client_update_payload(p, init_wq_tree(p, FTTQConfig()), FTTQConfig())
        blob = encode_update(compress_pytree(payload, CodecSpec(kind="ternary"))[0])
        agg.add(blob, weight=20 + k)
        ups.append(wire.decode(blob))
        weights.append(20 + k)
    got = resnet.flatten(agg.finalize())
    want = resnet.fold(ups, weights)
    for p, w in want.items():
        torch.testing.assert_close(got[p], w, rtol=1e-6, atol=1e-7)


def test_worst_norm_gap_uses_the_median_leaf():
    want = {"a": 1.0, "b": 2.0, "c": 1e-6}
    got = {"a": 1.0, "b": 2.0, "c": 3e-6}
    gap, leaf = compare.worst_norm_gap(got, want)
    assert leaf == "c" and gap == pytest.approx(2e-6 / 1.0)
    assert compare.moving_leaves({"a": 1.0, "b": 2.0, "c": 1e-4}) == {"a", "b"}
    assert np.isclose(compare.rel_gap(1.01, 1.0), 0.01)
