"""Port vs reference: the synchronous T-FedAvg / FedAvg round (paper
Algorithm 2) end to end on the paper's MLP, from the same initial weights,
data and seed, and the paper models' forward passes.

What the channel and the rng decide is identical: bytes up and down, round
times, participants and dropped stragglers. Training runs in another
framework's float order, so the global model after every round is held to
the reference's within ``PARAM_ATOL`` per element. The sound port stays
within 8.7e-7 of it in both algorithms, with no code flips. Three faults
planted in the port each put at least 83% of ``fc0/w``'s elements outside
``PARAM_ATOL`` in the first round: a w_q step without the division by the
leaf's size, a client that trains on half its batches (the smallest: max
gap 3.4e-5, and a T-FedAvg loss gap of only 0.7%, which a loss limit of 2%
let pass), and Adam without its second-moment bias correction. FTTQ
thresholds can flip a code near Δ; such a flip moves one element by about
weight·w_q, so a quantized leaf may hold up to one element in 10,000
outside ``PARAM_ATOL``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import ChannelConfig as JChannelConfig
from repro.data import partition_iid as jpartition_iid
from repro.data import synthetic_classification as jsynthetic
from repro.fed import FedConfig as JFedConfig
from repro.fed import run_federated as jrun_federated
from repro.models.paper_models import init_mlp_mnist as jinit_mlp
from repro.models.paper_models import init_resnet_cifar as jinit_resnet
from repro.models.paper_models import mlp_mnist as jmlp
from repro.models.paper_models import resnet_cifar as jresnet
from repro.optim import adam as jadam
from repro.optim import optimizers as joptim
from repro_torch.comm.channel import ChannelConfig
from repro_torch.convert import params_from_jax
from repro_torch.data.federated import partition_iid
from repro_torch.fed.simulation import FedConfig, PhaseTimer, run_federated
from repro_torch.launch.federated import main as federated_main
from repro_torch.launch.federated import make_eval_fn
from repro_torch.models.paper_models import (
    init_resnet_cifar, mlp_mnist, param_count, resnet_cifar, same_padding,
)
from repro_torch.optim import adam
from repro_torch.optim import optimizers as optim
from repro_torch.tree import flatten_with_path

torch.set_num_threads(1)

ACC_TOL, LOSS_RTOL = 0.005, 1e-4     # one test sample of 200; sound loss gap 2.0e-6
PARAM_ATOL = 2e-6                    # sound gap 8.7e-7; smallest planted fault 3.4e-5
FLIPS_PER_ELEMENT = 1e-4
CHANNEL = {"mean_bandwidth_bytes_s": 1e6, "deadline_s": 0.09}


@pytest.fixture(scope="module")
def mlp_setup():
    x, y, xt, yt = jsynthetic(jax.random.PRNGKey(0), 360, 10, 784, noise=3.0, n_test=200)
    jparams = jinit_mlp(jax.random.PRNGKey(1))
    return x, y, xt, yt, jparams


def _jax_eval(xt, yt):
    xt_j, yt_j = jnp.asarray(xt), jnp.asarray(yt)

    def eval_fn(p):
        logits = jmlp(p, xt_j)
        logp = jax.nn.log_softmax(logits, -1)
        return (float(jnp.mean(jnp.argmax(logits, -1) == yt_j)),
                float(-jnp.mean(jnp.take_along_axis(logp, yt_j[:, None], -1))))

    return eval_fn


def _recording(eval_fn, seen, to_numpy):
    """``eval_fn`` that first keeps the global model it scores, per round."""

    def wrapped(params):
        seen.append({path: to_numpy(leaf) for path, leaf in flatten_with_path(params)})
        return eval_fn(params)

    return wrapped


def _run_both(setup, algo, **cfg_kw):
    """Both runs, each with the global model after every round."""
    x, y, xt, yt, jparams = setup
    common = dict(algorithm=algo, n_clients=6, participation=0.5, local_epochs=1,
                  batch_size=16, rounds=2, seed=3, **cfg_kw)
    ref_params, got_params = [], []
    ref = jrun_federated(jmlp, jparams, jpartition_iid(x, y, 6), JFedConfig(
        channel=JChannelConfig(**CHANNEL), **common), jadam(1e-3),
        _recording(_jax_eval(xt, yt), ref_params, np.asarray), eval_every=1)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    timer = PhaseTimer("cpu")
    got = run_federated(mlp_mnist, params, partition_iid(x, y, 6), FedConfig(
        channel=ChannelConfig(**CHANNEL), **common), adam(1e-3),
        _recording(make_eval_fn(mlp_mnist, xt, yt, torch.device("cpu")), got_params,
                   lambda t: t.numpy().copy()),
        eval_every=1, device="cpu", timer=timer)
    ref.params, got.params = ref_params, got_params
    return ref, got, timer


def _assert_same_globals(ref, got, algo):
    """The global model after each round, element by element. The gaps are
    printed first (``pytest -s`` shows them)."""
    assert len(got.params) == len(ref.params) == 2
    for r, (want, have) in enumerate(zip(ref.params, got.params)):
        gaps = {path: np.abs(a - want[path]) for path, a in have.items() if path in want}
        print(f"{algo} round {r}: max |global - reference| "
              f"{max(float(g.max()) for g in gaps.values()):.3e}; elements off by more than "
              f"1e-4: {sum(int((g > 1e-4).sum()) for g in gaps.values())} of "
              f"{sum(g.size for g in gaps.values())}")
        assert sorted(have) == sorted(want)
        for path, a in have.items():
            b = want[path]
            assert a.shape == b.shape, (r, path)
            outside = int((np.abs(a - b) > PARAM_ATOL).sum())
            quantized = algo == "tfedavg" and a.ndim >= 2
            allowed = int(FLIPS_PER_ELEMENT * a.size) if quantized else 0
            assert outside <= allowed, (
                f"round {r} {path}: {outside} elements off by more than {PARAM_ATOL} "
                f"(max {np.abs(a - b).max():.3e})")


def _assert_same_round(ref, got, algo):
    assert got.upload_bytes == ref.upload_bytes
    assert got.download_bytes == ref.download_bytes
    assert got.round_times == ref.round_times
    assert got.participants_per_round == ref.participants_per_round
    assert got.dropped_per_round == ref.dropped_per_round
    assert got.transfer_summary == ref.transfer_summary
    for key in ("dropped_updates", "dropped_update_bytes", "upload_bytes_per_round"):
        assert got.telemetry[key] == ref.telemetry[key], key
    assert len(got.accuracy) == len(ref.accuracy) == 2
    print(f"accuracy {got.accuracy} vs {ref.accuracy}; loss relative gap "
          f"{np.abs(np.subtract(got.loss, ref.loss) / np.asarray(ref.loss)).max():.3e}")
    _assert_same_globals(ref, got, algo)
    np.testing.assert_allclose(got.accuracy, ref.accuracy, rtol=0, atol=ACC_TOL)
    np.testing.assert_allclose(got.loss, ref.loss, rtol=LOSS_RTOL)


@pytest.mark.parametrize("algo", ["tfedavg", "fedavg"])
def test_sync_round_matches_reference(mlp_setup, algo):
    ref, got, timer = _run_both(mlp_setup, algo)
    _assert_same_round(ref, got, algo)
    assert sum(got.dropped_per_round) > 0      # the deadline drops stragglers
    assert len(timer.rounds) == 2 and {"train", "encode", "wire", "aggregate"} <= set(
        timer.rounds[0])
    if algo == "tfedavg":
        # 2-bit upload: ~15× under the fp32 round (biases ship fp32)
        assert got.upload_bytes / sum(got.participants_per_round) < 8000


def test_sync_round_reference_paths_match_reference(mlp_setup):
    """The per-leaf encode and the list aggregation give the same round."""
    ref, got, _ = _run_both(mlp_setup, "tfedavg", fused_aggregation=False,
                            fused_encode=False)
    _assert_same_round(ref, got, "tfedavg")


def test_unported_options_raise(mlp_setup):
    """The adaptive compression controller is ported; a mixed-codec round
    has no robust decomposition, so with a controller a robust rule raises
    ``ValueError`` on both servers, as the reference's does."""
    from repro.fed import ControllerConfig as JControllerConfig
    from repro.fed.defense import DefenseConfig as JDefenseConfig
    from repro_torch.fed import ControllerConfig, DefenseConfig

    x, y, xt, yt, jparams = mlp_setup
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    clients = partition_iid(x, y, 6)
    eval_fn = make_eval_fn(mlp_mnist, xt, yt, torch.device("cpu"))
    for mode in ("sync", "async"):
        with pytest.raises(ValueError, match="adaptive compression requires"):
            run_federated(mlp_mnist, params, clients,
                          FedConfig(mode=mode, controller=ControllerConfig(),
                                    defense=DefenseConfig(enabled=True, rule="majority")),
                          adam(1e-3), eval_fn, device="cpu")
        with pytest.raises(ValueError, match="adaptive compression requires"):
            jrun_federated(jmlp, jparams, jpartition_iid(x, y, 6),
                           JFedConfig(mode=mode, controller=JControllerConfig(),
                                      defense=JDefenseConfig(enabled=True, rule="majority")),
                           jadam(1e-3), _jax_eval(xt, yt))


def test_federated_cli_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        federated_main(["--rounds", "1"])


@pytest.mark.parametrize("hw,stride", [(32, 1), (32, 2), (16, 2), (8, 2), (7, 2), (5, 1)])
def test_same_padding_matches_xla(hw, stride):
    """Stride-2 "SAME" on an even size pads 0 before and 1 after."""
    x = np.random.default_rng(hw).normal(size=(1, hw, hw, 2)).astype(np.float32)
    w = np.random.default_rng(1).normal(size=(3, 3, 2, 3)).astype(np.float32)
    ref = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"))
    from repro_torch.models.paper_models import _conv

    got = _conv(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w), stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=1e-5)
    if hw % 2 == 0 and stride == 2:
        assert same_padding(hw, 3, 2) == (0, 1)


@pytest.mark.parametrize("width", [8, 64])
def test_resnet_forward_matches_reference(width):
    """ResNet18* through its stride-2 blocks (SAME padding, max-pool
    shortcut, GroupNorm(8)): logits within atol 1e-4 of the reference."""
    jparams = jinit_resnet(jax.random.PRNGKey(2), width=width)
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jresnet(jparams, jnp.asarray(x)))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    got = resnet_cifar(params, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)
    port_tree = init_resnet_cifar(seed=0, width=width, device="cpu")
    assert param_count(port_tree) == sum(a.size for a in jax.tree_util.tree_leaves(jparams))
    if width == 64:
        assert param_count(port_tree) == 594_378


def test_mlp_forward_matches_reference(mlp_setup):
    x, _, _, _, jparams = mlp_setup
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    np.testing.assert_allclose(mlp_mnist(params, torch.from_numpy(x[:8])).numpy(),
                               np.asarray(jmlp(jparams, jnp.asarray(x[:8]))), atol=1e-5)


@pytest.mark.parametrize("name,kw", [("sgd", {}), ("momentum", {}),
                                     ("momentum", {"nesterov": True}), ("adam", {}),
                                     ("adamw", {})])
def test_optimizers_match_reference(name, kw):
    """Three steps of each optimizer from the same tree and gradients:
    within fp32 rounding (Adam's fp32 bias corrections included)."""
    rng = np.random.default_rng(4)
    tree = {"a": {"w": rng.normal(size=(6, 5)).astype(np.float32)},
            "b": rng.normal(size=(5,)).astype(np.float32)}
    jopt, opt = getattr(joptim, name)(1e-2, **kw), getattr(optim, name)(1e-2, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    p = jax.tree_util.tree_map(torch.from_numpy, tree)
    js, s = jopt.init(jp), opt.init(p)
    for step in range(3):
        g = jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32), tree)
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        u, s = opt.update(jax.tree_util.tree_map(torch.from_numpy, g), s, p)
        jp, p = joptim.apply_updates(jp, ju), optim.apply_updates(p, u)
    for a, b in zip(jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(p)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)
    assert int(s["step"]) == 3
