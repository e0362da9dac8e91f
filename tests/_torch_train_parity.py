"""Shared by the port's trainer parity tests: batches made with numpy, a
reference train state carried into the port, and the comparison of one
step of both packages from that state."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as JC
from repro.optim import adam as jadam
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import init_train_state as jinit_train_state
from repro.train import make_train_step as jmake_train_step
import repro_torch.configs as TC
from repro_torch.convert import train_state_from_jax
from repro_torch.optim import adam
from repro_torch.train import TrainerConfig, make_train_step
from repro_torch.tree import tree_leaves

LR = 3e-3


def batch_np(cfg, b: int = 2, s: int = 16, seed: int = 1) -> dict:
    """tokens (or audio frame embeds), labels and vlm patch embeds."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.family == "audio":
        out["embeds"] = (rng.normal(size=(b, s, cfg.d_model)) * 0.02).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    out["labels"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    if cfg.family == "vlm":
        out["vision_embeds"] = (rng.normal(size=(b, cfg.n_patches, cfg.d_model))
                                * 0.02).astype(np.float32)
    return out


def jax_batch(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def reference_state(arch: str, tcfg_kw: dict | None = None, lr: float = LR, **overrides):
    """(reference config, port config, reference TrainState) at the reduced
    config; the vlm's cross-attention gates opened to 0.5 (tanh(0) would
    silence the cross layers and their gradients)."""
    jcfg, cfg = JC.get_reduced(arch, **overrides), TC.get_reduced(arch, **overrides)
    jt = JTrainerConfig(pod_compression=False, **(tcfg_kw or {}))
    state = jinit_train_state(jcfg, jt, jadam(lr), jax.random.PRNGKey(0))
    if jcfg.family == "vlm":
        p = state.params
        p["cross"]["gate_attn"] = jnp.full_like(p["cross"]["gate_attn"], 0.5)
        p["cross"]["gate_mlp"] = jnp.full_like(p["cross"]["gate_mlp"], 0.5)
    return jcfg, cfg, state


def both_steps(arch: str, tcfg_kw: dict | None = None, batch: dict | None = None,
               lr: float = LR, compiler_options: dict | None = None, **overrides):
    """One step of the reference's jitted step and of the port's from the
    same state and batch: (reference new state as numpy, its metrics, port
    new state, its metrics). ``compiler_options``: XLA options the
    reference's step is compiled with."""
    (jnew, jm), (new, m) = (x[-1] for x in train_steps(
        arch, 1, tcfg_kw, batch, lr, compiler_options, **overrides))
    return jnew, jm, new, m


def train_steps(arch: str, steps: int, tcfg_kw: dict | None = None, batch: dict | None = None,
                lr: float = LR, compiler_options: dict | None = None, **overrides):
    """``steps`` steps of both packages from the reference's state on one
    batch: ([(reference state as numpy, metrics)], [(port state,
    metrics)]), one entry a step."""
    jcfg, cfg, jstate = reference_state(arch, tcfg_kw, lr=lr, **overrides)
    b = batch if batch is not None else batch_np(cfg)
    jt = JTrainerConfig(pod_compression=False, **(tcfg_kw or {}))
    jb = jax_batch(b)
    jstep = jax.jit(jmake_train_step(jcfg, jt, jadam(lr))).lower(jstate, jb).compile(
        compiler_options=compiler_options)
    state = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate), "cpu")
    tt = TrainerConfig(pod_compression=False, **(tcfg_kw or {}))
    step = make_train_step(cfg, tt, adam(lr))
    ref, port = [], []
    for _ in range(steps):
        jstate, jm = jstep(jstate, jb)
        ref.append((jax.tree_util.tree_map(np.asarray, jstate), jm))
        state, m = step(state, torch_batch(b))
        port.append((state, m))
    return ref, port


def _np(x) -> np.ndarray:
    """A leaf as numpy, bf16 (reference or port) upcast to fp32 exactly."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def pairs(ref_tree, port_tree):
    ref, port = jax.tree_util.tree_leaves(ref_tree), tree_leaves(port_tree)
    assert len(ref) == len(port)
    return [(_np(a), _np(b)) for a, b in zip(ref, port)]


def assert_step_matches(jnew, jm, new, m, lr: float = LR):
    """The tolerances of one step from the same state (fp32, another
    summation order than XLA's):

    - loss, ce and aux within rtol 2e-6, the grad norm within rtol 1e-5;
    - Adam's m and v (0.1·g and 0.001·g² after one step) within 1e-5 of
      each leaf's largest |m|, |v| (plus rtol 1e-4); w_q within rtol 1e-6;
    - params within 1e-6, except where |g| < 1e-6: Adam's first update is
      lr · g / (|g| + 1e-8), which is ill-conditioned near |g| ≈ 1e-8, so
      there both updates are only held to their bound, |Δ| ≤ 2·lr;
    - the step count exactly.
    """
    for key in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=2e-6, atol=1e-7)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    assert int(new.step) == int(jnew.step) == 1
    assert int(new.opt_state["step"]) == int(jnew.opt_state["step"])
    for name in ("m", "v"):
        for a, b in pairs(jnew.opt_state[name], new.opt_state[name]):
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5 * float(np.abs(a).max()) + 1e-30)
    assert (new.wq is None) == (jnew.wq is None)
    if new.wq is not None:
        flat_j = jax.tree_util.tree_leaves(jnew.wq, is_leaf=lambda x: x is None)
        flat_p = [w for w in _leaves_with_none(new.wq)]
        assert [w is None for w in flat_j] == [w is None for w in flat_p]
        for a, b in pairs(jnew.wq, new.wq):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-9)
    for (a, b), mm in zip(pairs(jnew.params, new.params),
                          jax.tree_util.tree_leaves(jnew.opt_state["m"])):
        small = np.abs(np.asarray(mm)) < 1e-7       # |g| < 1e-6
        np.testing.assert_allclose(b[~small], a[~small], rtol=0, atol=1e-6)
        assert np.all(np.abs(b[small] - a[small]) <= 2 * lr)


def _leaves_with_none(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_none(tree[k])
    else:
        yield tree


def assert_loss_fn_matches(arch: str):
    """``loss_fn`` of both packages on the same params and batch: loss, ce
    and aux within rtol 2e-6."""
    from repro.models import transformer as jtf
    from repro_torch.convert import params_from_jax
    from repro_torch.models import transformer as tf

    jcfg, cfg = JC.get_reduced(arch), TC.get_reduced(arch)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    if jcfg.family == "vlm":
        for gate in ("gate_attn", "gate_mlp"):
            jparams["cross"][gate] = jnp.full_like(jparams["cross"][gate], 0.5)
    b = batch_np(cfg)
    jloss, jm = jax.jit(lambda p, x: jtf.loss_fn(jcfg, p, x))(jparams, jax_batch(b))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    loss, m = tf.loss_fn(cfg, params, torch_batch(b))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-6)
    np.testing.assert_allclose(float(m["ce"]), float(jm["ce"]), rtol=2e-6)
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]), rtol=2e-6, atol=1e-7)
    if cfg.family == "moe":
        assert float(m["aux"]) > 0
    return float(loss)


# The reference's production train cell (``repro.launch.dryrun``): bf16
# params and compute, full remat, QAT, adam(1e-4).
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16", remat="full")
BF16_LR = 1e-4
# The reference's step compiled with each bf16 op rounded as its program
# writes it, as the port rounds it. XLA's default lets a fusion skip the bf16
# rounding of some intermediates: that moves the reference's loss against
# itself by 1.5e-5 (olmo-1b) to 2.0e-3 (deepseek-moe-16b, where a routing
# decision flips), and the port's Adam m against it by up to 29% of a leaf's
# largest against 1.1% on the per-op compile (``tools/bf16_train_parity.py``).
PER_OP = {"xla_allow_excess_precision": False}
EPS = 2.0 ** -7                           # bf16's machine epsilon


def bf16_steps(arch: str, steps: int = 1, microbatches: int = 1, **kw):
    """``train_steps`` of the reference's production cell (``BF16``,
    ``TrainerConfig(qat=True)``, adam(1e-4)) at the reduced config, from
    the reference's state, on a batch of 2 rows a microbatch."""
    cfg = TC.get_reduced(arch, **BF16)
    return train_steps(arch, steps, {"qat": True, "microbatches": microbatches},
                       batch_np(cfg, b=2 * microbatches), BF16_LR, PER_OP, **BF16, **kw)


def _ulp(a: np.ndarray) -> np.ndarray:
    """One bf16 unit in the last place of each |a|."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126))) - 7)


def assert_bf16_state_dtypes(jstate, state):
    """Each param and w_q the reference's dtype (bf16, but Mamba2's fp32
    a_log, dt_bias and d_skip and their w_q), fp32 Adam moments
    (``repro.optim.optimizers`` keeps them so)."""
    for tree in (state.opt_state["m"], state.opt_state["v"]):
        assert {x.dtype for x in tree_leaves(tree)} == {torch.float32}
    assert torch.bfloat16 in {x.dtype for x in tree_leaves(state.params)}
    for jt, t in ((jstate.params, state.params), (jstate.opt_state["m"], state.opt_state["m"]),
                  (jstate.wq, state.wq)):
        assert [str(np.asarray(a).dtype) for a in jax.tree_util.tree_leaves(jt)] == \
            [str(b.dtype).removeprefix("torch.") for b in tree_leaves(t)]


def assert_bf16_step_matches(jnew, jm, new, m, step: int = 1, lr: float = BF16_LR, *,
                             loss_rtol: float = 2.0 ** -14, gn_rtol: float = EPS / 4,
                             m_tol: float = 8 * EPS, v_tol: float = 16 * EPS,
                             g_floor: float = 0.0):
    """One bf16 step of the port against the reference's per-op compile,
    from the same state. Exact: the dtypes, the step counts. Within
    tolerances stated in bf16 terms (ε = 2^-7), each about twice the worst
    of the ten archs at their reduced configs (the measurements, from
    ``tools/bf16_train_parity.py``, in parentheses):

    - loss, ce and aux within rtol ε/2^7 = 2^-14 (2.6e-5, zamba2-1.2b; the
      forward is bit for bit in most archs, the fp32 mean's order aside);
    - the grad norm within rtol ε/4 (9.8e-4, the vlm: its gates' scalar
      gradients are bf16 sums of 2,048 products, rounded one ulp apart
      where the order differs);
    - Adam's m and v per leaf within 8ε and 16ε of the leaf's largest
      value (1.96e-2 and 3.96e-2, the vlm: the clip multiplies the whole
      tree by a bf16 scale, min(1, 1/‖g‖), which a grad norm differing in
      its last bits can round one bf16 ulp, 2^-8 to 2^-7, apart);
    - w_q within one bf16 ulp (1.6e-6 of its value, zamba2);
    - params within one bf16 ulp and 2^-6·lr, except where |m| is within
      the m tolerance of zero: there Adam's first step ±lr can change sign
      with the gradient's, so both are held to |Δ| ≤ 2·lr + one ulp (the
      worst such element moved 418 ulps of its value, zamba2).

    A caller may widen the loss (with ce and aux), grad norm, m and v
    tolerances where it states why, and with ``g_floor`` also hold the
    params where |g| = 10·|m| < ``g_floor`` to that bound: there Adam's
    first step lr·g/(|g| + 1e-8) is ill-conditioned, as
    ``assert_step_matches`` says."""
    for key in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=loss_rtol, atol=1e-7)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=gn_rtol)
    assert int(new.step) == int(jnew.step) == step
    assert int(new.opt_state["step"]) == int(jnew.opt_state["step"]) == step
    assert_bf16_state_dtypes(jnew, new)
    tol_m = []
    for name, tol in (("m", m_tol), ("v", v_tol)):
        for a, b in pairs(jnew.opt_state[name], new.opt_state[name]):
            bound = tol * float(np.abs(a).max())
            assert np.abs(b - a).max() <= bound + 1e-30, (name, np.abs(b - a).max(), bound)
            if name == "m":
                tol_m.append(bound)
    for a, b in pairs(jnew.wq, new.wq):
        assert (np.abs(b - a) <= _ulp(a)).all()
    for (a, b), mm, bound in zip(pairs(jnew.params, new.params),
                                 jax.tree_util.tree_leaves(jnew.opt_state["m"]), tol_m):
        near0 = np.abs(np.asarray(mm)) <= max(bound, g_floor / 10)
        d = np.abs(b - a)
        assert (d[~near0] <= _ulp(a)[~near0] + 2.0 ** -6 * lr).all()
        assert (d[near0] <= 2 * lr + _ulp(a)[near0]).all()


def assert_bf16_later_step_matches(jnew, jm, new, m, step: int, *,
                                   loss_rtol: float = 2.0 ** -13, gn_rtol: float = EPS / 2,
                                   m_tol: float = 8 * EPS, v_tol: float = 16 * EPS):
    """A bf16 step after the first, from states that have drifted apart by
    the ulps their earlier steps rounded differently: the step counts and
    dtypes exactly, the loss within rtol 2^-13 and the grad norm within
    ε/2 (``tests/test_torch_bf16_train_microbatches.py``'s limits), Adam's
    m and v within 8ε and 16ε of each leaf's largest value (a caller may
    widen them where it states why)."""
    assert int(new.step) == int(jnew.step) == step
    assert int(new.opt_state["step"]) == int(jnew.opt_state["step"]) == step
    assert_bf16_state_dtypes(jnew, new)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=loss_rtol)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=gn_rtol)
    for name, tol in (("m", m_tol), ("v", v_tol)):
        for a, b in pairs(jnew.opt_state[name], new.opt_state[name]):
            assert np.abs(b - a).max() <= tol * np.abs(a).max() + 1e-30, name


def assert_bf16_codes_match(arch: str):
    """The QAT forward of the reference's bf16 state, θ_t = w_q · I_t over
    the whole tree, bit for bit in both packages: the same codes from the
    same θ (and the same bf16 w_q)."""
    from repro.core import FTTQConfig as JFTTQConfig
    from repro.core.fttq import quantize_tree as jquantize_tree
    from repro_torch.convert import params_from_jax
    from repro_torch.core.fttq import FTTQConfig, quantize_tree

    _, _, jstate = reference_state(arch, {"qat": True}, lr=BF16_LR, **BF16)
    want = jax.jit(lambda p, w: jquantize_tree(p, w, JFTTQConfig()))(jstate.params, jstate.wq)
    params, wq = (params_from_jax(jax.tree_util.tree_map(np.asarray, t), "cpu")
                  for t in (jstate.params, jstate.wq))
    with torch.no_grad():
        got = quantize_tree(params, wq, FTTQConfig())
    for a, b in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
        a = np.asarray(a)
        assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
        bits = np.uint16 if a.dtype.itemsize == 2 else np.uint32
        assert np.array_equal(a.view(bits), _np(b).astype(a.dtype).view(bits))
