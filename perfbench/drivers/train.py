"""Driver ``train``: QAT training of a dense language model through the
program's train step (``repro_torch.train.make_train_step`` on
``init_train_state``'s state), on token batches drawn from the seed, every
one different.

Set-up builds the one state and step, drives them through the first
``reference_steps`` steps (the first one warms every shape), and hands the
same state to the window, which runs whole steps, each synchronized, until
``--seconds`` have passed. ``train_tokens_per_s`` is the window's tokens
over its wall time; ``peak_mem_GiB`` the window's allocation peak.

What set-up keeps of its steps, on the host: the codes of the first QAT
forward (as the step's own quantizer produced them: the sign of each
quantized leaf's w_q · I_t), each leaf's first clipped gradient as Adam
took it (the first moment after one step, m / (1 − β₁)), each loss, the
w_q factors and each leaf's change after the set-up's steps (the state the
next step takes).

``correct``: the plain reference (``perfbench/reference/olmo.py``, float32,
TF32 off) trains the same drawn weights on the same batches for the
set-up's steps, after the program's state is freed. Compared against their
limits in the cell's file, over the leaves whose reference gradient is
above 1e-3 of the median leaf's:

- ``first_grad_diff``: the worst leaf's ‖g_program − g_reference‖ over the
  larger of that leaf's ‖g_reference‖ and the median leaf's: a gradient of
  the wrong direction or precision shows here, where a gap of norms cannot;
- ``change_norm_gap``: the worst leaf's gap between the norms of the two
  changes after the set-up's steps, by the same rule;
- ``codes_differ_share``: the share of the first forward's codes that
  differ from the reference's.

Read and printed, not compared (no control or fault moves them past the
sound runs' readings, ``PERF.md`` section 4): the worst step's relative
loss gap, the worst leaf's gap of the first gradient's norms and
``scale_gap``, the worst relative gap of a w_q factor after the steps (the
two sides round the same statistic to bf16 from sums in another order).

The control (``Run.control``) is the reference in the program's place with
every matmul's inputs rounded to float8 e4m3. Faults (``Run.faults``, for
the tests and the limits): ``state_unchanged`` (the step returns the state
it was given) and ``half_batch`` (the step takes the first half of each
batch).
"""

from __future__ import annotations

import contextlib
import gc
import math
import sys

from perfbench import common
from perfbench.harness import Check, Outcome
from perfbench.reference import compare, olmo

FAULTS = ("state_unchanged", "half_batch")


def _faulty(step, faults):
    if "state_unchanged" in faults:
        def step_unchanged(state, batch):
            _, m = step(state, batch)
            return state, m
        return step_unchanged
    if "half_batch" in faults:
        def step_half(state, batch):
            return step(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
        return step_half
    return step


@contextlib.contextmanager
def _first_codes(fttq_mod, codes: dict):
    """While open, the first call of the program's QAT quantizer records the
    codes of every leaf it quantizes, on the host, as int8."""
    import torch

    orig = fttq_mod.quantize_tree

    def recording(params, wq_tree, cfg, shards=None):
        out = orig(params, wq_tree, cfg, shards)
        if not codes:
            wqs = olmo.flat(wq_tree) if isinstance(wq_tree, dict) else {}
            for path, q in olmo.flat(out).items():
                if wqs.get(path) is not None:
                    codes[path] = q.detach().sign().to("cpu", torch.int8)
        return out

    fttq_mod.quantize_tree = recording
    try:
        yield
    finally:
        fttq_mod.quantize_tree = orig


def _program(r, m, spec, dt, t_k, w_seed, batch) -> tuple[dict, int, int]:
    """Set-up, the window and what set-up kept: (got, units, failed)."""
    import torch

    from repro_torch.core import fttq as fttq_mod
    from repro_torch.core.fttq import FTTQConfig
    from repro_torch.optim import adam
    from repro_torch.train import TrainerConfig, init_train_state, make_train_step

    dev, k_steps = r.device, spec["reference_steps"]
    b, s = spec["batch"], spec["seq"]
    cfg = common.lm_model_config(r)
    tcfg = TrainerConfig(qat=True, microbatches=spec["microbatches"], fttq=FTTQConfig(t_k=t_k))
    opt = adam(spec["lr"])
    state = init_train_state(cfg, tcfg, opt, params=common.nest(common.draw_lm(
        m, w_seed, dt, dev)), device=dev)
    step = _faulty(make_train_step(cfg, tcfg, opt), r.faults)
    got = {"losses": [], "codes": {}, "first_grads": {}}
    for i in range(k_steps):
        with _first_codes(fttq_mod, got["codes"]) if i == 0 else contextlib.nullcontext():
            state, met = step(state, batch(i))
        got["losses"].append(float(met["loss"]))
        if i == 0:
            got["first_grads"] = {p: (x / (1 - 0.9)).to("cpu")
                                  for p, x in olmo.flat(state.opt_state["m"]).items()}
    got["factors"] = {p: w.detach().to("cpu") for p, w in olmo.flat(state.wq).items()
                      if w is not None}
    got["change_norms"] = {}
    for p, x in olmo.flat(state.params).items():
        x0 = common.draw_leaf(p, tuple(x.shape), w_seed, dt, dev)
        got["change_norms"][p] = float((x.float() - x0.float()).double().norm())
        del x0
    r.begin_window()
    units = failed = 0
    i = k_steps
    while True:
        with r.mark("step"):
            state, met = step(state, batch(i))
            loss = float(met["loss"])
        i += 1
        units += 1
        failed += not math.isfinite(loss)
        if r.unit_done(b * s, not math.isfinite(loss)):
            break
    del state, step, met
    gc.collect()
    torch.cuda.empty_cache() if r.cuda else None
    return got, units, failed


def _control(m, params, batches, kw) -> dict:
    """The reference at float8 matmul inputs, kept as the program's run is."""
    import torch

    got = {"codes": {}, "first_grads": {}}

    def keep(path, g, codes):
        got["first_grads"][path] = g.to("cpu")
        if codes is not None:
            got["codes"][path] = codes.to("cpu", torch.int8)

    out = olmo.train(m, params, batches, act="fp8", first_step_hook=keep, **kw)
    got.update(losses=out["losses"], change_norms=out["change_norms"],
               factors={p: f.to("cpu") for p, f in out["factors"].items()})
    return got


def run(r) -> Outcome:
    import torch

    from repro_torch.dtypes import torch_dtype

    dev, m, spec = r.device, r.config["model"], r.spec
    dt = torch_dtype(r.config["dtype"])
    b, s, k_steps = spec["batch"], spec["seq"], spec["reference_steps"]
    t_k = r.config["fttq"]["t_k"]
    w_seed = r.seeded("weights")

    def batch(i):
        t = common.tokens(m["vocab_size"], b, s + 1, r.seeded("batch", i), dev)
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}

    units = failed = 0
    if not r.control:
        got, units, failed = _program(r, m, spec, dt, t_k, w_seed, batch)

    with olmo.float32_matmuls():
        batches = [(x["tokens"], x["labels"]) for x in map(batch, range(k_steps))]
        kw = dict(lr=spec["lr"], microbatches=spec["microbatches"], t_k=t_k)
        if r.control:
            got = _control(m, common.draw_lm(m, w_seed, dt, dev), batches, kw)
        diff, norms = {}, {}
        codes = {"differ": 0, "total": 0}

        def judge(path, g, want_codes):
            mine = got["first_grads"][path].to(g.device)
            norms[path] = float(torch.linalg.vector_norm(mine, dtype=torch.float64))
            diff[path] = float(torch.linalg.vector_norm(mine - g, dtype=torch.float64))
            del mine
            if want_codes is not None:
                prog = got["codes"].get(path)
                codes["total"] += want_codes.numel()
                codes["differ"] += (want_codes.numel() if prog is None else
                                    int((prog.to(g.device) != want_codes.to(torch.int8)).sum()))

        want = olmo.train(m, common.draw_lm(m, w_seed, dt, dev), batches,
                          first_step_hook=judge, **kw)
    moving = compare.moving_leaves(want["first_grad_norms"])
    loss_gap = max(compare.rel_gap(g, w) for g, w in zip(got["losses"], want["losses"]))
    grad_gap, _ = compare.worst_norm_gap(norms, want["first_grad_norms"], moving)
    diff_gap, _ = compare.worst_share(diff, want["first_grad_norms"], moving)
    change_gap, _ = compare.worst_norm_gap(got["change_norms"], want["change_norms"], moving)
    scale_gap = max((float(((got["factors"][p].double().reshape(-1)
                             - f.double().cpu().reshape(-1)).abs()
                            / f.double().cpu().reshape(-1).abs().clamp_min(1e-30)).max())
                     if p in got["factors"] else 1.0) for p, f in want["factors"].items())
    lim = spec["limits"]
    print(f"read loss_gap {loss_gap!r} first_grad_norm_gap {grad_gap!r} "
          f"scale_gap {scale_gap!r}", file=sys.stderr)
    checks = [Check("first_grad_diff", diff_gap, lim["first_grad_diff"]),
              Check("change_norm_gap", change_gap, lim["change_norm_gap"]),
              Check("codes_differ_share", codes["differ"] / max(codes["total"], 1),
                    lim["codes_differ_share"])]
    rate = r.rate()
    e2e = ({"train_tokens_per_s": rate, "peak_mem_GiB": r.window_peak / 2 ** 30}
           if rate else {})
    return Outcome(attempted=units, failed=failed, e2e=e2e, layer={}, checks=checks)
