"""Driver ``score``: offline batch scoring of prompts through the program's
packed-ternary serving engine (``repro_torch.launch.serve_loop
.ServeEngine``): the deployed checkpoint round-trips the wire codec
(FTTQ codes and scales, the embedding downcast to fp16), its matmul weights
repack to the 2-bit kernel layout, the other leaves stay in wire form
behind the engine's LRU dequant cache, and each forward scores one batch
of ``max_batch`` prompts of ``prompt_len`` tokens drawn from the seed, a
backlog that never runs dry (a closed loop).

Set-up deploys the weights drawn from the seed and runs one forward at the
cell's shape; the window runs whole forwards until ``--seconds`` have
passed (the engine synchronizes at the end of each). ``serve_tokens_per_s``
is the window's prompt tokens over its wall time; ``peak_mem_GiB`` the
window's allocation peak. A traced run's ``spans`` stage times the
engine's ``resolve_params`` (the dequant cache) in a span of its own,
synchronized.

``correct``: before the window the seed picks ``samples`` requests among
the first ``sample_from_forwards`` forwards; the window keeps their logits
(on the host). After it, with the engine freed, the plain reference
(``perfbench/reference``) deploys the same drawn weights itself (FTTQ codes
and Prop-4.1 scale of each whole leaf, the embedding through fp16) and runs
each sampled prompt in float32. Compared: the widest gap of a prompt
token's log-probability (the program's from its logits) from the
reference's. The widest gap of a request's mean log-probability is
printed, not compared: the control reads under three times the sound
runs' widest (``PERF.md`` section 4), so no limit separates them.

Faults (``Run.faults``): ``answer_altered`` (one position's logits of every
forward rolled by one token where the engine returns them) and
``half_batch`` (each forward runs the first half of its prompts and
repeats their logits for the rest).
"""

from __future__ import annotations

import gc
import sys

import numpy as np

from perfbench import common
from perfbench.harness import Check, Outcome
from perfbench.reference import fttq, olmo

FAULTS = ("answer_altered", "half_batch")
SPANS = True


def reference_weights(m: dict, params: dict, t_k: float) -> dict:
    """float32 weights of the deployed checkpoint: w_q · I_t of each
    quantized whole leaf, the embedding through fp16 and back."""
    import torch

    out = {}
    for path, p in params.items():
        if fttq.quantized(path, p.shape):
            i_t, scale = fttq.requantize(p, t_k=t_k, stacked=False)
            out[path] = i_t.float() * scale.float()
        elif "embed" in path:
            out[path] = p.to(torch.float16).to(p.dtype).float()
        else:
            out[path] = p.float()
    return out


def _faulty(engine, faults):
    orig = engine.forward
    if "answer_altered" in faults:
        def forward_altered(tokens):
            out = orig(tokens)
            pos = out.shape[1] // 2
            out[:, pos] = out[:, pos].roll(1, dims=-1)
            return out
        engine.forward = forward_altered
    if "half_batch" in faults:
        def forward_half(tokens):
            half = orig(tokens[: tokens.shape[0] // 2])
            return half.repeat(2, 1, 1)[: tokens.shape[0]]
        engine.forward = forward_half


def run(r) -> Outcome:
    import torch

    from repro_torch.core.fttq import FTTQConfig
    from repro_torch.dtypes import torch_dtype
    from repro_torch.launch.serve_loop import ServeEngine

    dev, m, spec = r.device, r.config["model"], r.spec
    dt = torch_dtype(r.config["dtype"])
    t_k = r.config["fttq"]["t_k"]
    b, s = spec["max_batch"], spec["prompt_len"]
    w_seed = r.seeded("weights")
    rng = np.random.default_rng(r.seeded("sample"))
    picks = sorted(zip(rng.choice(spec["sample_from_forwards"], spec["samples"], replace=False)
                       .tolist(), rng.integers(0, b, spec["samples"]).tolist()))

    def prompts(f):
        return common.tokens(m["vocab_size"], b, s, r.seeded("prompt", f), dev)

    kept = {}
    forwards = 0
    if not r.control:
        params = common.nest(common.draw_lm(m, w_seed, dt, dev))
        engine = ServeEngine(common.lm_model_config(r), params, fttq=FTTQConfig(t_k=t_k),
                             residual=spec["residual"], max_batch=b,
                             cache_capacity_bytes=spec["cache_bytes"], device=dev)
        del params
        _faulty(engine, r.faults)
        engine.forward(prompts(-1))
        if r.trace:
            resolve = engine.resolve_params

            def timed_resolve():
                with r.span("resolve"):
                    return resolve()
            engine.resolve_params = timed_resolve
        r.begin_window()
        while True:
            with r.mark("forward"):
                logits = engine.forward(prompts(forwards))
            for f, row in picks:
                if f == forwards:
                    kept[(f, row)] = logits[row].to("cpu")
            forwards += 1
            if r.unit_done(b * s):
                break
        del engine, logits
        gc.collect()
        torch.cuda.empty_cache() if r.cuda else None
    with olmo.float32_matmuls():
        weights = reference_weights(m, common.draw_lm(m, w_seed, dt, dev), t_k)
        lp_gap = nll_gap = 0.0
        compared = 0
        for f, row in picks:
            tok = prompts(f)[row:row + 1]
            want = olmo.token_logprobs(m, weights, tok)[0]
            if r.control:
                got = olmo.token_logprobs(m, weights, tok, act="fp8")[0]
            elif (f, row) in kept:
                lg = torch.log_softmax(kept[(f, row)].to(dev).float(), dim=-1)
                got = lg[:-1].gather(-1, tok[0, 1:, None])[..., 0]
            else:
                continue
            compared += 1
            lp_gap = max(lp_gap, float((got - want).abs().max()))
            nll_gap = max(nll_gap, float((got.mean() - want.mean()).abs()))
    lim = spec["limits"]
    print(f"read mean_logprob_gap {nll_gap!r}", file=sys.stderr)
    checks = [Check("logprob_gap", lp_gap, lim["logprob_gap"]),
              Check("requests_compared_missing", float(compared == 0), 0.0)]
    rate = r.rate()
    e2e = ({"serve_tokens_per_s": rate, "peak_mem_GiB": r.window_peak / 2 ** 30}
           if rate else {})
    return Outcome(attempted=forwards * b, failed=0, e2e=e2e, layer={"rows": b * s},
                   checks=checks)
