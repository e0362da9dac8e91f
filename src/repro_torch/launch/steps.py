"""Prefill and decode step factories over the port's model (port of
``repro.launch.steps``; the train step is ``train.trainer.make_train_step``).

  prefill → forward with a fresh KV cache (serving admission), optionally
            chunked along the sequence
  decode  → one-token incremental step against a filled cache

With a ``mesh``, every rank of it calls the prefill with the same global
batch and its params' shards (``init_params(..., mesh=)``), and the steps
follow ``parallel.sharding.batch_specs`` and ``cache_specs``
(``parallel.tensor.serve_layout``):

- Rows: where the global batch divides over ("pod", "data"), each rank
  serves its block of rows (tokens, embeds, vision_embeds), its cache holds
  only those rows, and it returns its rows' logits (B/n, 1, V);
  ``parallel.tensor.gather_rows`` rebuilds the reference's (B, 1, V). The
  MoE layers route the ranks' rows as one batch. Where the batch does not
  divide (batch 1), every rank serves the whole batch.
- The cache: kv heads over "model" where they divide; else its sequence
  over "model"; with a batch that does not divide, its sequence over
  "data" (or ("data", "model")). Attention over a sequence-cut cache
  combines each rank's partial softmax (``models.attention``); prefill
  writes each chunk into the owning ranks' slots, so no rank holds the
  prompt's whole cache.
- Over "model" (tensor parallelism) the logits are all-gathered over the
  vocabulary inside the step; over "data" (FSDP) each layer gathers its
  weights where it uses them, with no autograd.
"""

from __future__ import annotations

from repro_torch.models import transformer as tfm
from repro_torch.parallel.tensor import batch_ranks, data_axis, model_axis, serve_layout

_ROW_KEYS = ("tokens", "embeds", "vision_embeds")


def make_prefill_step(cfg: tfm.ModelConfig, max_seq: int, chunks: int = 1, mesh=None):
    """f(params, batch) → (next-token logits (B, 1, V), cache), or (logits,
    None) for an encoder-only model; on a mesh the rank's rows of both.
    ``chunks`` > 1 runs the prompt through the cache in that many sequence
    chunks (chunked prefill), dividing peak activation memory by about
    ``chunks`` for one extra cache pass each."""
    tfm.check_tensor_parallel(cfg, mesh.size("model") if mesh is not None else 1)
    tp, fsdp = model_axis(mesh), data_axis(mesh)

    def prefill(params, batch):
        first = batch.get("tokens", batch.get("embeds"))
        bsz, seq = first.shape[0], first.shape[1]
        lay = serve_layout(cfg, mesh, bsz)
        batch = {k: lay.take(v) if k in _ROW_KEYS else v for k, v in batch.items()}
        if not cfg.causal:
            logits, _, _ = tfm.forward(cfg, params, batch.get("tokens"),
                                       embeds=batch.get("embeds"),
                                       vision_embeds=batch.get("vision_embeds"), tp=tp,
                                       dp=lay.rows, fsdp=fsdp)
            return tfm.whole_logits(cfg, logits, tp), None
        cache = tfm.init_cache(cfg, bsz, max_seq, cfg.cdtype(), device=first.device, mesh=mesh)
        n = max(1, min(chunks, seq))
        clen = seq // n
        logits = None
        for i in range(n):
            sl = slice(i * clen, (i + 1) * clen if i < n - 1 else seq)
            logits, cache, _ = tfm.forward(
                cfg, params, batch["tokens"][:, sl] if "tokens" in batch else None,
                embeds=batch["embeds"][:, sl] if "embeds" in batch else None,
                vision_embeds=batch.get("vision_embeds"), cache=cache, pos=i * clen, tp=tp,
                dp=lay.rows, fsdp=fsdp, seq=lay.seq)
        return tfm.whole_logits(cfg, logits[:, -1:], tp), cache

    return prefill


def make_decode_step(cfg: tfm.ModelConfig, mesh=None, batch: int | None = None):
    """f(params, batch{tokens, cache, pos[, vision_embeds]}) → (logits,
    cache); the cache is written in place. On a mesh, ``batch`` is the
    global batch the cache was made for (default: the cache's rows times
    the ranks of ("pod", "data"), i.e. a batch that divides over them; give
    it where it does not, as for batch 1). The tokens and vision_embeds may
    be this rank's rows (the rows its cache holds, as the prefill's and the
    last decode's logits are) or the global batch, of which the step takes
    its block; the logits are this rank's rows."""
    tfm.check_tensor_parallel(cfg, mesh.size("model") if mesh is not None else 1)
    tp, fsdp = model_axis(mesh), data_axis(mesh)

    def decode(params, step_batch):
        cache = step_batch["cache"]
        own = next(iter(cache.values())).shape[1]
        global_b = batch
        if global_b is None:
            global_b = own * batch_ranks(mesh)
        lay = serve_layout(cfg, mesh, global_b)

        def rows(x):
            if x is None or x.shape[0] == own:
                return x
            if x.shape[0] == global_b:
                return lay.take(x)
            raise ValueError(f"{x.shape[0]} rows are neither this rank's {own} nor the "
                             f"global batch's {global_b}")

        logits, cache = tfm.decode_step(cfg, params, rows(step_batch["tokens"]), cache,
                                        step_batch["pos"],
                                        vision_embeds=rows(step_batch.get("vision_embeds")),
                                        tp=tp, dp=lay.rows, fsdp=fsdp, seq=lay.seq)
        return tfm.whole_logits(cfg, logits, tp), cache

    return decode

