"""Prefill and decode step factories over the port's model (port of
``repro.launch.steps``; the train step is ``train.trainer.make_train_step``).

  prefill → forward with a fresh KV cache (serving admission), optionally
            chunked along the sequence
  decode  → one-token incremental step against a filled cache

With a ``mesh`` whose "model" or "data" axis has size > 1, every rank of it
calls the step with the same batch and its params' shards
(``init_params(..., mesh=)``). Over "model" (tensor parallelism) the cache
holds the rank's kv heads (the SSM states whole), and the logits are
all-gathered over the vocabulary, so each rank returns the reference's
(B, 1, V). Over "data" (FSDP) each layer gathers its weights where it uses
them, with no autograd; the batch and the cache stay whole there (every
rank runs the whole batch: serving rows over "data" and sequence-parallel
decode are ROADMAP 14b-v). The dry-run that drives the steps over the
reference's production mesh is not ported yet (ROADMAP).
"""

from __future__ import annotations

from repro_torch.models import transformer as tfm
from repro_torch.parallel.tensor import data_axis, model_axis


def make_prefill_step(cfg: tfm.ModelConfig, max_seq: int, chunks: int = 1, mesh=None):
    """f(params, batch) → (next-token logits (B, 1, V), cache), or (logits,
    None) for an encoder-only model. ``chunks`` > 1 runs the prompt through
    the cache in that many sequence chunks (chunked prefill), dividing peak
    activation memory by about ``chunks`` for one extra cache pass each."""
    tfm.check_tensor_parallel(cfg, mesh.size("model") if mesh is not None else 1)
    tp, fsdp = model_axis(mesh), data_axis(mesh)

    def prefill(params, batch):
        first = batch.get("tokens", batch.get("embeds"))
        bsz, seq = first.shape[0], first.shape[1]
        if not cfg.causal:
            logits, _, _ = tfm.forward(cfg, params, batch.get("tokens"),
                                       embeds=batch.get("embeds"),
                                       vision_embeds=batch.get("vision_embeds"), tp=tp,
                                       fsdp=fsdp)
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
                fsdp=fsdp)
        return tfm.whole_logits(cfg, logits[:, -1:], tp), cache

    return prefill


def make_decode_step(cfg: tfm.ModelConfig, mesh=None):
    """f(params, batch{tokens, cache, pos[, vision_embeds]}) → (logits,
    cache); the cache is written in place."""
    tfm.check_tensor_parallel(cfg, mesh.size("model") if mesh is not None else 1)
    tp, fsdp = model_axis(mesh), data_axis(mesh)

    def decode(params, batch):
        logits, cache = tfm.decode_step(cfg, params, batch["tokens"], batch["cache"],
                                        batch["pos"], vision_embeds=batch.get("vision_embeds"),
                                        tp=tp, fsdp=fsdp)
        return tfm.whole_logits(cfg, logits, tp), cache

    return decode
