"""Prefill and decode step factories over the port's model (port of
``repro.launch.steps``; the train step is ``train.trainer.make_train_step``).

  prefill → forward with a fresh KV cache (serving admission), optionally
            chunked along the sequence
  decode  → one-token incremental step against a filled cache

Single device; the dry-run that drives them over a mesh is not ported yet
(ROADMAP).
"""

from __future__ import annotations

from repro_torch.models import transformer as tfm


def make_prefill_step(cfg: tfm.ModelConfig, max_seq: int, chunks: int = 1):
    """f(params, batch) → (next-token logits (B, 1, V), cache), or (logits,
    None) for an encoder-only model. ``chunks`` > 1 runs the prompt through
    the cache in that many sequence chunks (chunked prefill), dividing peak
    activation memory by about ``chunks`` for one extra cache pass each."""

    def prefill(params, batch):
        first = batch.get("tokens", batch.get("embeds"))
        bsz, seq = first.shape[0], first.shape[1]
        if not cfg.causal:
            logits, _, _ = tfm.forward(cfg, params, batch.get("tokens"),
                                       embeds=batch.get("embeds"),
                                       vision_embeds=batch.get("vision_embeds"))
            return logits, None
        cache = tfm.init_cache(cfg, bsz, max_seq, cfg.cdtype(), device=first.device)
        n = max(1, min(chunks, seq))
        clen = seq // n
        logits = None
        for i in range(n):
            sl = slice(i * clen, (i + 1) * clen if i < n - 1 else seq)
            logits, cache, _ = tfm.forward(
                cfg, params, batch["tokens"][:, sl] if "tokens" in batch else None,
                embeds=batch["embeds"][:, sl] if "embeds" in batch else None,
                vision_embeds=batch.get("vision_embeds"), cache=cache, pos=i * clen)
        return logits[:, -1:], cache

    return prefill


def make_decode_step(cfg: tfm.ModelConfig):
    """f(params, batch{tokens, cache, pos[, vision_embeds]}) → (logits,
    cache); the cache is written in place."""

    def decode(params, batch):
        return tfm.decode_step(cfg, params, batch["tokens"], batch["cache"], batch["pos"],
                               vision_embeds=batch.get("vision_embeds"))

    return decode
