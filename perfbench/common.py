"""Inputs the benchmark makes from ``--seed`` and hands to the program and
the reference alike: language-model weights and token batches, drawn on the
device from ``torch.Generator``s seeded by name, so either side can draw any
leaf or batch again by itself."""

from __future__ import annotations

from perfbench.harness import sub_seed


def lm_model_config(r):
    """The program's ``ModelConfig`` of a dense LM configuration file, in
    its dtype, with the cell's remat."""
    from repro_torch.models.transformer import ModelConfig

    dt = r.config["dtype"]
    return ModelConfig(name=r.cell["config"], family="dense", param_dtype=dt, compute_dtype=dt,
                       remat=r.spec.get("remat", "none"), **r.config["model"])


def lm_shapes(m: dict) -> dict:
    """{path: shape} of a dense decoder LM's parameters, layers stacked."""
    d, nl, v = m["d_model"], m["n_layers"], m["vocab_size"]
    hd = m.get("head_dim") or d // m["n_heads"]
    h, hk, f = m["n_heads"] * hd, m["n_kv_heads"] * hd, m["d_ff"]
    shapes = {"embed/table": (v, d),
              "blocks/attn/wq": (nl, d, h), "blocks/attn/wk": (nl, d, hk),
              "blocks/attn/wv": (nl, d, hk), "blocks/attn/wo": (nl, h, d),
              "blocks/mlp/w_in": (nl, d, f), "blocks/mlp/w_out": (nl, f, d)}
    if m.get("gated_mlp", True):
        shapes["blocks/mlp/w_gate"] = (nl, d, f)
    if m.get("norm", "rmsnorm") != "nonparam":
        shapes.update({"blocks/attn_norm": (nl, d), "blocks/mlp_norm": (nl, d),
                       "final_norm": (d,)})
    if not m.get("tie_embeddings"):
        shapes["lm_head"] = (d, v)
    return shapes


def draw_leaf(path: str, shape: tuple, seed: int, dtype, device):
    """Embeddings N(0, 0.02²), matrices Lecun-normal (fan-in the next-to-
    last dim), norm scales zero; drawn in float32 and cast."""
    import torch

    if len(shape) < 2 or path.endswith("_norm") or path == "final_norm":
        return torch.zeros(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights", path))
    std = 0.02 if "embed" in path else float(shape[-2]) ** -0.5
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(std).to(dtype)


def draw_lm(m: dict, seed: int, dtype, device) -> dict:
    """{path: tensor} of every parameter."""
    return {p: draw_leaf(p, s, seed, dtype, device) for p, s in lm_shapes(m).items()}


def nest(flat: dict) -> dict:
    """A flat {"a/b": x} tree as the program's nested dicts."""
    root: dict = {}
    for path, v in flat.items():
        node = root
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return root


def tokens(vocab: int, batch: int, seq: int, seed: int, device):
    """(B, S) int64 token ids, uniform over the vocabulary."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, vocab, (batch, seq), generator=gen, device=device)
