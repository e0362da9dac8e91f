"""Batched serving driver: prefill + greedy decode, optionally on ternary
weights that went through the wire (port of ``repro.launch.serve``).

With ``--ternary`` the model is compressed to the TFW1 wire format,
serialized and decoded back before serving, so the printed download size is
the measured byte count of the edge checkpoint. ``--packed`` also serves
the weights 2-bit: decoded ternary records are repacked into the
``(K//4, N)`` layout of ``kernels.ternary_matmul`` and every weight matmul
runs through that kernel; a dequantized copy exists only for the logits
check against the reference path. ``--packed`` serves the families whose
hot matmuls are attention and MLP weights (dense, vlm, audio); moe, ssm and
hybrid route theirs elsewhere and take ``--ternary`` alone. ``--dtype
bfloat16`` serves bf16 weights and activations (the packed matmul then takes
bf16 x and returns bf16, as the reference kernel does). ``--residual-codec``
picks the wire codec of the non-quantizable leaves (norms, embeddings);
``--loss-rate`` runs the download estimate through the lossy channel.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \
        --no-reduced --batch 4 --prompt-len 32 --gen 16 --ternary --packed [--dtype bfloat16]
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch llama-3.2-vision-11b --ternary --packed

The entry points run on ``--device cuda`` (the default) and raise where no
card is present; ``--device cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.comm import Channel, ChannelConfig, ClientLink, decode_update, encode_update
from repro_torch.comm.wire import update_nbytes
from repro_torch.core.compression import CodecSpec, compress_pytree, decompress_pytree
from repro_torch.core.fttq import FTTQConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.repack import packed_params_from_wire
from repro_torch.models.frontends import synth_vision_patches
from repro_torch.models.transformer import (
    ModelConfig, decode_step, forward, init_cache, init_params, param_count,
)

PACKED_FAMILIES = ("dense", "vlm", "audio")


def ternary_deploy(params, cfg: FTTQConfig, *, packed: bool = False,
                   residual: str = "none", link: ClientLink | None = None,
                   loss_rate: float = 0.0, device: str | torch.device = "cuda"):
    """Compress → serialize → decode the deployment artifact onto ``device``.

    Returns (served_params, wire_bytes, est_download_s, link). With
    ``packed=False`` the artifact dequantizes to dense tensors (reference
    path); with ``packed=True`` ternary records repack into the ``(K//4, N)``
    kernel layout and stay 2-bit in device memory. ``residual`` is the
    codec of the non-quantizable leaves. ``loss_rate`` runs the download
    estimate through the lossy channel model (chunk loss and retransmission)
    over the same link."""
    dev = resolve_device(device)
    spec = CodecSpec(kind="ternary", residual=residual, fttq=cfg)
    wire_tree, _ = compress_pytree(params, spec)
    blob = encode_update(wire_tree)
    decoded = decode_update(blob)
    if packed:
        served = packed_params_from_wire(decoded, dev)
    else:
        served = decompress_pytree(decoded, dev)
    if link is None:
        c = ChannelConfig()
        link = ClientLink(0, c.mean_bandwidth_bytes_s, c.base_latency_s, 1.0)
    if loss_rate > 0.0:
        chan = Channel(ChannelConfig(latency_jitter_s=0.0, loss_rate=loss_rate,
                                     chunk_bytes=4096), 1, seed=0)
        chan.links[0] = link   # meter over THIS link, not a fresh draw
        return served, len(blob), chan.transfer(0, len(blob), "down"), link
    return served, len(blob), link.transfer_time(len(blob)), link


def packed_logits_check(cfg: ModelConfig, packed_params, ref_params,
                        probe: torch.Tensor | None, **inputs) -> tuple[float, float]:
    """(max |logits_packed − logits_ref|, max |logits_ref|) on ``probe``
    (and ``embeds=`` / ``vision_embeds=`` when given): the packed-kernel path
    against the dequantized reference path."""
    lp, _, _ = forward(cfg, packed_params, probe, **inputs)
    lr, _, _ = forward(cfg, ref_params, probe, **inputs)
    return float((lp - lr).abs().max()), float(lr.abs().max())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg: ModelConfig, params, prompts: torch.Tensor, gen: int, *,
             vision_embeds: torch.Tensor | None = None):
    """Prefill ``prompts`` (B, S) then greedy-decode to ``gen`` tokens.
    Returns (tokens (B, gen), prefill seconds, decode seconds)."""
    dev = prompts.device
    b, s = prompts.shape
    cache = init_cache(cfg, b, s + gen, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache, _ = forward(cfg, params, prompts, vision_embeds=vision_embeds,
                               cache=cache, pos=0)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = decode_step(cfg, params, tok, cache, s + i,
                                    vision_embeds=vision_embeds)
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
    _sync(dev)
    return torch.cat(out, dim=1), t_prefill, time.perf_counter() - t0


def _seeded_tokens(seed: int, shape, vocab: int, device: torch.device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, vocab, shape, generator=gen, device=device)


def _vision(cfg: ModelConfig, seed: int, batch: int, device: torch.device):
    """Synthetic patch embeddings for a vlm (None for the other families)."""
    if cfg.family != "vlm":
        return None
    gen = torch.Generator(device=device).manual_seed(seed)
    return synth_vision_patches(gen, batch, cfg.n_patches, cfg.d_model)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True,
                    help="the architecture's reduced smoke config (--no-reduced "
                         "for full width)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--ternary", action="store_true")
    ap.add_argument("--packed", action="store_true",
                    help="serve through kernels.ternary_matmul on the packed "
                         "2-bit layout (requires --ternary)")
    ap.add_argument("--residual-codec", default="none",
                    choices=["none", "fp16", "bf16", "topk"],
                    help="codec for the non-quantizable wire leaves")
    ap.add_argument("--loss-rate", type=float, default=0.0,
                    help="edge-link packet loss for the download estimate "
                         "(chunk retransmission through comm.channel)")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                    help="parameter and compute dtype of the model (bfloat16: bf16 "
                         "weights and activations, bf16 through the packed matmul)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.packed and not args.ternary:
        raise SystemExit("--packed requires --ternary")
    dev = resolve_device(args.device)

    from repro_torch.configs import get_config, get_reduced

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    cfg = dataclasses.replace(cfg, param_dtype=args.dtype, compute_dtype=args.dtype)
    if not cfg.causal:
        raise SystemExit(f"{args.arch} is encoder-only — no decode path")
    if args.packed and cfg.family not in PACKED_FAMILIES:
        raise SystemExit(
            f"--packed serves attention+mlp weights; family {cfg.family!r} "
            "routes its hot matmuls elsewhere (moe/ssm) — use --ternary alone"
        )
    params = init_params(cfg, seed=0, device=dev)
    print(f"serving {cfg.name} on {dev}: {param_count(cfg) / 1e6:.1f}M params, "
          f"ternary={args.ternary} packed={args.packed}")
    if args.ternary:
        fp_bytes = update_nbytes(params)
        served, wire_bytes, dl_s, link = ternary_deploy(
            params, FTTQConfig(), packed=args.packed, residual=args.residual_codec,
            loss_rate=args.loss_rate, device=dev)
        print(f"edge checkpoint: {wire_bytes / 1e6:.2f} MB on the wire "
              f"(fp32 {fp_bytes / 1e6:.2f} MB, {fp_bytes / wire_bytes:.1f}× "
              f"smaller), est. download {dl_s:.1f}s "
              f"@ {link.bandwidth_bytes_s / 1e6:.1f} MB/s")
        if args.packed:
            ref_params, _, _, _ = ternary_deploy(params, FTTQConfig(), packed=False,
                                                 residual=args.residual_codec, device=dev)
            probe = _seeded_tokens(9, (2, 8), cfg.vocab_size, dev)
            diff, _ = packed_logits_check(cfg, served, ref_params, probe,
                                          vision_embeds=_vision(cfg, 3, 2, dev))
            print(f"packed-vs-dequant logits: max |Δ| = {diff:.2e}")
            del ref_params
        params = served

    b, s = args.batch, args.prompt_len
    prompts = _seeded_tokens(1, (b, s), cfg.vocab_size, dev)
    tokens, t_prefill, t_decode = generate(cfg, params, prompts, args.gen,
                                           vision_embeds=_vision(cfg, 2, b, dev))
    print(f"prefill: {b}×{s} tokens in {t_prefill * 1e3:.0f} ms")
    print(f"decode: {args.gen - 1} steps × batch {b} in {t_decode * 1e3:.0f} ms "
          f"({b * (args.gen - 1) / max(t_decode, 1e-9):.1f} tok/s)")
    print("sample tokens:", tokens[0, :12].tolist())


if __name__ == "__main__":
    main()
