"""Quickstart: the paper's pipeline end to end (port of
``examples/quickstart.py``).

1. FTTQ-quantize one weight matrix (eqs. 6-12) with ``ops.fttq_apply`` and
   inspect its wire format.
2. Pack it to 2 bits (``ops.pack2bit``), check the unpacked codes, and run
   the ternary-weight matmul kernel against the dequantized fp32 product.
3. One T-FedAvg round of 3 clients with measured upload bytes.

    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu
    PYTHONPATH=src python -m repro_torch.launch.quickstart

``--device`` defaults to ``cuda`` and raises where no card is present;
``--device cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.comm.wire import update_nbytes
from repro_torch.core import fttq as F
from repro_torch.core.ternary import encode_ternary
from repro_torch.core.tfedavg import (
    TernaryUpdate, client_update_payload, server_aggregate, server_requantize,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.tree import tree_map


def main(argv=None) -> dict:
    """Run the three steps; returns their checks and, under ``tensors``, the
    layer θ, the kernels' outputs (I_t, θ_t and w_q in scaled units, the
    packed bytes and their unpacked codes)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator().manual_seed(0)
    cfg = F.FTTQConfig()
    out = {}

    # --- 1. quantize one layer -------------------------------------------
    theta = (torch.randn(512, 256, generator=gen) * 0.05).to(dev)
    i_t, theta_t_scaled, wq_scaled = ops.fttq_apply(theta, cfg.t_k)
    ts = F.scale_layer(theta)
    i_core = F.ternarize(ts, F.fttq_threshold(ts, cfg.t_k)).to(torch.int8)
    out["codes_differ_core"] = int((i_t != i_core).sum())
    wq = F.init_wq(theta, cfg)
    theta_t = F.fttq_quantize(theta, wq, cfg.t_k)
    wire = encode_ternary(i_t, wq)
    wire_bytes = wire.packed.numel() + wire.w_q.numel() * wire.w_q.element_size()
    out["layer_wire_bytes"] = wire_bytes
    print(f"layer: {theta.numel()} weights  fp32={theta.numel() * 4} B  ternary wire="
          f"{wire_bytes} B  ({theta.numel() * 4 / wire_bytes:.1f}x smaller)")
    print(f"w_q = {float(wq):.4f} (scaled units {float(wq_scaled):.4f})  sparsity = "
          f"{float((i_t == 0).float().mean()):.2%}  L2 err = "
          f"{float(torch.linalg.norm(theta - theta_t) / torch.linalg.norm(theta)):.3f}  "
          f"codes that differ from core.fttq's: {out['codes_differ_core']}")

    # --- 2. pack, unpack, ternary matmul ---------------------------------
    x = torch.randn(32, 512, generator=gen).to(dev)
    packed = ops.pack2bit(i_t)
    unpacked = ops.unpack2bit(packed)
    out["unpack_roundtrip"] = bool(torch.equal(unpacked, i_t))
    y_kernel = ops.ternary_matmul(x, packed, wq.reshape(()).to(torch.float32))
    y_ref = x @ theta_t
    out["matmul_rel_err"] = float(torch.linalg.norm(y_kernel - y_ref) / torch.linalg.norm(y_ref))
    print(f"pack2bit: {packed.numel()} B, unpack2bit round trip exact: "
          f"{out['unpack_roundtrip']}; ternary matmul kernel vs dequantized fp32: "
          f"rel err {out['matmul_rel_err']:.2e}")

    # --- 3. one T-FedAvg round -------------------------------------------
    params = {"fc": {"w": theta, "bias": torch.zeros(256, device=dev)}}
    wq_tree = F.init_wq_tree(params, cfg)
    updates = []
    for cid in range(3):
        noise = torch.Generator().manual_seed(1000 + cid)
        local = tree_map(lambda t: t + 0.01 * torch.randn(t.shape, generator=noise).to(dev),
                         params)
        payload = client_update_payload(local, wq_tree, cfg)
        updates.append(TernaryUpdate(payload=payload, n_samples=100 * (cid + 1), client_id=cid))
        print(f"client {cid}: upstream {update_nbytes(payload)} B")
    out["upload_bytes"] = [update_nbytes(u.payload) for u in updates]
    global_params = server_aggregate(updates, dev)
    out["download_bytes"] = update_nbytes(server_requantize(global_params, cfg))
    out["global_finite"] = bool(all(torch.isfinite(v).all() for v in
                                    (global_params["fc"]["w"], global_params["fc"]["bias"])))
    print(f"server aggregated; downstream re-quantized: {out['download_bytes']} B "
          "(Algorithm 2 complete)")
    out["tensors"] = {"theta": theta, "i_t": i_t, "theta_t": theta_t_scaled, "w_q": wq_scaled,
                      "packed": packed, "unpacked": unpacked}
    return out


if __name__ == "__main__":
    main()
