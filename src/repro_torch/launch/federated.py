"""FedAvg vs T-FedAvg on a synthetic stand-in for MNIST or CIFAR-10, with
accuracy and communication measured from the real serialized wire buffers
and simulated transfer times from the channel model (port of
``examples/federated_training.py``). ``--mode async`` runs the
buffered-asynchronous server.

    PYTHONPATH=src python -m repro_torch.launch.federated --device cpu --model mlp --rounds 2
    PYTHONPATH=src python -m repro_torch.launch.federated --device cpu --mode async --buffer-k 3
    PYTHONPATH=src python -m repro_torch.launch.federated --model resnet --rounds 2
    PYTHONPATH=src python -m repro_torch.launch.federated --deadline 0.3 --bandwidth-mbps 2

``--device`` defaults to ``cuda`` and raises where no card is present;
``--device cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from repro_torch.comm.channel import ChannelConfig
from repro_torch.core.fttq import FTTQConfig
from repro_torch.data import partition_iid, partition_noniid, synthetic_classification
from repro_torch.device import resolve_device
from repro_torch.fed.availability import AvailabilityConfig
from repro_torch.fed.simulation import FedConfig, run_federated
from repro_torch.models.paper_models import (
    init_mlp_mnist, init_resnet_cifar, mlp_mnist, resnet_cifar,
)
from repro_torch.optim import adam

MODELS = {
    # name: (init, apply, dim, image shape)
    "mlp": (init_mlp_mnist, mlp_mnist, 784, None),
    "resnet": (init_resnet_cifar, resnet_cifar, 3072, (32, 32, 3)),
}


def make_eval_fn(apply_fn, x_test, y_test, device: torch.device):
    """(accuracy, mean cross-entropy) of a parameter tree on the test set."""
    xt = torch.tensor(x_test, device=device)
    yt = torch.tensor(y_test, device=device).long()

    def eval_fn(params):
        with torch.no_grad():
            logits = apply_fn(params, xt)
            acc = (logits.argmax(-1) == yt).float().mean()
            return float(acc), float(F.cross_entropy(logits, yt))

    return eval_fn


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=tuple(MODELS), default="mlp")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mode", choices=("sync", "async"), default="sync")
    ap.add_argument("--buffer-k", type=int, default=4,
                    help="async: aggregate every K arrivals")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--participation", type=float, default=1.0)
    ap.add_argument("--noniid", type=int, default=0, help="classes per client (0 = IID)")
    ap.add_argument("--bandwidth-mbps", type=float, default=8.0,
                    help="median link bandwidth, megabits/s")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="round deadline in seconds (0 = none); slow clients "
                         "become emergent stragglers")
    ap.add_argument("--availability", choices=("always_on", "diurnal", "trace"),
                    default="always_on")
    ap.add_argument("--loss-rate", type=float, default=0.0,
                    help="per-chunk packet loss probability")
    ap.add_argument("--max-staleness", type=int, default=0,
                    help="async: drop updates staler than this (0 = no cap)")
    ap.add_argument("--adaptive-buffer", action="store_true",
                    help="async: retune buffer_k from the arrival rate")
    args = ap.parse_args(argv)
    if args.mode == "async" and args.deadline > 0:
        ap.error("--deadline applies to --mode sync only "
                 "(the async server never blocks on a round barrier)")
    dev = resolve_device(args.device)

    init_fn, apply_fn, dim, image_hw = MODELS[args.model]
    x, y, xt, yt = synthetic_classification(0, 4000, 10, dim, image_hw=image_hw,
                                            noise=3.0, n_test=1000)
    if args.noniid:
        clients = partition_noniid(x, y, args.clients, args.noniid)
    else:
        clients = partition_iid(x, y, args.clients)
    params = init_fn(seed=1, device=dev)
    eval_fn = make_eval_fn(apply_fn, xt, yt, dev)
    chan = ChannelConfig(
        mean_bandwidth_bytes_s=args.bandwidth_mbps * 1e6 / 8,
        deadline_s=args.deadline if args.deadline > 0 else float("inf"),
        loss_rate=args.loss_rate,
    )
    print(f"{'algo':10s} {'acc':>7s} {'upload':>10s} {'download':>10s} "
          f"{'sim-time':>9s} {'p95-xfer':>9s}")
    results = {}
    for algo in ("fedavg", "tfedavg"):
        cfg = FedConfig(algorithm=algo, mode=args.mode, n_clients=args.clients,
                        participation=args.participation, local_epochs=2, batch_size=32,
                        rounds=args.rounds, fttq=FTTQConfig(), channel=chan,
                        buffer_k=args.buffer_k, max_staleness=args.max_staleness,
                        adaptive_buffer=args.adaptive_buffer,
                        availability=AvailabilityConfig(kind=args.availability))
        res = run_federated(apply_fn, params, clients, cfg, adam(1e-3), eval_fn,
                            eval_every=args.rounds, device=dev)
        results[algo] = res
        print(f"{algo:10s} {res.accuracy[-1]:7.3f} "
              f"{res.upload_bytes / 1e6:9.2f}M {res.download_bytes / 1e6:9.2f}M "
              f"{res.total_time_s:8.2f}s "
              f"{res.transfer_summary['p95_seconds'] * 1e3:7.1f}ms")
        if sum(res.dropped_per_round):
            print(f"{'':10s} stragglers dropped per round: {res.dropped_per_round}")
        tel = res.telemetry
        if tel.get("retrans_bytes") or tel.get("dropped_updates"):
            # sync drops stragglers at the deadline, async over-stale arrivals
            what = "stale" if args.mode == "async" else "straggler"
            print(f"{'':10s} scenario: retrans {tel.get('retrans_bytes', 0) / 1e3:.1f}kB "
                  f"(goodput {tel.get('goodput_fraction', 1.0):.3f}), {what}-dropped "
                  f"{tel.get('dropped_updates', 0)} "
                  f"({tel.get('dropped_update_bytes', 0) / 1e3:.1f}kB wasted)")
        if args.adaptive_buffer and tel.get("buffer_k_per_agg"):
            print(f"{'':10s} buffer_k trajectory: {tel['buffer_k_per_agg']}")
    r = results["fedavg"].upload_bytes / results["tfedavg"].upload_bytes
    t = results["fedavg"].total_time_s / max(results["tfedavg"].total_time_s, 1e-9)
    print(f"\ncommunication compression: {r:.1f}x  wall-clock speedup: {t:.1f}x  "
          f"(paper Table IV reports ~16x; biases stay fp32, framing adds bytes)")
    return results


if __name__ == "__main__":
    main()
