"""Driver ``fed``: synchronous federated rounds (arXiv:2003.03564 Algorithm
2) through the program's server, ``repro_torch.fed.simulation
.run_federated_sync``, with its streaming ``Aggregator`` fan-in, on data and
weights drawn from the seed: Gaussian-mixture images of the configuration's
shape, split IID over its clients.

One call of the server runs set-up and window: its first round warms every
shape (local training, the encodes, the wire and the fold) and is the round
the reference replays; the window then runs whole rounds until
``--seconds`` have passed, and the benchmark's round-end hook (the server's
``eval_fn``, called after every round with the folded model) synchronizes
the device, ends the unit and, after the last, stops the server.
``fed_samples_per_s`` is the window's local-training samples over its wall
time. In a traced run's ``spans`` stage alone the server's ``PhaseTimer``
(which synchronizes at each phase's end) times the per-phase metrics.

``correct``: the plain reference (``perfbench/reference/resnet.py``, and
``reference/wire.py`` to read what the program shipped) replays the first
round after the window: the broadcast re-quantized from the drawn weights
(codes equal, scales and full-precision leaves within the limit), each
client's local training on the batches the program drew for it (E epochs
of ⌊n / B⌋ batches, each sample once an epoch) from the same start, its
upload (the worst relative gap of the factors; the share of codes that
differ is printed, not compared, PERF.md section 4; and the full-precision
leaves' change from the broadcast by the
training rule: the gap of the norms, and the norm of the difference, each
over the larger of the leaf's and the median leaf's change; the second
sees a change of the wrong direction, which the first cannot), the wire buffers (read whole: header, CRC, every record's
length), the server's fold of the program's own uploads (the worst leaf's
largest gap over its largest value) and the second round's broadcast,
re-quantized from the program's fold. FedAvg ships float32 both ways: its
uploads are judged by the change of their leaves alone.

The control (``Run.control``) runs the program for its batch plan and puts
the reference's uploads, trained with TF32 on (the precision below the
configuration's float32), in the place of the program's.

Faults (``Run.faults``): ``state_unchanged`` (every local step returns the
state it was given), ``half_batch`` (each local step takes the first
half of its batch), ``answer_altered`` (one byte of the second
round's broadcast altered where it is encoded, its CRC made good) and
``half_fold`` (the server's fan-in folds every other upload, the weighted
mean taken over the rest).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import statistics
import sys

from perfbench.harness import Check, Outcome
from perfbench.reference import resnet, wire

FAULTS = ("state_unchanged", "half_batch", "answer_altered", "half_fold")
SPANS = True
ROUNDS = 10 ** 6     # more than any window holds: the round-end hook stops the server


class _Stop(Exception):
    """Raised from the round-end hook to end the server's run."""


def make_data(m: dict, seed: int, device):
    """(x, y) float32 (N, H, W, C) images and int32 labels: class centres
    N(0, 1), each sample its centre plus N(0, noise²), drawn on ``device``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    n = m["clients"] * m["samples_per_client"]
    dim = m["image_hw"][0] * m["image_hw"][1] * m["image_hw"][2]
    centres = torch.randn((m["n_classes"], dim), generator=gen, device=device)
    y = torch.randint(0, m["n_classes"], (n,), generator=gen, device=device)
    x = centres[y] + m["noise"] * torch.randn((n, dim), generator=gen, device=device)
    return x.reshape(n, *m["image_hw"]), y.to(torch.int32)


def _clients(x, y, m: dict, seed: int, record: dict):
    """IID shards of ``samples_per_client`` as the program's
    ``ClientDataset``s, recording the batches each draws while
    ``record["on"]``."""
    import numpy as np

    from repro_torch.data.federated import ClientDataset

    class Recorded(ClientDataset):
        def index_batches(self, batch_size, rng, epochs=1):
            mine = record["batches"].setdefault(self.client_id, []) if record["on"] else None
            for sel in super().index_batches(batch_size, rng, epochs):
                if mine is not None:
                    mine.append(np.array(sel))
                yield sel

    xs, ys = x.cpu().numpy(), y.cpu().numpy()
    order = np.random.default_rng(seed).permutation(len(ys))
    shards = np.array_split(order, m["clients"])
    return [Recorded(xs[s], ys[s], k) for k, s in enumerate(shards)]


def _switched_timer(sim, r):
    """The server's ``PhaseTimer``, timing only while ``r.instrumented``:
    its rounds are those of the ``spans`` stage."""

    class Switched(sim.PhaseTimer):
        def start_round(self, n):
            if r.instrumented:
                super().start_round(n)

        def phase(self, name):
            return super().phase(name) if r.instrumented else contextlib.nullcontext()

    return Switched(r.device)


def _patch(module, name, wrap):
    orig = getattr(module, name)
    setattr(module, name, wrap(orig))
    return lambda: setattr(module, name, orig)


def run(r) -> Outcome:
    import torch

    from repro_torch.fed import simulation as sim
    from repro_torch.core.fttq import FTTQConfig
    from repro_torch.models.paper_models import resnet_cifar
    from repro_torch.optim import adam

    dev, m, spec = r.device, r.config["model"], r.spec
    ft = r.config["fttq"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x, y = make_data(m, r.seeded("data"), dev)
    record = {"on": True, "batches": {}, "uploads": {}, "broadcasts": []}
    clients = _clients(x, y, m, r.seeded("split"), record)
    del x, y
    params = resnet.init_params(m, r.seeded("weights"), dev)
    cfg = sim.FedConfig(algorithm=spec["algorithm"], n_clients=m["clients"],
                        participation=spec["participation"], local_epochs=spec["local_epochs"],
                        batch_size=spec["batch_size"], rounds=ROUNDS,
                        seed=r.seeded("server") % 2 ** 32,
                        fttq=FTTQConfig(t_k=ft["t_k"], server_delta=ft["server_delta"]))
    steps = spec["local_epochs"] * (m["samples_per_client"] // spec["batch_size"])
    n_sel = max(math.ceil(spec["participation"] * m["clients"]), 1)
    timer = _switched_timer(sim, r) if r.trace else None
    per_round = n_sel * steps
    restore = []

    def keep_broadcast(orig):
        def wrapped(*a, **kw):
            blob = orig(*a, **kw)
            if len(record["broadcasts"]) < 2:
                record["broadcasts"].append(blob)
            if "answer_altered" in r.faults and len(record["broadcasts"]) == 2:
                blob = _altered(blob)
                record["broadcasts"][1] = blob
            return blob
        return wrapped

    def unchanged_steps(orig):
        def make(*a, **kw):
            fp_step, qat_step = orig(*a, **kw)

            def fp_same(params, opt_state, xb, yb):
                return params, opt_state, fp_step(params, opt_state, xb, yb)[2]

            def qat_same(params, wq, opt_state, xb, yb):
                return params, wq, opt_state, qat_step(params, wq, opt_state, xb, yb)[3]
            return fp_same, qat_same
        return make

    def keep_upload(orig):
        def wrapped(client, start, cfg_, *a, **kw):
            if "half_batch" in r.faults:
                cfg_ = dataclasses.replace(cfg_, batch_size=cfg_.batch_size // 2)
                client = _Halved(client)
            blob = orig(client, start, cfg_, *a, **kw)
            if record["on"]:
                record["uploads"][client.client_id] = blob
            return blob
        return wrapped

    def half_fold(orig):
        class HalfFold(orig):
            def add(self, blob, weight):
                self.bench_seen = getattr(self, "bench_seen", 0) + 1
                if self.bench_seen % 2:
                    super().add(blob, weight)
        return HalfFold

    restore.append(_patch(sim, "broadcast_blob", keep_broadcast))
    if "half_fold" in r.faults:
        restore.append(_patch(sim, "Aggregator", half_fold))
    if "state_unchanged" in r.faults:
        restore.append(_patch(sim, "_make_local_steps", unchanged_steps))
    restore.append(_patch(sim, "train_client", keep_upload))
    state = {"rounds": 0, "fold": None}

    def round_end(global_params):
        state["rounds"] += 1
        if state["rounds"] == 1:
            record["on"] = False
            state["fold"] = {p: v.detach().clone() for p, v in
                             resnet.flatten(global_params).items()}
            r.begin_window()
        else:
            with r.mark("round_end"):
                r.sync()
            if r.unit_done(per_round * spec["batch_size"]):
                raise _Stop
        return 0.0, 0.0

    try:
        sim.run_federated_sync(resnet_cifar, params, clients, cfg, adam(spec["lr"]), round_end,
                               eval_every=1, device=dev, timer=timer)
    except _Stop:
        pass
    finally:
        for undo in restore:
            undo()
    gc.collect()
    torch.cuda.empty_cache() if r.cuda else None
    checks = _compare(r, m, spec, ft, params, clients, record, state["fold"])
    layer = {"local_steps_per_round": per_round,
             "samples_per_round": per_round * spec["batch_size"],
             "phases": timer.rounds if timer is not None else None}
    rate = r.rate()
    return Outcome(attempted=int(r.total("units")), failed=0,
                   e2e={"fed_samples_per_s": rate} if rate else {}, layer=layer, checks=checks)


class _Halved:
    """A client whose batches are the first half of each batch it draws."""

    def __init__(self, client):
        self._c = client
        self.x, self.y, self.client_id = client.x, client.y, client.client_id

    def __len__(self):
        return len(self._c)

    def index_batches(self, batch_size, rng, epochs=1):
        for sel in self._c.index_batches(batch_size * 2, rng, epochs):
            yield sel[: len(sel) // 2]


def _altered(blob: bytes) -> bytes:
    """The buffer with one bit of its last byte changed and its CRC made
    good."""
    import struct
    import zlib

    out = bytearray(blob)
    out[-1] ^= 0x01
    body = bytes(out[24:])
    struct.pack_into("<I", out, 12, zlib.crc32(body) & 0xFFFFFFFF)
    return bytes(out)


def _compare(r, m, spec, ft, params, clients, record, fold_got) -> list:
    import torch

    from perfbench.reference.compare import worst_norm_gap, worst_share
    from perfbench.reference.olmo import float32_matmuls, tf32_matmuls

    dev, lim = r.device, spec["limits"]
    qat = spec["algorithm"] == "tfedavg"
    ok = {"wire": 1.0, "plan": 1.0}

    def read(blob):
        try:
            return wire.decode(blob)
        except ValueError:
            ok["wire"] = 0.0
            return None

    def broadcast_of(flat):
        if qat:
            return resnet.requantize(flat, t_k=ft["t_k"], delta=ft["server_delta"])
        return {p: ("raw", v) for p, v in flat.items()}

    with float32_matmuls():
        want_b = broadcast_of(resnet.flatten(params))
        start = resnet.dense(want_b)
        bcast = [read(b) for b in record["broadcasts"][:2]]
        b_codes, b_scale = 0, 0.0
        for got, want in ((bcast[0] if bcast else None, want_b),
                          (bcast[1] if len(bcast) > 1 else None,
                           broadcast_of(fold_got) if fold_got is not None else None)):
            if got is None or want is None or set(got) != set(want):
                ok["wire"] = 0.0
                continue
            d, _, s = _ternary_gaps(got, want)
            b_codes += d
            b_scale = max(b_scale, s, _raw_gap(got, want))
        codes = n_codes = 0
        scale = 0.0
        got_change, want_change, diff_change = {}, {}, {}
        ups, weights = [], []
        for k, blob in sorted(record["uploads"].items()):
            c = clients[k]
            drawn = record["batches"].get(k, [])
            ok["plan"] *= float(_plan_ok(drawn, len(c), spec))
            trained, factors = resnet.local_train(
                m, start, torch.from_numpy(c.x).to(dev), torch.from_numpy(c.y).to(dev),
                [torch.from_numpy(b).to(dev) for b in drawn], qat=qat, t_k=ft["t_k"],
                lr=spec["lr"])
            want_u = resnet.upload(trained, factors, ft["t_k"])
            got_u = prog_u = read(blob)
            if prog_u is None or set(prog_u) != set(want_u):
                ok["wire"] = 0.0
                continue
            if r.control:
                with tf32_matmuls():
                    got_u = resnet.upload(*resnet.local_train(
                        m, start, torch.from_numpy(c.x).to(dev), torch.from_numpy(c.y).to(dev),
                        [torch.from_numpy(b).to(dev) for b in drawn], qat=qat, t_k=ft["t_k"],
                        lr=spec["lr"]), ft["t_k"])
            d, n, s = _ternary_gaps(got_u, want_u)
            codes, n_codes, scale = codes + d, n_codes + n, max(scale, s)
            for p, rec in want_u.items():
                if rec[0] == "raw":
                    key = f"{k}:{p}"
                    got_d = got_u[p][1].to(dev).double() - start[p]
                    want_d = rec[1].double() - start[p]
                    got_change[key] = float(got_d.norm())
                    want_change[key] = float(want_d.norm())
                    diff_change[key] = float((got_d - want_d).norm())
            ups.append(prog_u)
            weights.append(len(c))
        fold_gap = 1.0
        if ups and fold_got is not None:
            want_f = resnet.fold(ups, weights)
            fold_gap = max(float((fold_got[p].double().cpu() - want_f[p].double().cpu())
                                 .abs().max()) / max(float(want_f[p].abs().max()), 1e-30)
                           for p in want_f)
    change_gap, worst = worst_norm_gap(got_change, want_change) if want_change else (1.0, "")
    change_diff = worst_share(diff_change, want_change)[0] if want_change else 1.0
    print(f"read upload_change_norm_gap worst leaf {worst} (reference change "
          f"{want_change.get(worst, 0.0)!r}, median "
          f"{statistics.median(want_change.values()) if want_change else 0.0!r})",
          file=sys.stderr)
    checks = [Check("broadcast_codes_differ", float(b_codes), 0.0),
              Check("broadcast_scale_gap", b_scale, lim["broadcast_scale_gap"])]
    if qat:
        # the upload's codes are read, not compared: a client starts from the
        # ternary broadcast and its 10 Adam steps move no weight across Δ, so
        # they equal the broadcast's on sound runs, the control and every fault
        print(f"read upload_codes_differ_share {codes / max(n_codes, 1)!r}", file=sys.stderr)
        checks.append(Check("upload_scale_gap", scale, lim["upload_scale_gap"]))
    checks += [Check("upload_change_norm_gap", change_gap, lim["upload_change_norm_gap"]),
               Check("upload_change_diff", change_diff, lim["upload_change_diff"]),
               Check("fold_gap", fold_gap, lim["fold_gap"]),
               Check("wire_unreadable", 1.0 - ok["wire"], 0.0),
               Check("batch_plan_wrong", 1.0 - ok["plan"], 0.0)]
    return checks


def _ternary_gaps(got: dict, want: dict) -> tuple[int, int, float]:
    """(codes that differ, codes compared, worst relative scale gap) over
    the ternary leaves of two payloads (a leaf shipped in another kind
    counts all its codes as differing)."""
    import torch

    diff = n = 0
    gap = 0.0
    for p, w in want.items():
        if w[0] != "ternary":
            continue
        g = got[p]
        n += w[1].numel()
        if g[0] != "ternary":
            diff += w[1].numel()
            continue
        diff += int((g[1].to(torch.int8).cpu() != w[1].to(torch.int8).cpu()).sum())
        gs, ws = g[2].double().cpu(), w[2].double().cpu()
        gap = max(gap, float(((gs - ws).abs() / ws.abs().clamp_min(1e-30)).max()))
    return diff, n, gap


def _raw_gap(got: dict, want: dict) -> float:
    """The worst full-precision leaf's ‖got − want‖ / ‖want‖."""
    gap = 0.0
    for p, w in want.items():
        if w[0] == "raw":
            if got[p][0] != "raw":
                return 1.0
            gv, wv = got[p][1].double().cpu(), w[1].double().cpu()
            gap = max(gap, float((gv - wv).norm() / wv.norm().clamp_min(1e-30)))
    return gap


def _plan_ok(drawn: list, n: int, spec: dict) -> bool:
    """Whether a client drew E epochs of ⌊n / B⌋ batches of B samples, each
    sample at most once an epoch."""
    per = n // spec["batch_size"]
    if len(drawn) != spec["local_epochs"] * per:
        return False
    for e in range(spec["local_epochs"]):
        seen = set()
        for b in drawn[e * per:(e + 1) * per]:
            if len(b) != spec["batch_size"] or seen & set(b.tolist()):
                return False
            seen |= set(b.tolist())
    return True
