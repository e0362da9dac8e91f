"""Reduce a ``torch.profiler`` window to what the per-layer readers and the
result line take: the device's busy seconds (the union of its kernel,
copy and fill intervals), device seconds and launches by kernel name, the
ten device operations that took most time and the ten longest idle gaps,
each named by what the host was doing then."""

from __future__ import annotations

import collections


def kernel_name(name: str) -> str:
    """A device kernel's name without namespace, template and arguments."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0].split("<")[0].strip()


def _raw_events(prof):
    """(is_device, name, start_s, end_s) of every event of the session."""
    from torch.autograd import DeviceType

    results = prof.profiler.kineto_results
    for e in results.events():
        dt = e.device_type()
        if hasattr(e, "start_ns"):
            start, dur = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        else:
            start, dur = e.start_us() * 1e-6, e.duration_us() * 1e-6
        yield dt == DeviceType.CUDA, e.name(), start, start + dur


def _union(intervals: list) -> list:
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def reduce(prof, window_s: float) -> dict:
    device, host = [], []
    for is_dev, name, s, e in _raw_events(prof):
        (device if is_dev else host).append((s, e, name))
    # a host range (``record_function``) also shows on the device's timeline
    # as an annotation spanning its kernels, under the range's own name
    ranges = {name for _, _, name in host}
    device = sorted(x for x in device if x[2] not in ranges)
    if device and "FillFunctor" in device[0][2]:
        device = device[1:]          # the opening fill of ``Run.begin_window``
    merged = _union([(s, e) for s, e, _ in device])
    busy = sum(e - s for s, e in merged)
    kernels: dict = collections.defaultdict(lambda: [0.0, 0])
    for s, e, name in device:
        k = kernels[kernel_name(name)]
        k[0] += e - s
        k[1] += 1
    top = sorted(kernels.items(), key=lambda kv: kv[1][0], reverse=True)[:10]
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(merged, merged[1:])),
                  reverse=True)[:10]
    return {"busy_s": busy, "window_s": window_s,
            "kernels": {k: v for k, v in kernels.items()},
            "device_ops": [[k, v[0]] for k, v in top],
            "idle_gaps": [[_host_doing(host, (s + e) / 2), g] for g, s, e in gaps]}


def _host_doing(host: list, t: float) -> str:
    """The host's ops open at time ``t``: the outermost benchmark span and
    the innermost op, as "inner < outer"."""
    open_ = [(e - s, name) for s, e, name in host if s <= t <= e]
    if not open_:
        return "host idle"
    inner = min(open_)[1]
    spans = [x for x in open_ if x[1].startswith("bench.")]
    outer = max(spans)[1] if spans else max(open_)[1]
    return inner if inner == outer else f"{inner} < {outer}"
