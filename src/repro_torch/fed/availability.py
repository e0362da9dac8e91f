"""Client availability traces — who is reachable at simulated time t.

Copy of ``repro.fed.availability`` (pure numpy): the same seeds give the
same masks, ``next_change`` values and participant draws.

Real federated fleets are not always-on: phones charge at night, desktops
sleep, links drop. Both servers used to assume the full population was
reachable at every draw (uniform resampling); this module makes the
reachable set an explicit, deterministic function of simulated time so the
same seed always replays the same fleet churn.

Three trace models behind one tiny protocol:

  - ``AlwaysOn``      — the pre-scenario behavior: everyone, always. The
                        participant draw consumes the SAME rng stream as
                        before, so existing runs reproduce bit-exactly.
  - ``DiurnalChurn``  — sinusoidal timezone cohorts. Client k belongs to
                        cohort k mod n_cohorts; cohort c's availability
                        level at time t is
                            p_c(t) = floor + (1-floor)·(1+sin(2πt/T + φ_c))/2
                        and client k is online iff its fixed propensity
                        draw u_k ≤ p_c(t). Clients with low u_k are nearly
                        always on; high-u_k clients appear only near the
                        cohort's peak — smooth, deterministic diurnal churn
                        with no per-query randomness.
  - ``TraceReplay``   — explicit per-client (on, off) interval schedules,
                        either handed in directly (a recorded trace) or
                        generated once from seeded exponential on/off
                        durations. Membership is one vectorized pass over
                        the flattened boundary array, so replays are
                        deterministic and cheap even for 10⁶ clients.

``AvailabilityConfig`` is the serializable knob surface
(``FedConfig.availability``); ``make_availability`` builds the model for a
fleet. Servers query ``available_mask(t)`` for the participant draw and
``next_change(t)`` when nobody is reachable and simulated time must
advance to the next arrival/departure.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class ClientAvailability(Protocol):
    """Deterministic map from simulated time to the reachable client set."""

    def available_mask(self, t: float) -> np.ndarray:
        """Boolean (n_clients,) mask: True = reachable at time ``t``."""
        ...

    def next_change(self, t: float) -> float:
        """Earliest time > ``t`` at which the mask may differ (inf = never).
        Used by the async server to advance time when nobody is online."""
        ...


@dataclasses.dataclass(frozen=True)
class AvailabilityConfig:
    """Serializable scenario knobs (``FedConfig.availability``).

    Attributes:
      kind: "always_on" | "diurnal" | "trace".
      period_s: diurnal cycle length in SIMULATED seconds (a "day").
      floor: minimum availability level of a cohort at its trough, in
        [0, 1] (0.1 → at least ~10% of each cohort stays reachable).
      n_cohorts: number of timezone cohorts spread evenly around the cycle.
      mean_on_s / mean_off_s: trace-replay exponential session/gap means.
      horizon_s: trace-replay schedule length; the schedule tiles
        periodically past it so long runs never fall off the trace.
      seed_offset: folded into the fleet seed so availability draws are
        decorrelated from link/participation draws.
    """

    kind: str = "always_on"
    period_s: float = 400.0
    floor: float = 0.1
    n_cohorts: int = 4
    mean_on_s: float = 120.0
    mean_off_s: float = 60.0
    horizon_s: float = 4000.0
    seed_offset: int = 7919


class AlwaysOn:
    """Everyone reachable at every instant (the pre-scenario fleet)."""

    def __init__(self, n_clients: int):
        self._mask = np.ones(n_clients, dtype=bool)

    def available_mask(self, t: float) -> np.ndarray:
        return self._mask

    def next_change(self, t: float) -> float:
        return float("inf")


class DiurnalChurn:
    """Sinusoidal timezone-cohort availability (see module docstring)."""

    def __init__(self, n_clients: int, *, period_s: float = 400.0,
                 floor: float = 0.1, n_cohorts: int = 4, seed: int = 0):
        if not 0.0 <= floor <= 1.0:
            raise ValueError(f"floor must be in [0, 1], got {floor}")
        if period_s <= 0:
            raise ValueError(f"period_s must be > 0, got {period_s}")
        self.period_s = float(period_s)
        self.floor = float(floor)
        self.n_cohorts = max(1, int(n_cohorts))
        rng = np.random.default_rng(seed)
        # fixed per-client propensity: the one random draw, made once.
        self._u = rng.uniform(0.0, 1.0, size=n_clients)
        self._cohort = np.arange(n_clients) % self.n_cohorts
        self._phase = 2.0 * np.pi * self._cohort / self.n_cohorts
        # u=1 would never come online even at a full-amplitude peak; nudge
        # every propensity strictly below 1 so peaks reach the whole cohort.
        self._u = np.minimum(self._u, 1.0 - 1e-9)

    def _level(self, t: float) -> np.ndarray:
        s = np.sin(2.0 * np.pi * t / self.period_s + self._phase)
        return self.floor + (1.0 - self.floor) * 0.5 * (1.0 + s)

    def available_mask(self, t: float) -> np.ndarray:
        return self._u <= self._level(t)

    def next_change(self, t: float) -> float:
        # the mask changes continuously; a quarter-period step bounds the
        # wait without simulating the exact crossing times.
        return t + self.period_s / 4.0

    def expected_online(self, t: float) -> float:
        """Mean availability level across the fleet (telemetry)."""
        return float(self._level(t).mean())


class TraceReplay:
    """Deterministic per-client on/off interval schedules.

    ``schedules[k]`` is an ascending array of boundary times
    ``[on_0, off_0, on_1, off_1, ...]``: client k is online in
    [on_i, off_i). Schedules tile periodically past ``horizon_s`` so the
    trace never runs out.
    """

    def __init__(self, schedules: list[np.ndarray], horizon_s: float):
        if horizon_s <= 0:
            raise ValueError(f"horizon_s must be > 0, got {horizon_s}")
        self.horizon_s = float(horizon_s)
        self.schedules = [np.asarray(s, dtype=np.float64) for s in schedules]
        for k, s in enumerate(self.schedules):
            if s.ndim != 1 or (s.size and np.any(np.diff(s) < 0)):
                raise ValueError(f"schedule {k} is not an ascending 1-D array")
        # flattened bounds + per-client segment offsets: mask queries are
        # ONE vectorized pass over all boundaries instead of a Python loop
        # of per-client searchsorteds (the fleet-scale requirement).
        lens = np.array([s.size for s in self.schedules], dtype=np.int64)
        self._seg_end = np.cumsum(lens)
        self._seg_start = self._seg_end - lens
        self._flat = (np.concatenate(self.schedules) if self.schedules
                      else np.empty(0, dtype=np.float64))

    @classmethod
    def generate(cls, n_clients: int, *, mean_on_s: float = 120.0,
                 mean_off_s: float = 60.0, horizon_s: float = 4000.0,
                 seed: int = 0) -> "TraceReplay":
        """Seeded exponential on/off sessions, drawn once at construction."""
        rng = np.random.default_rng(seed)
        schedules = []
        for _ in range(n_clients):
            # random initial phase: start mid-gap or mid-session.
            bounds = [-float(rng.exponential(mean_off_s))]
            on = True
            while bounds[-1] < horizon_s:
                dur = mean_on_s if on else mean_off_s
                bounds.append(bounds[-1] + float(rng.exponential(dur)))
                on = not on
            # boundary list starts with an ON edge (possibly before t=0)
            schedules.append(np.asarray(bounds, dtype=np.float64))
        return cls(schedules, horizon_s)

    def _fold(self, t: float) -> float:
        return float(t % self.horizon_s)

    def available_mask(self, t: float) -> np.ndarray:
        tf = self._fold(t)
        # schedules start with an ON edge, so an ODD number of passed
        # boundaries means the client is inside an ON span. Counting the
        # passed boundaries per client via a cumulative sum over the
        # flattened bounds is bit-identical to a per-client searchsorted
        # (side="right" counts elements ≤ tf, exactly what ``<=`` counts).
        passed = np.concatenate([[0], np.cumsum(self._flat <= tf)])
        counts = passed[self._seg_end] - passed[self._seg_start]
        return (counts % 2) == 1

    def next_change(self, t: float) -> float:
        tf = self._fold(t)
        # the schedule tiles at horizon_s, so the wrap itself is a change
        # point (folded time jumps back to 0 and the mask re-evaluates).
        best = self.horizon_s - tf
        # each client's candidate is its first boundary > tf (ascending),
        # so the global candidate is just the min boundary in (tf, horizon).
        m = (self._flat > tf) & (self._flat < self.horizon_s)
        if m.any():
            best = min(best, float(self._flat[m].min() - tf))
        return t + max(best, 1e-9)


def make_availability(cfg: AvailabilityConfig, n_clients: int,
                      seed: int = 0) -> ClientAvailability:
    """Build the availability model for one fleet (seeded, deterministic)."""
    if cfg.kind == "always_on":
        return AlwaysOn(n_clients)
    if cfg.kind == "diurnal":
        return DiurnalChurn(
            n_clients, period_s=cfg.period_s, floor=cfg.floor,
            n_cohorts=cfg.n_cohorts, seed=seed + cfg.seed_offset,
        )
    if cfg.kind == "trace":
        return TraceReplay.generate(
            n_clients, mean_on_s=cfg.mean_on_s, mean_off_s=cfg.mean_off_s,
            horizon_s=cfg.horizon_s, seed=seed + cfg.seed_offset,
        )
    raise ValueError(f"unknown availability kind {cfg.kind!r}")


def draw_participants(avail: ClientAvailability, t: float, n: int,
                      n_clients: int, rng: np.random.Generator) -> np.ndarray:
    """Sample ≤ ``n`` distinct ONLINE clients at time ``t``.

    With every client online this consumes the rng stream EXACTLY like the
    historical uniform draw (``rng.choice(n_clients, n, replace=False)``),
    so ``AlwaysOn`` scenarios reproduce pre-scenario runs bit-for-bit.
    Under churn, the draw is uniform over the online subset (and shrinks
    to its size when fewer than ``n`` are reachable).
    """
    mask = avail.available_mask(t)
    if mask.all():
        return rng.choice(n_clients, size=min(n, n_clients), replace=False)
    online = np.flatnonzero(mask)
    if online.size == 0:
        return online
    take = min(n, online.size)
    return online[rng.choice(online.size, size=take, replace=False)]


def draw_one(avail: ClientAvailability, t: float, n_clients: int,
             rng: np.random.Generator) -> int:
    """Sample one online client (the async refill draw); -1 if none.

    Bit-compatibility contract as ``draw_participants``: all-online
    consumes ``rng.integers(n_clients)`` exactly like the historical path.
    """
    mask = avail.available_mask(t)
    if mask.all():
        return int(rng.integers(n_clients))
    online = np.flatnonzero(mask)
    if online.size == 0:
        return -1
    return int(online[rng.integers(online.size)])
