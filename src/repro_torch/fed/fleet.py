"""The event queue of the buffered-asynchronous server (port of
``repro.fed.fleet``, ``EventHeap`` only).

``EventHeap`` is an array-backed binary min-heap keyed by (time, seq): keys
live in two numpy arrays (float64 time, int64 seq) and payloads in a slot
list indexed by a third, so a million pending arrivals cost three arrays
and one list instead of a tuple object each. ``seq`` is assigned
internally in push order, so every key is unique and pops come out in
EXACTLY the order ``heapq`` gives on (time, seq) tuples: arrivals that tie
on time pop in push order.

The vectorized cohort simulation of the reference module (``run_fleet``,
``FleetConfig``) arrives with the fleet slice, together with the batched
channel draws it needs.
"""

from __future__ import annotations

from typing import Any

import numpy as np


class EventHeap:
    """Array-backed binary min-heap keyed by (time, seq)."""

    def __init__(self, capacity: int = 1024):
        cap = max(int(capacity), 1)
        self._time = np.empty(cap, dtype=np.float64)
        self._seq = np.empty(cap, dtype=np.int64)
        self._slot = np.empty(cap, dtype=np.int64)
        self._n = 0
        self._payload: list[Any] = []
        self._free: list[int] = []
        self._next_seq = 0

    def __len__(self) -> int:
        return self._n

    # -- internals ---------------------------------------------------------

    def _grow(self, need: int) -> None:
        cap = self._time.size
        if need <= cap:
            return
        new = max(need, 2 * cap)
        for name in ("_time", "_seq", "_slot"):
            arr = getattr(self, name)
            grown = np.empty(new, dtype=arr.dtype)
            grown[: self._n] = arr[: self._n]
            setattr(self, name, grown)

    def _less(self, i: int, j: int) -> bool:
        if self._time[i] != self._time[j]:
            return bool(self._time[i] < self._time[j])
        return bool(self._seq[i] < self._seq[j])

    def _swap(self, i: int, j: int) -> None:
        for arr in (self._time, self._seq, self._slot):
            arr[i], arr[j] = arr[j], arr[i]

    def _sift_up(self, i: int) -> None:
        while i > 0:
            parent = (i - 1) // 2
            if not self._less(i, parent):
                break
            self._swap(i, parent)
            i = parent

    def _sift_down(self, i: int) -> None:
        n = self._n
        while True:
            left = 2 * i + 1
            if left >= n:
                return
            child = left
            right = left + 1
            if right < n and self._less(right, left):
                child = right
            if not self._less(child, i):
                return
            self._swap(i, child)
            i = child

    def _store(self, payload: Any) -> int:
        if self._free:
            slot = self._free.pop()
            self._payload[slot] = payload
        else:
            slot = len(self._payload)
            self._payload.append(payload)
        return slot

    # -- api ---------------------------------------------------------------

    def push(self, t: float, payload: Any) -> int:
        """Insert one event; returns its (unique, monotonic) seq."""
        self._grow(self._n + 1)
        seq = self._next_seq
        self._next_seq += 1
        i = self._n
        self._time[i] = t
        self._seq[i] = seq
        self._slot[i] = self._store(payload)
        self._n += 1
        self._sift_up(i)
        return seq

    def push_many(self, times: np.ndarray, payloads: list[Any]) -> None:
        """Bulk insert: append the batch, then restore the heap with one
        lexsort on (time, seq) — a sorted array is a valid binary
        min-heap."""
        ts = np.asarray(times, dtype=np.float64)
        k = ts.size
        if k != len(payloads):
            raise ValueError(f"{k} times for {len(payloads)} payloads")
        if k == 0:
            return
        self._grow(self._n + k)
        n = self._n
        self._time[n:n + k] = ts
        self._seq[n:n + k] = np.arange(self._next_seq, self._next_seq + k, dtype=np.int64)
        self._next_seq += k
        self._slot[n:n + k] = [self._store(p) for p in payloads]
        self._n = n + k
        order = np.lexsort((self._seq[: self._n], self._time[: self._n]))
        for arr in (self._time, self._seq, self._slot):
            arr[: self._n] = arr[order]

    def peek_time(self) -> float:
        if self._n == 0:
            raise IndexError("peek on empty EventHeap")
        return float(self._time[0])

    def pop(self) -> tuple[float, int, Any]:
        """Remove and return the earliest event as (time, seq, payload)."""
        if self._n == 0:
            raise IndexError("pop from empty EventHeap")
        t = float(self._time[0])
        seq = int(self._seq[0])
        slot = int(self._slot[0])
        payload = self._payload[slot]
        self._payload[slot] = None
        self._free.append(slot)
        self._n -= 1
        if self._n:
            last = self._n
            for arr in (self._time, self._seq, self._slot):
                arr[0] = arr[last]
            self._sift_down(0)
        return t, seq, payload
