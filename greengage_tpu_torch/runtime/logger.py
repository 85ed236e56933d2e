"""Process-wide event counters and histograms — the part of
greengage_tpu/runtime/logger.py the port reads.

The binder and planner count what they decide (scalar lowering, memo use,
plan shapes) through ``counters.inc``; the session and the batch server
observe latencies and widths through ``histograms.observe`` (the
``statement_ms``, ``queue_wait_ms`` and ``batch_width`` histograms). The
JAX package's cluster CSV log and Prometheus exposition come with its SQL
server (ROADMAP Queue 1).
"""

from __future__ import annotations

import bisect
import threading


class Counters:
    """Monotonic event counters (the pg_stat counter surface)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._c: dict[str, int] = {}

    def inc(self, name: str, n: int = 1) -> int:
        with self._lock:
            self._c[name] = self._c.get(name, 0) + n
            return self._c[name]

    def get(self, name: str) -> int:
        with self._lock:
            return self._c.get(name, 0)

    def set(self, name: str, value: int) -> None:
        """A gauge: the current value, not a count."""
        with self._lock:
            self._c[name] = int(value)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._c)

    def since(self, base: dict, prefix: str = "") -> dict:
        """Counter deltas since ``snapshot()`` (names starting with
        ``prefix``): what one statement or test moved, whatever other
        work in the process moved before."""
        with self._lock:
            cur = dict(self._c)
        return {k: v - base.get(k, 0) for k, v in cur.items()
                if k.startswith(prefix) and v != base.get(k, 0)}


counters = Counters()


# fixed latency buckets (ms): wide enough for a cold statement, fine enough
# for a warm cached one — fixed so two processes' histograms aggregate
# bucket by bucket
DEFAULT_BUCKETS_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0)


class Histograms:
    """Fixed-bucket histograms (the pg_stat_statements timing role):
    statement latency, queue waits, batch widths. ``observe`` is
    O(log buckets) under one lock — safe for every statement. A name's
    buckets are the ones its first ``observe`` passed."""

    def __init__(self):
        self._lock = threading.Lock()
        # name -> [buckets tuple, per-bucket counts, overflow, sum, count]
        self._h: dict[str, list] = {}

    def observe(self, name: str, value: float,
                buckets: tuple = DEFAULT_BUCKETS_MS) -> None:
        v = float(value)
        with self._lock:
            h = self._h.get(name)
            if h is None:
                h = self._h[name] = [tuple(buckets),
                                     [0] * len(buckets), 0, 0.0, 0]
            i = bisect.bisect_left(h[0], v)
            if i < len(h[0]):
                h[1][i] += 1
            else:
                h[2] += 1
            h[3] += v
            h[4] += 1

    def snapshot(self) -> dict:
        """name -> {"buckets": [...], "counts": [...per bucket...],
        "overflow": n past the last bucket, "sum": total, "count": n};
        counts are per bucket (NOT cumulative)."""
        with self._lock:
            return {name: {"buckets": list(h[0]), "counts": list(h[1]),
                           "overflow": h[2], "sum": h[3], "count": h[4]}
                    for name, h in self._h.items()}

    def reset(self) -> None:
        with self._lock:
            self._h.clear()


histograms = Histograms()   # shared registry, same lifetime as `counters`
