"""Process-wide event counters, histograms, the Prometheus exposition and
the cluster log — the port's copy of greengage_tpu/runtime/logger.py.

The binder and planner count what they decide (scalar lowering, memo use,
plan shapes) through ``counters.inc``; gauges (levels: live connections,
device bytes, the brownout state) are written with ``counters.set``, which
tags the name so the exposition types it ``gauge``. The session, the
executor and the batch server observe latencies, widths and executable
footprints through ``histograms.observe``. ``prometheus_text`` renders all
of it for the SQL server's ``metrics`` op (runtime/server.py).

``ClusterLog`` is the CSV server log (the syslogger's csvlog): one file per
day under ``<root>/log/``, one record per event, appends line-atomic under
a lock; it never raises into the caller. The port's in-memory Database
keeps it in its scratch directory. The JAX package's log mining
(``read_entries``, ``filter_entries``, ``gg logfilter``) comes with the
CLI (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import bisect
import csv
import datetime
import io
import os
import re
import threading

# names that are levels, not monotone counts, however they were first
# written: the exposition types them ``gauge`` even in a process that has
# not set them yet
GAUGE_NAMES = (
    # measured memory accounting (runtime/memaccount.py): the card's
    # allocator watermarks (never written on the CPU), the signed
    # estimate-vs-measured executable error, per-owner live host bytes,
    # and the host process gauges the metrics op refreshes
    "device_bytes_in_use", "device_peak_bytes_in_use", "mem_est_error_pct",
    "mem_owner_bytes_staging", "mem_owner_bytes_blockcache",
    "mem_owner_bytes_spill", "mem_owner_bytes_device",
    "host_rss_bytes", "host_open_fds", "staging_pool_queue_depth",
    # batched serving (exec/batchserve.py): members waiting in open windows
    "batch_queue_depth",
    # overload protection (runtime/server.py, runtime/overload.py): live
    # client connections, and the brownout state (1 engaged, 0 clear)
    "server_active_connections", "brownout",
    # tiered spill workfile (exec/workfile.py): bytes held in each tier
    "spill_tier_ram_bytes", "spill_tier_disk_bytes",
)


class Counters:
    """Monotonic event counters (the pg_stat counter surface). Names
    written through ``set()`` are tagged as gauges."""

    def __init__(self):
        self._lock = threading.Lock()
        self._c: dict[str, int] = {}
        self._gauges: set[str] = set(GAUGE_NAMES)

    def inc(self, name: str, n: int = 1) -> int:
        with self._lock:
            self._c[name] = self._c.get(name, 0) + n
            return self._c[name]

    def get(self, name: str) -> int:
        with self._lock:
            return self._c.get(name, 0)

    def set(self, name: str, value: int) -> int:
        """A gauge: the current value, not a count."""
        with self._lock:
            self._c[name] = int(value)
            self._gauges.add(name)
            return self._c[name]

    def gauges(self) -> set[str]:
        """Names holding gauge (level) semantics; everything else in
        ``snapshot()`` is a monotone counter."""
        with self._lock:
            return set(self._gauges)

    def kind(self, name: str) -> str:
        with self._lock:
            return "gauge" if name in self._gauges else "counter"

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

# byte-sized histograms (executable memory footprints) bucket in MB
DEFAULT_BUCKETS_MB = (1.0, 4.0, 16.0, 64.0, 256.0, 1024.0, 4096.0,
                      16384.0)


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


_METRIC_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _metric_name(name: str, prefix: str) -> str:
    s = _METRIC_NAME_RE.sub("_", name)
    if s and s[0].isdigit():
        s = "_" + s
    return prefix + s


def _fmt_float(v: float) -> str:
    return repr(round(float(v), 6))


def prometheus_text(prefix: str = "ggtpu_") -> str:
    """Prometheus text exposition (format 0.0.4) over the process-wide
    counters, gauges and histograms: the server's ``metrics`` op payload.
    Counter vs gauge typing comes from the gauge tags."""
    lines: list[str] = []
    snap = counters.snapshot()
    gauges = counters.gauges()
    for name in sorted(snap):
        mn = _metric_name(name, prefix)
        lines.append(f"# TYPE {mn} {'gauge' if name in gauges else 'counter'}")
        lines.append(f"{mn} {snap[name]}")
    hsnap = histograms.snapshot()
    counter_names = {_metric_name(n, prefix) for n in snap}
    for name in sorted(hsnap):
        h = hsnap[name]
        mn = _metric_name(name, prefix)
        if mn in counter_names:
            # one exposition name cannot carry two TYPEs: a histogram
            # colliding with a counter or gauge exports suffixed
            mn += "_hist"
        lines.append(f"# TYPE {mn} histogram")
        cum = 0
        for b, c in zip(h["buckets"], h["counts"]):
            cum += c
            lines.append(f'{mn}_bucket{{le="{b:g}"}} {cum}')
        lines.append(f'{mn}_bucket{{le="+Inf"}} {h["count"]}')
        lines.append(f"{mn}_sum {_fmt_float(h['sum'])}")
        lines.append(f"{mn}_count {h['count']}")
    return "\n".join(lines) + "\n"


class ClusterLog:
    """The CSV server log: ``timestamp, severity, pid, thread, kind,
    duration_ms, rows, message``, one file per UTC day under
    ``<root>/log/``."""

    def __init__(self, root: str, enabled: bool = True):
        self.dir = os.path.join(root, "log")
        self.enabled = enabled
        self._lock = threading.Lock()
        self._fh = None            # open append handle for _fh_day
        self._fh_day: datetime.date | None = None

    def _path(self, day: datetime.date | None = None) -> str:
        day = day or datetime.datetime.now(datetime.timezone.utc).date()
        return os.path.join(self.dir, f"ggtpu-{day.isoformat()}.csv")

    def _handle(self):
        """Open (or roll to today's) append handle; called under _lock."""
        day = datetime.datetime.now(datetime.timezone.utc).date()
        if self._fh is None or self._fh_day != day:
            if self._fh is not None:
                self._fh.close()
            os.makedirs(self.dir, exist_ok=True)
            self._fh = open(self._path(day), "a")
            self._fh_day = day
        return self._fh

    def log(self, severity: str, kind: str, message: str,
            duration_ms: float | None = None, rows: int | None = None) -> None:
        if not self.enabled:
            return
        ts = datetime.datetime.now(datetime.timezone.utc).isoformat(
            timespec="milliseconds").replace("+00:00", "Z")
        buf = io.StringIO()
        csv.writer(buf).writerow([
            ts, severity, os.getpid(), threading.current_thread().name,
            kind, "" if duration_ms is None else f"{duration_ms:.2f}",
            "" if rows is None else rows,
            message.replace("\n", " ")[:500],
        ])
        try:
            with self._lock:
                fh = self._handle()
                fh.write(buf.getvalue())
                fh.flush()
        except OSError:
            pass   # logging must never fail the statement

    def info(self, kind: str, message: str, **kw) -> None:
        self.log("INFO", kind, message, **kw)

    def error(self, kind: str, message: str, **kw) -> None:
        self.log("ERROR", kind, message, **kw)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
