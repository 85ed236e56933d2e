"""Host staging: the read pool, in-place staging buffers and the spill-pass
prefetcher — the port's counterpart of greengage_tpu/exec/staging.py.

  - ``pool(settings)``: the read pool every (table, segment) unit of a
    statement's staging runs on. ``scan_threads`` sizes it (0 = auto);
    numpy's copies release the GIL, so the units overlap. Where the JAX
    package keeps one process-wide pool, the port's pool lives for one
    staging call (a context manager that joins its threads), so no thread
    outlives the statement that started it. ``pool_queue_depth`` sums the
    read units waiting in every live pool (the metrics op's gauge).
  - ``fill_buffer``: one ``[nseg * cap]`` staging buffer per column, each
    segment's rows written into it in place and only the unfilled tails
    padded. ``host_buffer`` gives the buffer as a pinned tensor when the
    device is a card, so its copy to the card runs ``non_blocking``.
  - ``PassPrefetcher``: while spill pass k runs on the device, a
    background thread builds pass k+1's pinned host buffers (the JAX
    package warms its block cache there; the port's store is in memory,
    so the host work a pass can overlap is reading and assembling its
    rows). The thread touches no device memory: the statement's thread
    makes every copy to the card, on its own stream, after ``take``
    joins the thread.
"""

from __future__ import annotations

import os
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


def scan_thread_count(settings) -> int:
    n = int(getattr(settings, "scan_threads", 0) or 0)
    if n <= 0:
        n = min(8, os.cpu_count() or 1)
    return max(n, 1)


class _InlineFuture:
    __slots__ = ("_value", "_err")

    def __init__(self, fn, args):
        try:
            self._value, self._err = fn(*args), None
        except BaseException as e:   # re-raised at result(), like a Future
            self._value, self._err = None, e

    def result(self):
        if self._err is not None:
            raise self._err
        return self._value


class _InlinePool:
    """scan_threads = 1: run units eagerly on the calling thread. After a
    unit fails (a cancelled statement, a read error) the later units do
    not run: their futures raise the first failure."""

    def __init__(self):
        self._failed: _InlineFuture | None = None

    def submit(self, fn, *args):
        if self._failed is not None:
            return self._failed
        f = _InlineFuture(fn, args)
        if f._err is not None:
            self._failed = f
        return f

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _StagePool:
    """A thread pool for one staging call: ``close`` (or leaving the
    ``with`` block) waits for every unit and joins the threads."""

    def __init__(self, n: int):
        self._ex = ThreadPoolExecutor(max_workers=n,
                                      thread_name_prefix="gg-stage")
        with _pools_mu:
            _pools.add(self)

    def submit(self, fn, *args):
        return self._ex.submit(fn, *args)

    def close(self) -> None:
        self._ex.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# the staging calls' live pools, for pool_queue_depth
_pools_mu = threading.Lock()
_pools: weakref.WeakSet = weakref.WeakSet()


def pool(settings):
    """The read pool for one staging call, as a context manager."""
    n = scan_thread_count(settings)
    return _InlinePool() if n <= 1 else _StagePool(n)


def pool_queue_depth() -> int:
    """Read units waiting for a staging-pool thread right now, over every
    live staging call (a persistent backlog means ``scan_threads`` is
    undersized for the workload)."""
    with _pools_mu:
        pools = list(_pools)
    depth = 0
    for p in pools:
        try:
            depth += p._ex._work_queue.qsize()
        except (AttributeError, NotImplementedError):
            pass
    return depth


def host_buffer(n: int, dtype, device) -> torch.Tensor:
    """An uninitialised host tensor of ``n`` values, in pinned memory when
    ``device`` is a card: its copy there is ``non_blocking`` and needs no
    staging copy of its own. Fill it through ``.numpy()``."""
    tdt = torch.from_numpy(np.empty(0, dtype)).dtype
    return torch.empty(n, dtype=tdt,
                       pin_memory=torch.device(device).type == "cuda")


def fill_buffer(nseg: int, cap: int, dtype, parts, fill=0,
                out: np.ndarray | None = None) -> np.ndarray:
    """One staging buffer for one column: ``parts`` yields (seg, array)
    with len(array) <= cap; every other position holds ``fill``. When a
    single segment's array already IS the full buffer (nseg == 1,
    len == cap, right dtype) it stages as-is. ``out`` (a ``[nseg * cap]``
    array of ``dtype``, a pinned buffer's view for a card) is filled in
    place."""
    parts = list(parts)
    if out is None and nseg == 1 and len(parts) == 1:
        arr = parts[0][1]
        if len(arr) == cap and arr.dtype == dtype:
            return np.ascontiguousarray(arr)
    # only the unfilled tails are padded: the data slices are about to be
    # overwritten, so a full-buffer memset would touch every byte twice
    if out is None:
        out = np.empty(nseg * cap, dtype=dtype)
    filled = {}
    for seg, arr in parts:
        n = len(arr)
        if n:
            out[seg * cap: seg * cap + n] = arr
        filled[seg] = max(filled.get(seg, 0), n)
    for seg in range(nseg):
        n = filled.get(seg, 0)
        if n < cap:
            out[seg * cap + n: (seg + 1) * cap] = fill
    return out


class PassPrefetcher:
    """Build the next spill pass's pinned host buffers while the current
    pass runs. The spill loop names the next pass's row ranges
    (``next_ranges``) before it runs a pass; the executor's staging
    ``take``s this pass's buffers (joining the thread), then ``kick``s the
    thread for the next pass, and the device program runs while it works.
    A failed prefetch is only lost work: errors are dropped, ``close``
    joins."""

    def __init__(self, executor, plan, snapshot, caps: dict):
        self.executor = executor
        self.snapshot = snapshot
        shapes = executor.table_shapes(plan, snapshot, caps)
        # (table, staged column names, staged capacity) of every chunked
        # base table
        self.units = [(t, cols, shapes[t].capacity) for t, cols in
                      executor.staged_columns(plan, snapshot).items()
                      if t in caps and not t.startswith("@")]
        self.enabled = bool(self.units)
        self.next_ranges: dict | None = None
        self._thread: threading.Thread | None = None
        self._ready: dict = {}         # (table, range) -> host buffers
        self._mu = threading.Lock()

    def _warm(self, ranges: dict) -> None:
        for table, cols, cap in self.units:
            rng = ranges.get(table)
            if rng is None:
                continue
            try:
                bufs = self.executor.host_buffers(table, cols, cap,
                                                  self.snapshot, rng)
            except Exception:
                return   # a failed prefetch is only a lost warm-up
            with self._mu:
                self._ready[(table, tuple(rng))] = bufs

    def kick(self) -> None:
        """Start building the buffers of ``next_ranges`` (then cleared)."""
        ranges, self.next_ranges = self.next_ranges, None
        if not self.enabled or not ranges:
            return
        self._join()
        self._thread = threading.Thread(target=self._warm,
                                        args=(dict(ranges),), daemon=True,
                                        name="gg-spill-prefetch")
        self._thread.start()

    def take(self, table: str, rng) -> dict | None:
        """The prefetched host buffers of ``table`` over ``rng``, or None."""
        self._join()
        with self._mu:
            return self._ready.pop((table, tuple(rng)), None)

    def _join(self) -> None:
        t = self._thread
        if t is not None:
            t.join()
        self._thread = None

    def close(self) -> None:
        """Join the thread and drop what it built (idempotent)."""
        self.next_ranges = None
        self._join()
        with self._mu:
            self._ready.clear()
