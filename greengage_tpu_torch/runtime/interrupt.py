"""Per-statement interrupts — the CHECK_FOR_INTERRUPTS analog; the port's
copy of greengage_tpu/runtime/interrupt.py.

Reference parity: every reference backend polls CHECK_FOR_INTERRUPTS
(src/include/miscadmin.h, ProcessInterrupts in tcop/postgres.c) so a
statement can be cancelled wherever it happens to be blocked — and
enforcement (statement_timeout), operator action (pg_cancel_backend), the
runaway cleaner, and client disconnects all converge on the SAME flag.

On the card as on the TPU, a launched device program cannot be preempted,
so cancellation is BOUNDARY-GRANULAR — the flag is polled at every place a
statement can linger on the host:

  * executor retry-tier boundaries (before each compile/launch attempt),
  * right before the program launches (after staging),
  * staging-pool read units (a multi-second cold stage dies mid-flight),
  * spill pass / merge-bucket boundaries,
  * ``ResourceQueue.admit()`` and resource-group waits (a queued statement
    leaves the queue),
  * a batched-serving member's wait for its flush (exec/batchserve.py).

One ``StatementContext`` is registered per executing statement in the
process-wide ``REGISTRY`` (keyed by thread — one server connection is one
thread, like one backend per libpq connection). It carries a cancel flag
with a typed cause: ``user`` (gg cancel / the cancel protocol frame),
``timeout`` (statement_timeout_s), ``runaway`` (the vmem red-zone
cleaner), ``client_gone`` (connection dropped), ``shutdown`` (server
stopping). ``check()`` raises ``StatementCancelled`` and the session
counts it once in the ``statements_cancelled_<cause>`` counter family.

Nested executor runs (spill passes, recursive-CTE iterations) share the
outermost statement's context, keeping the whole statement one
cancellable unit — the same discipline runtime/runaway.py uses.
"""

from __future__ import annotations

import itertools
import threading
import time

CAUSES = ("user", "timeout", "runaway", "client_gone", "shutdown")


class StatementCancelled(RuntimeError):
    """Raised at a cancellation point after the statement's flag was set
    (or its deadline expired). ``cause`` is one of CAUSES."""

    def __init__(self, message: str, cause: str = "user"):
        super().__init__(message)
        self.cause = cause


class StatementContext:
    """One executing statement's interrupt state. Thread-safe: cancel()
    may be called from any thread (server control connection, runaway
    cleaner, heartbeat); check() runs on the statement's thread AND on
    staging-pool worker threads acting for it."""

    __slots__ = ("statement_id", "sql", "thread", "started",
                 "deadline", "_lock", "_cause", "_message", "_listeners",
                 "counted", "depth")

    def __init__(self, statement_id: int, sql: str,
                 timeout_s: float = 0.0):
        self.statement_id = statement_id
        self.sql = sql
        self.thread = threading.get_ident()
        self.started = time.monotonic()
        # statement_timeout_s arms a deadline at statement start; 0 = off
        self.deadline = (self.started + timeout_s) if timeout_s > 0 else None
        self._lock = threading.Lock()
        self._cause: str | None = None
        self._message: str | None = None
        self._listeners: list = []
        self.counted = False   # session-level once-per-statement counting
        self.depth = 1         # nested runs share the outermost context

    # ---- cancellation ------------------------------------------------
    def cancel(self, cause: str, message: str | None = None) -> None:
        """Set the flag (first cause wins) and wake registered waiters
        (e.g. a resource-queue wait). Never raises into the caller."""
        if cause not in CAUSES:
            cause = "user"
        with self._lock:
            if self._cause is not None:
                return
            self._cause = cause
            self._message = message
            listeners = list(self._listeners)
        for cb in listeners:
            try:
                cb()
            except Exception:
                pass

    @property
    def cancelled(self) -> bool:
        return self._cause is not None or (
            self.deadline is not None and time.monotonic() >= self.deadline)

    @property
    def cause(self) -> str | None:
        return self._cause

    def remaining(self) -> float | None:
        """Seconds until the statement deadline (None = no timeout)."""
        if self.deadline is None:
            return None
        return max(0.0, self.deadline - time.monotonic())

    def check(self) -> None:
        """Cancellation point: raise StatementCancelled if flagged or past
        the statement deadline (trips the flag with cause 'timeout')."""
        if self._cause is None and self.deadline is not None \
                and time.monotonic() >= self.deadline:
            self.cancel("timeout",
                        f"canceling statement due to statement timeout "
                        f"(statement_timeout_s = "
                        f"{self.deadline - self.started:.3g})")
        cause = self._cause
        if cause is None:
            return
        msg = self._message or {
            "user": "canceling statement due to user request",
            "timeout": "canceling statement due to statement timeout",
            "client_gone": "canceling statement: client connection lost",
            "shutdown": "canceling statement due to server shutdown",
            "runaway": "canceled by the runaway cleaner",
        }.get(cause, "statement cancelled")
        if cause == "runaway":
            # typed subclass so clients distinguish a runaway kill (their
            # statement held too much device memory) from a plain cancel;
            # deferred import — runaway.py imports this module at load
            from greengage_tpu_torch.runtime.runaway import RunawayCancelled

            raise RunawayCancelled(msg)
        raise StatementCancelled(msg, cause)

    # ---- wait integration (resource queue etc.) ----------------------
    def add_listener(self, cb) -> None:
        """Register a wakeup callback fired once at cancel(); if the flag
        is ALREADY set, fire immediately (no lost wakeup)."""
        with self._lock:
            if self._cause is None:
                self._listeners.append(cb)
                return
        try:
            cb()
        except Exception:
            pass

    def remove_listener(self, cb) -> None:
        with self._lock:
            try:
                self._listeners.remove(cb)
            except ValueError:
                pass

    # ---- observability (pg_stat_activity row) ------------------------
    def describe(self) -> dict:
        return {
            "id": self.statement_id,
            "sql": (self.sql or "").strip()[:200],
            "elapsed_s": round(time.monotonic() - self.started, 3),
            "thread": self.thread,
            "cancelled": self._cause,
            "timeout_in_s": (None if self.deadline is None
                             else round(self.deadline - time.monotonic(), 3)),
        }


class StatementRegistry:
    """Process-wide registry of in-flight statements — the
    pg_stat_activity / pg_cancel_backend surface. One entry per executing
    thread; statement ids are monotonic per process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._by_thread: dict[int, StatementContext] = {}

    def enter(self, sql: str, timeout_s: float = 0.0):
        """Register the calling thread's statement. Nested calls (spill
        passes, recursive-CTE fixpoints, retry redispatch) re-enter the
        existing context. -> (ctx, is_outermost)."""
        tid = threading.get_ident()
        with self._lock:
            cur = self._by_thread.get(tid)
            if cur is not None:
                cur.depth += 1
                return cur, False
            ctx = StatementContext(next(self._ids), sql, timeout_s)
            self._by_thread[tid] = ctx
            return ctx, True

    def exit(self, ctx: StatementContext) -> None:
        tid = threading.get_ident()
        with self._lock:
            cur = self._by_thread.get(tid)
            if cur is None:
                return
            cur.depth -= 1
            if cur.depth <= 0:
                del self._by_thread[tid]

    def current(self) -> StatementContext | None:
        # deliberately lock-free: the calling thread reads ITS OWN entry,
        # which only this same thread inserts/deletes (enter/exit), and
        # this runs at every CHECK_FOR_INTERRUPTS — a mutex here would
        # tax every cancellation point in the engine
        return self._by_thread.get(threading.get_ident())

    def get(self, statement_id: int) -> StatementContext | None:
        with self._lock:
            for ctx in self._by_thread.values():
                if ctx.statement_id == statement_id:
                    return ctx
        return None

    def cancel(self, statement_id: int, cause: str = "user",
               message: str | None = None) -> bool:
        """pg_cancel_backend: flag one statement by id. False when no
        such statement is in flight."""
        ctx = self.get(statement_id)
        if ctx is None:
            return False
        ctx.cancel(cause, message)
        return True

    def cancel_thread(self, thread_ident: int, cause: str,
                      message: str | None = None) -> bool:
        """Cancel whatever statement ``thread_ident`` is running (the
        server's client_gone path)."""
        with self._lock:
            ctx = self._by_thread.get(thread_ident)
        if ctx is None:
            return False
        ctx.cancel(cause, message)
        return True

    def cancel_all(self, cause: str, message: str | None = None) -> int:
        """Flag every in-flight statement (server shutdown)."""
        with self._lock:
            ctxs = list(self._by_thread.values())
        for ctx in ctxs:
            ctx.cancel(cause, message)
        return len(ctxs)

    def snapshot(self) -> list[dict]:
        """pg_stat_activity rows for `gg ps`, sorted oldest first."""
        with self._lock:
            ctxs = list(self._by_thread.values())
        return sorted((c.describe() for c in ctxs), key=lambda d: d["id"])


REGISTRY = StatementRegistry()   # shmem PGPROC-array analog


def check_interrupts() -> None:
    """Module-level CHECK_FOR_INTERRUPTS: a no-op for threads with no
    registered statement (worker loops, heartbeats, prefetchers)."""
    ctx = REGISTRY.current()
    if ctx is not None:
        ctx.check()
