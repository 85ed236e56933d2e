"""Resource queues — concurrency/memory admission control; the port's copy
of greengage_tpu/runtime/resqueue.py.

Reference parity: resource queues gate statements before execution
(ResLockPortal, src/backend/utils/resscheduler/resscheduler.c:534) by
active-statement count and cost ceilings; resource groups add per-role
memory shares (src/backend/utils/resgroup/resgroup.c). On the card as on
the TPU the scarce resources are device time and device memory, so a
queue bounds concurrent statements and per-query estimated device bytes
(``resource_queue_memory_mb`` tightens exec/executor.effective_limit_bytes,
so a capped query spills), and queues excess statements FIFO with a
timeout instead of failing them.

A queued statement is a cancellation point (runtime/interrupt.py): a
cancelled waiter leaves the queue immediately — its cancel() wakes the
wait via a registered listener, and the abandoning waiter re-notifies so
a racing release is never lost (the same discipline as the timeout path).

Overload armor (the JAX package's docs/ROBUSTNESS.md "Overload
protection"): with
``admission_queue_limit`` set, a statement that would have to WAIT is
load-shed by ``shed_check`` — a typed, retryable ``AdmissionShed``
(SQLSTATE 53300 analog) at the depth cap, ramping in probabilistically
from ``admission_shed_ramp`` x cap — instead of queueing unboundedly.

Usage (session-level):
    SET resource_queue_active = 2        -- concurrent statements
    SET resource_queue_memory_mb = 4096  -- per-query est ceiling (0 = off)
    SET resource_queue_timeout_s = 30
    SET admission_queue_limit = 8        -- shed past this queue depth
"""

from __future__ import annotations

import random
import threading
import time

from greengage_tpu_torch.runtime import interrupt
from greengage_tpu_torch.runtime.logger import counters


class QueueTimeout(RuntimeError):
    pass


class AdmissionShed(RuntimeError):
    """Typed load-shed rejection (the SQLSTATE 53300 'insufficient
    resources / too many connections' analog): the admission queue is at
    (or ramping toward) its depth cap and this statement was rejected
    instead of queued. Retryable by design — the client should back off
    and retry; the server maps it to a retryable response frame."""

    sqlstate = "53300"
    retryable = True


def shed_check(settings, depth: int, what: str) -> None:
    """Queue-depth load shedding (docs/ROBUSTNESS.md "Overload
    protection"), shared by the resource queue and resource groups.

    ``depth`` is how many statements are ALREADY waiting for a slot; the
    caller invokes this only when the new statement would have to wait.
    At ``admission_queue_limit`` the statement sheds outright; from
    ``admission_shed_ramp`` x the cap upward it sheds probabilistically,
    with probability rising linearly to 1 at the cap — rejection is a
    ramp, not a cliff, so a burst near capacity degrades gradually
    instead of flipping between "everyone queues" and "everyone dies".
    0 disables (legacy queue-forever behavior)."""
    cap = int(getattr(settings, "admission_queue_limit", 0))
    if cap <= 0:
        return
    if depth >= cap:
        counters.inc("admission_shed_total")
        raise AdmissionShed(
            f"statement shed: {what} admission queue is full "
            f"({depth} waiting, admission_queue_limit={cap}); "
            "retry with backoff")
    ramp = min(max(float(getattr(settings, "admission_shed_ramp", 0.75)),
                   0.0), 1.0)
    start = cap * ramp
    if depth > start:
        p = (depth - start) / max(cap - start, 1e-9)
        if random.random() < p:
            counters.inc("admission_shed_total")
            raise AdmissionShed(
                f"statement shed: {what} admission queue depth {depth} "
                f"approaching admission_queue_limit={cap} "
                f"(shed probability {p:.2f}); retry with backoff")


class ResourceQueue:
    """FIFO admission gate for statements."""

    def __init__(self, settings):
        self.settings = settings
        # RLock: add_listener fires the waker INLINE when the flag is
        # already set, on the admitting thread, while it holds this lock
        self._lock = threading.RLock()
        self._slots = threading.Condition(self._lock)
        self.active = 0
        self.waiting = 0
        self.admitted_total = 0
        self.timed_out_total = 0
        self.cancelled_total = 0

    def admit(self):
        """Blocks until a slot frees; raises QueueTimeout once
        resource_queue_timeout_s of TOTAL wait has elapsed (deadline-based:
        wakeups don't restart the clock), or StatementCancelled the moment
        the waiter's statement is cancelled. A waiter abandoning for either
        reason re-notifies so a racing release is never lost."""
        limit = int(self.settings.resource_queue_active)
        ctx = interrupt.REGISTRY.current()
        with self._slots:
            if limit <= 0:
                self.admitted_total += 1
                return _Slot(self, counted=False)
            if self.active >= limit:
                # the statement would have to WAIT: load-shed before
                # joining the queue (admitted statements never shed)
                shed_check(self.settings, self.waiting, "resource queue")
            timeout = float(self.settings.resource_queue_timeout_s)
            deadline = time.monotonic() + timeout
            self.waiting += 1
            # cancel() from another thread must WAKE this wait, not be
            # discovered at the next timeout slice
            waker = None
            if ctx is not None:
                def waker():
                    with self._slots:
                        self._slots.notify_all()
                ctx.add_listener(waker)
            try:
                while self.active >= limit:
                    if ctx is not None and ctx.cancelled:
                        # leave the queue NOW; re-notify so a release
                        # that raced our abandonment is never lost
                        self._slots.notify()
                        self.cancelled_total += 1
                        counters.inc("queue_cancelled_total")
                        ctx.check()   # raises StatementCancelled
                    remaining = deadline - time.monotonic()
                    if ctx is not None:
                        # wake at the statement deadline too, so a
                        # statement_timeout_s shorter than the queue
                        # timeout still fires on time
                        sr = ctx.remaining()
                        if sr is not None:
                            remaining = min(remaining, sr + 0.001)
                    if remaining <= 0 or not self._slots.wait(remaining):
                        if ctx is not None and ctx.cancelled:
                            continue   # classify at the loop head
                        if deadline - time.monotonic() > 0:
                            continue   # woken by a cancel-listener ping
                        # final predicate re-check: a notify that raced our
                        # timeout must not be swallowed
                        if self.active < limit:
                            break
                        self._slots.notify()
                        self.timed_out_total += 1
                        raise QueueTimeout(
                            f"statement timed out after {timeout:.0f}s "
                            f"waiting for a resource queue slot "
                            f"({self.active} active, limit {limit})")
            finally:
                self.waiting -= 1
                if waker is not None:
                    ctx.remove_listener(waker)
            self.active += 1
            self.admitted_total += 1
        return _Slot(self, counted=True)

    def _release(self):
        with self._slots:
            self.active -= 1
            self._slots.notify()

    def stats(self) -> dict:
        return {"active": self.active, "waiting": self.waiting,
                "admitted": self.admitted_total,
                "timed_out": self.timed_out_total,
                "cancelled": self.cancelled_total,
                "limit": int(self.settings.resource_queue_active)}


class _Slot:
    def __init__(self, q: ResourceQueue, counted: bool):
        self._q = q
        self._counted = counted
        self._done = False

    def release(self):
        if self._counted and not self._done:
            self._done = True
            self._q._release()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.release()
