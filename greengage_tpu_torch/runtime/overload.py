"""Memory-pressure brownout controller — the port's copy of
greengage_tpu/runtime/overload.py: degrade before dying, for the serving
plane.

The reference engine survives sustained overload by shedding work in
layers before anything dies: connection limits at the postmaster, queue
rejection (SQLSTATE 53300) at admission, and the vmem red zone mid-flight.
The bounded front end (runtime/server.py) and the admission-queue shed
(runtime/resqueue.py) cover the first two; this module supplies a third,
memory-shaped layer: a typed BROWNOUT state the engine enters when
device-memory pressure says the next admission is likely to run the card
out of memory, and leaves with hysteresis once pressure clears.

Pressure signals (``OverloadController.evaluate``, rate-limited to one
allocator probe per quarter second):

  * the card's allocated bytes — ``memaccount.device_memory_stats()``
    ``bytes_in_use / bytes_limit`` (the caching allocator's allocated
    bytes against the card's memory; the cache it keeps reserved is not
    pressure) at or above ``brownout_enter_pct``; while in brownout the
    bar drops to ``brownout_exit_pct``, so the state cannot flap across
    one allocation. No card, no watermark (the CPU);
  * OOM streaks — ``brownout_oom_events`` classified device OOMs (the
    ``oom_events`` counter) within ``brownout_window_s``;
  * the ``brownout_force`` fault point — deterministic drills (arm with
    type ``skip``, occurrences=-1).

Effects while browned out (pull-based — consumers read the controller):

  * batch serving is off — new statements take the classic serial path
    (``Database._batch_eligible`` reads ``brownout_active()``): stacking
    members' parameters multiplies footprints exactly when the card has
    no headroom;
  * new admissions prefer the spill passes: the executor scales its
    admission ceiling by ``brownout_vmem_factor``;
  * ``cache_factor()`` scales the block-cache budget
    (storage/blockcache.py ``CacheRegistry.limit_bytes`` reads it live;
    the session evicts to the shrunken budget on entry).

Exit is hysteretic twice over: the watermark bar drops to the exit
fraction, AND every signal must stay clear for ``brownout_exit_s``.

The controller is process-wide (``CONTROLLER``), like the counters and the
interrupt registry: the card it models is shared by every Database in the
process. Transitions land in ``brownout_entered_total`` /
``brownout_exited_total`` and the ``brownout`` gauge; ``snapshot()`` feeds
the server's ``status`` and ``ps`` ops. Its lock is named for the
lock-order witness (runtime/lockdebug.py).
"""

from __future__ import annotations

import threading
import time
from collections import deque

from greengage_tpu_torch.runtime import lockdebug
from greengage_tpu_torch.runtime.faultinject import FaultError, faults
from greengage_tpu_torch.runtime.logger import counters


class OverloadController:
    """The brownout state machine. Thread-safe: any statement thread may
    evaluate; server control frames read snapshots concurrently."""

    MIN_EVAL_S = 0.25   # allocator probe rate limit

    def __init__(self):
        self._lock = lockdebug.named(threading.Lock(), "overload._lock")
        self._brownout = False
        self._reason: str | None = None
        self._entered_at = 0.0
        self._clear_since: float | None = None
        self._last_eval = 0.0
        self._cache_factor = 1.0
        self._vmem_factor = 1.0
        # (monotonic time, oom_events counter value) samples inside the
        # sliding window — the streak detector's memory
        self._oom_marks: deque = deque()

    # ---- consumers (pull-based effects) ------------------------------
    def brownout_active(self) -> bool:
        with self._lock:
            return self._brownout

    def cache_factor(self) -> float:
        """Multiplier for the block-cache byte budget (1.0 = normal)."""
        with self._lock:
            return self._cache_factor if self._brownout else 1.0

    def scaled_vmem(self, limit_bytes: int) -> int:
        """Brownout-scaled per-query admission ceiling: a smaller limit
        routes borderline statements to the spill tier instead of racing
        a pressured allocator. 0 (unlimited) stays 0 — the operator
        disabled the guard explicitly."""
        with self._lock:
            if not self._brownout or limit_bytes <= 0:
                return limit_bytes
            return max(int(limit_bytes * self._vmem_factor), 1 << 20)

    # ---- evaluation ---------------------------------------------------
    def evaluate(self, settings, force: bool = False) -> bool:
        """Run the state machine once (rate-limited unless ``force``);
        returns the post-evaluation brownout state. Callers compare
        against their last-seen state to apply edge effects (prompt
        cache eviction, logging)."""
        now = time.monotonic()
        with self._lock:
            if not force and (now - self._last_eval) < self.MIN_EVAL_S:
                return self._brownout
            self._last_eval = now
            in_brownout = self._brownout
        if not bool(getattr(settings, "brownout_enabled", True)):
            pressure, reason = False, None
        else:
            pressure, reason = self._pressure(settings, now, in_brownout)
        with self._lock:
            if pressure:
                self._clear_since = None
                if not self._brownout:
                    self._brownout = True
                    self._reason = reason
                    self._entered_at = now
                    counters.inc("brownout_entered_total")
                    counters.set("brownout", 1)
            elif self._brownout:
                if self._clear_since is None:
                    self._clear_since = now
                if (now - self._clear_since) >= float(getattr(
                        settings, "brownout_exit_s", 5.0)):
                    self._brownout = False
                    self._reason = None
                    self._clear_since = None
                    counters.inc("brownout_exited_total")
                    counters.set("brownout", 0)
            if self._brownout:
                # refresh the effect factors from settings EVERY
                # evaluation, not just on entry: `SET
                # brownout_cache_factor = 0.2` during a live incident
                # must change the budget at the next evaluation (the
                # GUCS.md "read live" contract), not after a re-entry
                self._cache_factor = _clamp(getattr(
                    settings, "brownout_cache_factor", 0.5))
                self._vmem_factor = _clamp(getattr(
                    settings, "brownout_vmem_factor", 0.5))
            return self._brownout

    def _pressure(self, settings, now: float,
                  in_brownout: bool) -> tuple[bool, str | None]:
        """One pressure reading across all three signals. Runs OUTSIDE
        the controller lock (device probe + fault registry have their
        own locks); only the OOM-mark deque re-enters briefly."""
        # deterministic drills: treat any firing type as forced pressure
        # (an 'error' injection must force the state, not fail a query)
        try:
            forced = faults.check("brownout_force")
        except FaultError:
            forced = True
        if forced:
            return True, "forced by fault injection (brownout_force)"
        # the card's allocated bytes vs the hysteresis band
        from greengage_tpu_torch.runtime import memaccount

        stats = memaccount.device_memory_stats()
        if stats:
            cap = int(stats.get("bytes_limit", 0) or 0)
            used = int(stats.get("bytes_in_use", 0) or 0)
            if cap > 0:
                frac = used / cap
                bar = float(getattr(settings, "brownout_exit_pct", 0.80)
                            if in_brownout else
                            getattr(settings, "brownout_enter_pct", 0.92))
                if frac >= bar:
                    return True, (
                        f"device memory {frac:.0%} of the card "
                        f"({used >> 20}/{cap >> 20} MB) at/above "
                        f"{bar:.0%}")
        # classified-OOM streak inside the sliding window
        window = max(float(getattr(settings, "brownout_window_s", 30.0)),
                     0.001)
        threshold = int(getattr(settings, "brownout_oom_events", 3))
        oom_now = counters.get("oom_events")
        with self._lock:
            self._oom_marks.append((now, oom_now))
            while self._oom_marks and \
                    (now - self._oom_marks[0][0]) > window:
                self._oom_marks.popleft()
            delta = oom_now - self._oom_marks[0][1]
        if threshold > 0 and delta >= threshold:
            return True, (f"{delta} device OOM events within "
                          f"{window:g}s (brownout_oom_events="
                          f"{threshold})")
        return False, None

    # ---- observability -----------------------------------------------
    def snapshot(self) -> dict:
        """The status and ps ops' payload."""
        now = time.monotonic()
        with self._lock:
            return {
                "brownout": self._brownout,
                "reason": self._reason,
                "since_s": (round(now - self._entered_at, 3)
                            if self._brownout else None),
                "cache_factor": (self._cache_factor if self._brownout
                                 else 1.0),
                "batch_serving_disabled": self._brownout,
            }

    def reset(self) -> None:
        """Test teardown: drop to the normal state and zero the gauge so
        one test's forced brownout cannot leak into the next."""
        with self._lock:
            was = self._brownout
            self._brownout = False
            self._reason = None
            self._clear_since = None
            self._last_eval = 0.0
            self._oom_marks.clear()
            if was:
                counters.set("brownout", 0)


def _clamp(v, lo: float = 0.05, hi: float = 1.0) -> float:
    return min(max(float(v), lo), hi)


CONTROLLER = OverloadController()   # process-wide, like counters/REGISTRY
