"""Mid-flight memory enforcement — the port's copy of
greengage_tpu/runtime/runaway.py (the vmem tracker, red-zone handler and
runaway cleaner roles: vmem_tracker.c, redzone_handler.c,
runaway_cleaner.c).

The reference interposes on every palloc and, at 90% of gp_vmem_protect,
the red-zone handler picks the session holding the most vmem and the
runaway cleaner cancels it at its next CHECK_FOR_INTERRUPTS. A launched
program cannot be preempted on the card either, so the tracker ledgers
each in-flight statement's admitted bytes (the measured bytes of a warm
cached program, the compiled estimate otherwise: exec/executor.py
``_admission_bytes``), and the red-zone check runs at admission against
the process-wide in-flight total, which single-statement admission cannot
see. Crossing the red zone flags the heaviest in-flight statement through
the interrupt registry with cause ``runaway``; it terminates at its next
cancellation point (a retry-tier or spill-pass boundary, a staging unit,
a queue wait).

Statement identity is the executing thread: nested executor runs (spill
passes) share their statement's ledger entry, keeping the whole spilled
statement one cancellable unit.
"""

from __future__ import annotations

import threading
import time

from greengage_tpu_torch.runtime.interrupt import REGISTRY, StatementCancelled


class RunawayCancelled(StatementCancelled):
    """The statement was chosen by the runaway cleaner. A
    StatementCancelled with cause 'runaway': the cleaner is one producer
    of the unified per-statement interrupt flag (runtime/interrupt.py),
    so sessions count and surface it like every other cancellation."""

    def __init__(self, message: str):
        super().__init__(message, "runaway")


class _Entry:
    __slots__ = ("bytes", "cancel_reason", "depth", "flag_time", "ctx",
                 "measured")

    def __init__(self, nbytes: int, ctx=None):
        self.bytes = nbytes
        # True once the price came from the program's measured launch
        # instead of the planner estimate (warm cached programs under
        # mem_accounting_enabled) — the cleaner then arbitrates on ground
        # truth, and the mem op shows which
        self.measured = False
        self.cancel_reason: str | None = None
        self.depth = 1          # nested executor runs (spill passes)
        self.flag_time = 0.0
        # the statement's interrupt context (when one is registered):
        # flagging the victim ALSO sets the unified cancel flag, so every
        # cancellation point (staging, queue, spill) observes it — not
        # just the tracker's own check()
        self.ctx = ctx


class VmemTracker:
    """Process-wide in-flight ledger keyed by executing thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self._active: dict[int, _Entry] = {}

    # ---- statement lifecycle -----------------------------------------
    def enter(self) -> None:
        """Register (or re-enter, for nested spill-pass runs) the calling
        thread's statement."""
        tid = threading.get_ident()
        ctx = REGISTRY.current()
        with self._lock:
            cur = self._active.get(tid)
            if cur is not None:
                cur.depth += 1
            else:
                self._active[tid] = _Entry(0, ctx)

    def reprice(self, est_bytes: int, global_limit_bytes: int,
                red_zone: float, measured: bool = False) -> None:
        """Record this statement's admitted bytes, then run the
        red-zone scan: when the cluster-wide total crosses the zone, flag
        the HEAVIEST in-flight statement for termination
        (runaway_cleaner.c picks the top consumer); it dies at its next
        cancellation point. If the caller IS the top consumer, the flag
        lands on itself."""
        tid = threading.get_ident()
        with self._lock:
            cur = self._active.get(tid)
            if cur is None:
                return
            # last-write, not max: once a statement enters the spill
            # regime its footprint IS the per-pass estimate — the
            # rejected whole-plan estimate was never allocated
            cur.bytes = est_bytes
            cur.measured = bool(measured)
            if not global_limit_bytes:
                return
            total = sum(e.bytes for e in self._active.values())
            if total <= red_zone * global_limit_bytes:
                return

            now = time.monotonic()
            if any(e.cancel_reason is not None and now - e.flag_time < 10.0
                   for e in self._active.values()):
                return   # a victim is dying; its bytes release soon. A
                # STALE flag (victim past its last cancellation point)
                # must not disable enforcement forever, so it ages out
            victim = None
            for t, e in self._active.items():
                if t == tid or e.cancel_reason is not None:
                    continue
                if victim is None or e.bytes > victim.bytes:
                    victim = e
            if victim is None or victim.bytes < cur.bytes:
                if len(self._active) == 1:
                    # alone over the zone is not CONTENTION — the
                    # per-statement limit (admission/spill) governs a
                    # lone statement; the cleaner only arbitrates between
                    # statements
                    return
                if cur.bytes < max(e.bytes for e in self._active.values()):
                    # the true top consumer already carries a (stale)
                    # flag; cancelling a lighter newcomer frees nothing
                    return
                victim = cur   # newcomer is the top consumer under
                # contention: it takes the cancellation (runaway_cleaner
                # picks the largest)
            target = victim
            target.flag_time = now
            target.cancel_reason = (
                f"canceled by the runaway cleaner: cluster in-flight device "
                f"memory ~{total >> 20} MB crossed the red zone "
                f"({red_zone:.0%} of {global_limit_bytes >> 20} MB) and this "
                f"statement was the top consumer (~{target.bytes >> 20} MB)")
            if target.ctx is not None:
                # unified cancellation: the victim dies at ANY of its
                # cancellation points (staging unit, queue wait, spill
                # boundary), not only at the tracker's own check()
                target.ctx.cancel("runaway", target.cancel_reason)

    def check(self) -> None:
        """Cancellation point: raise if this thread's statement was picked
        (CHECK_FOR_INTERRUPTS analog)."""
        tid = threading.get_ident()
        with self._lock:
            e = self._active.get(tid)
            reason = e.cancel_reason if e is not None else None
        if reason is not None:
            raise RunawayCancelled(reason)

    def release(self) -> None:
        tid = threading.get_ident()
        with self._lock:
            e = self._active.get(tid)
            if e is None:
                return
            e.depth -= 1
            if e.depth <= 0:
                del self._active[tid]

    # ---- observability (gp_toolkit vmem views role) -------------------
    def snapshot(self) -> list[dict]:
        with self._lock:
            return [{"thread": t, "bytes": e.bytes,
                     "measured": e.measured,
                     "statement_id": (e.ctx.statement_id
                                      if e.ctx is not None else None),
                     "flagged": e.cancel_reason is not None}
                    for t, e in self._active.items()]


TRACKER = VmemTracker()
