"""Resource groups — per-group device-time, concurrency and memory shares;
the port's copy of greengage_tpu/runtime/resgroup.py.

Reference parity: resource groups (src/backend/utils/resgroup/resgroup.c)
give each role a slot-based concurrency cap, a memory share, and a CPU
share enforced through cgroups; the backoff sweeper
(src/backend/postmaster/backoff.c:723 BackoffSweeper) additionally skews
CPU between concurrent statements by priority. On the card as on the TPU
the scarce resources are device time and device memory, so a group carries

  concurrency      max concurrent statements of this group (0 = off)
  memory_limit_mb  per-query estimated-bytes ceiling while running under
                   the group (feeds executor.effective_limit_bytes, so a
                   capped query SPILLS instead of failing)
  cpu_weight       backoff share: when a global slot frees, the waiter
                   from the group with the LEAST weighted consumed device
                   time runs first (consumed_s / cpu_weight), standing in
                   for cgroup cpu.shares

Groups are session-wide objects, persisted in the catalog as the JAX
package does (catalog.json of a database directory, so they survive a
reopen; in memory without one). The ACTIVE group is per thread
(one server connection = one thread), set with
``SET resource_group = <name>``. A statement's ``consumed_s`` ("chip
seconds" in ``status()``) is host-clock time around its execution, which
ends with the copy of its result to the host.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from greengage_tpu_torch.runtime import interrupt
from greengage_tpu_torch.runtime.logger import counters

DEFAULT_GROUP = "default_group"
ADMIN_GROUP = "admin_group"


class GroupTimeout(RuntimeError):
    pass


@dataclass
class ResourceGroup:
    name: str
    concurrency: int = 0          # 0 = unlimited (no slot gating)
    memory_limit_mb: int = 0      # 0 = inherit the global vmem ceiling
    cpu_weight: int = 100
    # runtime state (not persisted)
    active: int = 0
    waiting: int = 0
    admitted_total: int = 0
    timed_out_total: int = 0
    consumed_s: float = field(default=0.0)

    def to_dict(self) -> dict:
        return {"name": self.name, "concurrency": self.concurrency,
                "memory_limit_mb": self.memory_limit_mb,
                "cpu_weight": self.cpu_weight}

    @staticmethod
    def from_dict(d: dict) -> "ResourceGroup":
        return ResourceGroup(d["name"], d.get("concurrency", 0),
                             d.get("memory_limit_mb", 0),
                             d.get("cpu_weight", 100))


_local = threading.local()


def current_memory_limit_mb() -> int:
    """The calling thread's group memory ceiling (0 = none). Consulted by
    executor.effective_limit_bytes for every run."""
    return getattr(_local, "mem_limit_mb", 0)


class ResourceGroupManager:
    """Admission control over the group set + weighted-fair wakeup."""

    def __init__(self, settings, groups: dict[str, ResourceGroup] | None = None):
        self.settings = settings
        # RLock: add_listener fires the waker INLINE when the cancel flag
        # is already set, on the admitting thread, while it holds this
        # lock (same re-entrancy as ResourceQueue)
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self.groups: dict[str, ResourceGroup] = groups or {}
        for name, weight in ((DEFAULT_GROUP, 100), (ADMIN_GROUP, 300)):
            self.groups.setdefault(name, ResourceGroup(name, cpu_weight=weight))

    # ---- DDL ----------------------------------------------------------
    def create(self, name: str, **opts) -> None:
        with self._lock:
            if name in self.groups:
                raise ValueError(f'resource group "{name}" already exists')
            self.groups[name] = ResourceGroup(name, **opts)

    def drop(self, name: str) -> None:
        with self._lock:
            if name in (DEFAULT_GROUP, ADMIN_GROUP):
                raise ValueError(f'cannot drop built-in group "{name}"')
            g = self.groups.get(name)
            if g is None:
                raise ValueError(f'resource group "{name}" does not exist')
            if g.active or g.waiting:
                raise ValueError(
                    f'resource group "{name}" has active statements')
            del self.groups[name]
            if getattr(_local, "group", None) == name:
                _local.group = DEFAULT_GROUP

    def alter(self, name: str, **opts) -> None:
        with self._cond:
            g = self.groups.get(name)
            if g is None:
                raise ValueError(f'resource group "{name}" does not exist')
            for k, v in opts.items():
                setattr(g, k, v)
            self._cond.notify_all()   # a raised cap can admit waiters

    # ---- session binding ---------------------------------------------
    def set_group(self, name: str) -> None:
        if name not in self.groups:
            raise ValueError(f'resource group "{name}" does not exist')
        _local.group = name

    def current_group(self) -> str:
        return getattr(_local, "group", DEFAULT_GROUP)

    # ---- admission ----------------------------------------------------
    def _global_cap(self) -> int:
        return int(getattr(self.settings, "resource_group_global_active", 0))

    def _total_active(self) -> int:
        return sum(g.active for g in self.groups.values())

    def _runnable(self, g: ResourceGroup) -> bool:
        if g.concurrency and g.active >= g.concurrency:
            return False
        cap = self._global_cap()
        if cap and self._total_active() >= cap:
            return False
        return True

    def _my_turn(self, g: ResourceGroup) -> bool:
        """Backoff ordering: with a GLOBAL cap configured, the free slot
        goes to the waiter whose group has the least weighted consumed
        chip time — not to whichever thread wakes first; per-group caps
        alone stay FIFO-per-group."""
        if not self._global_cap():
            return True
        nxt = self._next_group()
        return nxt is None or nxt == g.name

    def _eligible(self, g: ResourceGroup) -> bool:
        return self._runnable(g) and self._my_turn(g)

    def _next_group(self) -> str | None:
        """Pick the waiting group with least consumed_s / cpu_weight."""
        best, best_key = None, None
        for g in self.groups.values():
            if not g.waiting:
                continue
            if g.concurrency and g.active >= g.concurrency:
                continue
            key = g.consumed_s / max(g.cpu_weight, 1)
            if best_key is None or key < best_key:
                best, best_key = g.name, key
        return best

    def admit(self, group: str | None = None):
        name = group or self.current_group()
        timeout = float(getattr(self.settings, "resource_queue_timeout_s", 30.0))
        ctx = interrupt.REGISTRY.current()
        with self._cond:
            g = self.groups.get(name)
            if g is None:   # dropped since SET: fall back to default
                g = self.groups[DEFAULT_GROUP]
            if not g.concurrency and not self._global_cap():
                g.admitted_total += 1
                return _GroupSlot(self, g, counted=False)
            if not self._eligible(g):
                # the statement would have to WAIT (no slot, or a slot
                # but not this group's backoff turn — the same predicate
                # the wait loop blocks on): load-shed before joining.
                # Depth counts waiters across ALL groups, since the
                # global cap is what they contend for
                from greengage_tpu_torch.runtime.resqueue import shed_check

                shed_check(self.settings,
                           sum(x.waiting for x in self.groups.values()),
                           "resource group")
            deadline = time.monotonic() + timeout
            g.waiting += 1
            # cancel() from another thread must WAKE this wait, not be
            # discovered at the next timeout slice (same discipline as
            # ResourceQueue.admit)
            waker = None
            if ctx is not None:
                def waker():
                    with self._cond:
                        self._cond.notify_all()
                ctx.add_listener(waker)
            try:
                while not self._eligible(g):
                    if ctx is not None and ctx.cancelled:
                        # leave the wait NOW; re-notify so a release that
                        # raced our abandonment is never lost
                        self._cond.notify_all()
                        counters.inc("queue_cancelled_total")
                        ctx.check()   # raises StatementCancelled
                    remaining = deadline - time.monotonic()
                    if ctx is not None:
                        sr = ctx.remaining()
                        if sr is not None:
                            remaining = min(remaining, sr + 0.001)
                    if remaining <= 0 or not self._cond.wait(remaining):
                        if ctx is not None and ctx.cancelled:
                            continue   # classify at the loop head
                        if self._eligible(g):
                            break
                        if deadline - time.monotonic() > 0:
                            continue   # woken by a cancel-listener ping
                        g.timed_out_total += 1
                        self._cond.notify_all()
                        raise GroupTimeout(
                            f"resource group {g.name}: no slot within "
                            f"{timeout:.0f}s "
                            f"(concurrency={g.concurrency or 'unlimited'})")
            finally:
                g.waiting -= 1
                if waker is not None:
                    ctx.remove_listener(waker)
            g.active += 1
            g.admitted_total += 1
            # wake deferred waiters: our admission changed _next_group()'s
            # answer, and a notify that fired while they held the lock (not
            # yet in wait()) would otherwise be lost until their timeout
            self._cond.notify_all()
            return _GroupSlot(self, g, counted=True)

    def release(self, g: ResourceGroup, elapsed_s: float, counted: bool) -> None:
        with self._cond:
            g.consumed_s += elapsed_s
            if counted:
                g.active -= 1
            self._cond.notify_all()

    def kick(self) -> None:
        """Re-evaluate all waiters (a settings change moved the caps)."""
        with self._cond:
            self._cond.notify_all()

    # ---- observability (gp_toolkit.gp_resgroup_status analog) ---------
    def status(self) -> list[dict]:
        with self._lock:
            return [{
                "name": g.name, "concurrency": g.concurrency,
                "memory_limit_mb": g.memory_limit_mb,
                "cpu_weight": g.cpu_weight, "active": g.active,
                "waiting": g.waiting, "admitted": g.admitted_total,
                "timed_out": g.timed_out_total,
                "chip_seconds": round(g.consumed_s, 3),
            } for g in self.groups.values()]


class _GroupSlot:
    """Context manager holding one admission slot; binds the group's
    memory ceiling to the thread and accounts chip time on release."""

    def __init__(self, mgr: ResourceGroupManager, group: ResourceGroup,
                 counted: bool):
        self.mgr = mgr
        self.group = group
        self.counted = counted
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.monotonic()
        _local.mem_limit_mb = self.group.memory_limit_mb
        return self

    def __exit__(self, *a):
        _local.mem_limit_mb = 0
        self.mgr.release(self.group, time.monotonic() - self._t0,
                         self.counted)
        return False
