"""Named fault-point injection registry.

Reference parity: src/backend/utils/misc/faultinjector.c (shmem registry of
named points, types skip/error/sleep/panic/suspend, per-point hit counts)
exposed to SQL via gpcontrib/gp_inject_fault. Ours is a process-local
registry with the same point/type/occurrence model; tests and the FTS/DTM
loops consult it at the same structural spots the reference instruments
(probe send, commit phases, motion send, storage read).

Usage:
    faults.inject("fts_probe", "error", segment=2, occurrences=1)
    ...
    faults.check("fts_probe", segment=2)   # raises FaultError once
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


class FaultError(RuntimeError):
    pass


# Registered fault points — the shmem-registry analog's name catalog and
# the source of truth `gg check` (analysis/lint_registry.py) cross-checks:
# every faults.check() site in the package must name a registered point,
# every registered point must have a check() site, and every
# faults.inject() in the test tree must target a registered point (the
# injector's OWN unit tests use throwaway names under a lint pragma).
# Runtime stays permissive — unknown names simply never fire — so the
# registry can't break production; drift is a merge-time lint failure.
FAULT_POINTS = frozenset({
    # multihost control plane (parallel/multihost.py, exec/session.py)
    "dispatch_send", "worker_ack", "heartbeat", "retry_redispatch",
    "mesh_reform", "mirror_promote_during_reform",
    # FTS / DTM (runtime/fts.py, runtime/dtm.py)
    "fts_probe", "dtx_before_prepare", "dtx_after_prepare",
    "dtx_before_commit", "dtx_after_commit", "commit_during_reform",
    # storage read/repair/scrub (storage/)
    "storage_corrupt_block", "repair_copy", "scrub_file", "delta_fold",
    # statement lifecycle (exec/executor.py)
    "cancel_before_dispatch", "cancel_in_staging",
    # memory accounting (exec/executor.py): a 'skip' injection fakes a
    # device RESOURCE_EXHAUSTED at dispatch — OOM classification and
    # spill demotion without a real allocator exhaustion
    "device_oom",
    # vectorized serving (exec/executor.py dispatch_batch): a 'sleep'
    # injection holds a batch on the device so tests can pin window
    # accumulation and stage(k+1)/dispatch(k) pipeline overlap
    "batch_dispatch",
    # overload armor (runtime/server.py, runtime/overload.py): a 'skip'
    # injection at overload_accept forces the connection-shed path as if
    # the server were at max_connections; any firing type at
    # brownout_force is forced memory pressure — the deterministic
    # brownout drill (occurrences=-1 holds the state until reset)
    "overload_accept", "brownout_force",
    # hot-table write path (storage/manifest.py, runtime/ingest.py):
    # intent_stage parks a writer between staging its durable intent and
    # resolving it (kill = in-doubt rollback); intent_resolve fires TWICE
    # per commit — before the merge line is appended and again after it
    # is durable but before the marker unlink — so start_after pins
    # either crash window; ingest_flush parks a stream micro-batch after
    # the buffer is drained and before its intent commit (the mid-stream
    # kill window)
    "intent_stage", "intent_resolve", "ingest_flush",
    # data-movement pipeline (exec/motionpipe.py, exec/workfile.py):
    # motion_bucket fires inside every bucket's stage span — a 'sleep'
    # injection widens stage(k+1) across compute(k) so the overlap test
    # asserts pipelining from span timestamps, not wall-clock luck;
    # spill_capture fires as each spill pass lands in the tiered
    # workfile — an 'error' injection mid-schedule proves the disk tier's
    # segment files are swept by the capture path's finally
    "motion_bucket", "spill_capture",
    # coordinator failover (runtime/standby.py, storage/manifest.py):
    # standby_ship fires at the top of every tail sync — an 'error'
    # injection is a ship failure (lag grows, standby_sync_fail_total
    # counts), a 'sleep' widens the window between a primary commit and
    # its ship; coordinator_fence fires inside the fence check at every
    # manifest commit point — a 'sleep' parks a stale primary's commit
    # across a promotion so the split-brain race is deterministic;
    # standby_promote fires at the head of promote(), before the fence is
    # written — occurrence/start_after targeting pins any crash window in
    # the detect -> fence -> sync -> activate -> recover state machine
    "standby_ship", "coordinator_fence", "standby_promote",
    # self-tuning loop (planner/feedback.py, exec/session.py):
    # feedback_apply fires before a calibration candidate is promoted to
    # an applied scale — 'skip' holds every correction pending (checkperf
    # --apply commits them), 'error' probes the reconcile path's
    # isolation from the statement; runaway_broadcast fires before the
    # coordinator ships the cluster runaway verdict to the gang — 'skip'
    # enforces locally only (partial-failure probe); mh_hbm_watermark
    # fires in the worker's completion-ack watermark read — 'skip'
    # substitutes a synthetic over-limit value so the gang test forces a
    # cluster verdict without a real multi-GB allocation
    "feedback_apply", "runaway_broadcast", "mh_hbm_watermark",
})


@dataclass
class _Fault:
    name: str
    type: str                 # skip | error | sleep | panic | suspend
    segment: int | None       # None = any segment
    occurrences: int          # remaining triggers; -1 = unlimited
    sleep_s: float = 0.0
    start_after: int = 0      # hits to ignore before arming (start_occurrence)
    hits: int = 0


@dataclass
class FaultInjector:
    _faults: dict[str, list[_Fault]] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def inject(self, name: str, type: str = "error", segment: int | None = None,
               occurrences: int = 1, sleep_s: float = 0.1,
               start_after: int = 0) -> None:
        """start_after mirrors the reference's start_occurrence: the point
        ignores its first N matching hits before arming, so a test can
        target e.g. the SECOND send of an exchange (the 'go' frame)."""
        if type not in ("skip", "error", "sleep", "panic", "suspend"):
            raise ValueError(f"unknown fault type {type}")
        with self._lock:
            self._faults.setdefault(name, []).append(
                _Fault(name, type, segment, occurrences, sleep_s,
                       start_after))

    def reset(self, name: str | None = None) -> None:
        with self._lock:
            if name is None:
                self._faults.clear()
            else:
                self._faults.pop(name, None)

    def check(self, name: str, segment: int | None = None) -> bool:
        """Evaluate a fault point. Returns True if a 'skip' fired (caller
        should skip its action); raises FaultError for 'error'/'panic';
        sleeps for 'sleep'; blocks for 'suspend' until reset."""
        with self._lock:
            entries = self._faults.get(name, [])
            fired = None
            for f in entries:
                if f.segment is not None and segment is not None and f.segment != segment:
                    continue
                if f.occurrences == 0:
                    continue
                if f.start_after > 0:
                    f.start_after -= 1    # not armed yet: let this hit pass
                    continue
                if f.occurrences > 0:
                    f.occurrences -= 1
                f.hits += 1
                fired = f
                break
        if fired is None:
            return False
        if fired.type == "skip":
            return True
        if fired.type == "sleep":
            time.sleep(fired.sleep_s)
            return False
        if fired.type == "suspend":
            while True:
                time.sleep(0.01)
                with self._lock:
                    if fired.name not in self._faults:
                        return False
        raise FaultError(f"fault injected: {name}"
                         + (f" (segment {segment})" if segment is not None else ""))

    def status(self) -> list[dict]:
        with self._lock:
            return [
                {"name": f.name, "type": f.type, "segment": f.segment,
                 "remaining": f.occurrences, "hits": f.hits,
                 "start_after": f.start_after}
                for fs in self._faults.values() for f in fs
            ]


faults = FaultInjector()   # process-global registry (shmem analog)
