"""Stage, run and present a planned statement — the port's counterpart of
greengage_tpu/exec/executor.py.

``Executor.run`` follows the JAX executor's path for one statement:

  compile   the plan over the scanned tables' shapes (their capacities:
            staged ones, and the JAX compiler's for estimates), which
            gives the program and its per-segment byte estimate
  admit     past the ceiling (``effective_limit_bytes``) the statement
            runs in spill passes (exec/spill.py) instead, or raises
            ``AdmissionError`` inside a pass
  stage     every scanned table's needed columns, read per segment from the
            store, assembled into ``[nseg, cap]`` host buffers (pinned on a
            card) and copied to the device ``non_blocking``; whole tables
            stay in a cache keyed by (table, column, capacity, store
            version), so a warm statement sends nothing over PCIe. A spill
            pass's row range and an aux table (a pass's captured rows)
            stage apart from that cache
  tiers     run; the overflow flags (motion buckets, join tables and
            expansions, group tables, key packing, the pre-Gather
            compaction) come back in ONE host copy with the Gather's live
            count and the metrics; an overflow re-runs at the next tier
            (capacities x4), at its exact reported size, or unpacked, up
            to ``motion_retry_tiers``. A statement's exact counts are kept
            per plan-cache key (cap hints), so its next run starts at the
            size this one measured
  gather    the Gather Motion on the device: every segment's live rows (one
            segment's for a replicated child), compacted, merge-ordered
            when the plan asks, and a Limit's OFFSET/LIMIT trimmed
  present   one copy to the host and the decode (TEXT via its dictionary,
            DECIMAL descaled to float64, DATE to datetime64), unless the
            caller asks for the storage form (``raw``, spill captures)

A ``torch.OutOfMemoryError`` anywhere in staging or the program demotes
the statement to the spill passes once (``oom_spill_retry``); a second
one, or one inside a pass, raises ``OutOfDeviceMemory`` with the
statement's memory account (runtime/memaccount.py).

Measured admission (the JAX executor's ``_ensure_mem_analysis`` and
``_admission_bytes``): torch has no analysis of a program before it runs,
so the first launch of each cached program (a plan-cache key at its
version, tier and cap hints, with no retry or spill override in flight)
is measured instead: its staged inputs, its outputs and the allocator's
peak above what was allocated before the launch, kept in ``_programs``
and reused by every warm run (``mem_analysis_runs`` counts measurements).
A launch is measured only when no other statement's device work runs
beside it (the allocator's peak counter is process-wide); otherwise a
later run measures it. Admission charges the measured bytes per segment
once they exist and the card reported a peak above the launch's inputs
and outputs, the estimate otherwise: on the CPU, which has no allocator
to read, always the estimate. The admitted bytes also price the
statement in the runaway tracker (runtime/runaway.py), and a brownout
(runtime/overload.py) scales the ceiling down.

Cancellation points (runtime/interrupt.py) sit where the JAX executor
has them: each retry-tier boundary, right before the program launches
(with the ``cancel_before_dispatch`` fault point), between per-table
assemblies and in every staging unit (``cancel_in_staging``; pool threads
check the statement's own context). A launched program is never aborted:
the statement dies at its next point. The ``device_oom`` fault point
fakes an allocator failure at launch. The stage cache and the cap hints
are shared by every thread's statements and locked.

The batch half (``prepare_batch`` / ``dispatch_batch`` / ``demux_batch``,
``run_batch``) runs a window of same-shape statements as one batched
program (exec/compile.py ``batch_width``) for exec/batchserve.py: the
width bucketed to a power of two, members padded with the last one's
parameters, admission against ``effective_limit_bytes`` as the JAX
executor admits a bucket (keyed ``f"{cache_key}@w{bucket}"``: its first
launch measured, a warm bucket admitted by its measured bytes, a cold one
by ``est_bytes`` of its W members), one flag read and one copy of every member's
outputs to the host, and each member's Gather finished there. Anything
that keeps the window from running as one program raises
``BatchFallback`` and every member runs the classic path.

What admission charges: the estimate counts every scan node's batch at
its capacity, so the columns the stage cache already holds for the
statement are charged as the statement's own (they are resident while it
runs). A statement that spills first drops its tables' cached columns and
returns the allocator's free blocks, so its passes do not run beside the
whole tables they partition.

``run_tiers`` is the part after the plan: the hand-built Q1 plan
(entry.q1_result) runs through it over tables it staged itself.
"""

from __future__ import annotations

import shutil
import tempfile
import threading
import time
import weakref
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from greengage_tpu_torch import expr as E
from greengage_tpu_torch import types as T
from greengage_tpu_torch.catalog import PolicyKind
from greengage_tpu_torch.exec import staging
from greengage_tpu_torch.exec.compile import (
    VALID_PREFIX, CompileResult, Compiler, ProgramOutput, TableData,
    TableShape, _pow2, collect_scans,
)
from greengage_tpu_torch.ops import sort as sort_ops
from greengage_tpu_torch.ops.batch import Batch
from greengage_tpu_torch.runtime import interrupt, lockdebug, memaccount
from greengage_tpu_torch.runtime import overload as _overload
from greengage_tpu_torch.runtime import trace as _trace
from greengage_tpu_torch.runtime.faultinject import faults
from greengage_tpu_torch.runtime.logger import (DEFAULT_BUCKETS_MB, counters,
                                                histograms)
from greengage_tpu_torch.runtime.resgroup import current_memory_limit_mb
from greengage_tpu_torch.runtime.runaway import TRACKER
from greengage_tpu_torch.storage.blockcache import MISS


class QueryError(RuntimeError):
    """A statement the executor cannot finish (capacity tiers exhausted,
    duplicate keys on a unique join's build side, an unspillable shape
    past the memory ceiling)."""


class AdmissionError(QueryError):
    """The estimate passed the memory ceiling where the statement may not
    spill (inside a spill pass): the signal the spill merge keys its
    bucketed re-merge on."""


class BatchFallback(Exception):
    """A batched-serving window cannot run as one program (admission
    ceiling, overflow flags, a shape the batched program cannot build):
    every member re-runs serially through the classic path, which owns
    retries and spill. Never surfaces to a client — it only routes
    execution."""


class OutOfDeviceMemory(QueryError):
    """The device allocator refused the statement after admission let it
    through, and no demotion to the spill passes was allowed or possible.
    Carries the statement's accounting snapshot (with the allocator's
    counters under "device_stats"), the program's measurement when one
    exists, and the admission estimate."""

    def __init__(self, message: str, snapshot: dict | None = None,
                 mem_analysis: dict | None = None, est_bytes: int = 0):
        super().__init__(message)
        self.snapshot = snapshot or {}
        self.mem_analysis = mem_analysis
        self.est_bytes = int(est_bytes)


def shape_of(exec_key: str) -> str:
    """The statement shape an exec key names: the plan-cache signature
    without the multi-match join's "#multi" (the feedback store's key)."""
    return exec_key[:-6] if exec_key.endswith("#multi") else exec_key


def segments_per_device(layout) -> int:
    """The port holds every segment on one device."""
    return max(int(layout.nseg), 1)


def effective_limit_bytes(settings, layout=None) -> int:
    """Per-segment device-memory ceiling; 0 = unlimited. The tighter of
    ``vmem_protect_limit_mb``, the resource queue's
    ``resource_queue_memory_mb`` and the calling thread's resource-group
    cap (runtime/resgroup.current_memory_limit_mb), each 0 = none, as in
    the JAX executor: a capped statement spills instead of failing. On a
    card all the segments share, also the card's memory over the
    segments it holds (the JAX executor scales the same way by its
    segments per device), so a statement demoted after an out-of-memory
    error sizes its passes to the card."""
    limit = int(settings.vmem_protect_limit_mb) << 20
    for cap in (int(settings.resource_queue_memory_mb) << 20,
                current_memory_limit_mb() << 20):
        if cap and (not limit or cap < limit):
            limit = cap
    if layout is not None and layout.device.type == "cuda":
        card = torch.cuda.get_device_properties(layout.device).total_memory \
            // segments_per_device(layout)
        limit = min(limit, card) if limit else card
    return limit


class _SpillNeeded(Exception):
    """Admission refused a statement that may spill: raised out of the
    tier loop so the passes start with the loop's tensors released."""


@dataclass
class _ProgramMem:
    """What the executor keeps of a cached program: its compiled estimate
    and the measurement of its first measured launch (None until then)."""

    est_bytes: int
    mem_analysis: dict | None = None


def _nbytes(tensors) -> int:
    return sum(int(t.numel()) * t.element_size() for t in tensors)


def _output_bytes(out: ProgramOutput) -> int:
    return _nbytes([out.sel, *out.cols.values(), *out.valids.values(),
                    *out.flags.values(), *out.metrics.values()])


@dataclass
class Result:
    columns: list[str]
    cols: dict[str, np.ndarray]
    valids: dict[str, np.ndarray | None]
    _order: list[str]
    # storage-representation values (scaled int64 DECIMAL, TEXT codes)
    raw: dict[str, np.ndarray] = field(default_factory=dict)
    flags: dict[str, bool] = field(default_factory=dict)
    metrics: dict[str, np.ndarray] = field(default_factory=dict)
    wall_ms: float = 0.0
    # per-statement instrumentation: tiers_used, wall_ms, stage/compute ms
    stats: dict = field(default_factory=dict)
    # plan-node ordinal -> the exact count the device reported for it (the
    # cap hints' source)
    cap_needs: dict = field(default_factory=dict)

    def __len__(self):
        for c in self._order:
            return len(self.cols[c])
        return 0

    def rows(self) -> list[tuple]:
        out = []
        for i in range(len(self)):
            row = []
            for cid in self._order:
                v = self.valids.get(cid)
                row.append(None if v is not None and not v[i]
                           else self.cols[cid][i])
            out.append(tuple(row))
        return out

    def to_pandas(self):
        import pandas as pd

        data = {}
        names = []
        seen: dict = {}
        for name in self.columns:   # dedupe: two count() outputs must not
            k = seen.get(name, 0)   # collapse into one DataFrame column
            seen[name] = k + 1
            names.append(name if k == 0 else f"{name}_{k}")
        for name, cid in zip(names, self._order):
            col = self.cols[cid]
            v = self.valids.get(cid)
            if v is not None:
                col = np.asarray(col, dtype=object).copy()
                col[~v] = None
            data[name] = col
        return pd.DataFrame(data)


# ---------------------------------------------------------------------------
# run a compiled program: the tier loop, the Gather, the presentation
# ---------------------------------------------------------------------------

def _flag_tensor(out: ProgramOutput, comp: CompileResult, live):
    """Every flag, the Gather's live count and every metric in one int64
    vector, so the host reads them with one copy."""
    parts = [out.flags[n].reshape(1).to(torch.int64) for n in comp.flag_names]
    parts.append(live.reshape(1).to(torch.int64))
    parts += [out.metrics[n].reshape(-1).to(torch.int64)
              for n in comp.metric_names]
    return torch.cat(parts)


def _gather_rows(comp: CompileResult, out: ProgramOutput):
    """-> (cols, valids, sel) of the rows the Gather reads, flattened to
    [1, segments x cap]: segment 0's for a replicated child."""
    take = slice(0, 1) if comp.replicated else slice(None)
    sel = out.sel[take].reshape(1, -1)
    cols = {c.id: out.cols[c.id][take].reshape(1, -1) for c in comp.out_cols}
    valids = {c.id: out.valids[c.id][take].reshape(1, -1)
              for c in comp.out_cols if c.id in out.valids}
    return cols, valids, sel


def gather(comp: CompileResult, out: ProgramOutput, compiler,
           live: int) -> dict:
    """The Gather Motion on the device: -> {col id: (values, valid)} of the
    live rows, merge-ordered when the plan asks for it, then the host
    Limit's OFFSET/LIMIT. ``live`` is the count the host already read."""
    cols, valids, sel = _gather_rows(comp, out)
    cols, valids, sel = sort_ops.compact(cols, valids, sel, live)
    if comp.merge_keys:
        keys = compiler.sort_keys(Batch(cols, valids, sel), comp.merge_keys)
        perm, _, _ = sort_ops.sort_batch(keys, sel, live)
        cols, valids = sort_ops.apply_perm(cols, valids, perm)
    lo, hi = 0, live
    if comp.host_limit is not None:
        limit, offset = comp.host_limit
        lo = min(offset, live)
        hi = live if limit is None else min(live, offset + limit)
    return {c.id: (cols[c.id][0, lo:hi],
                   valids[c.id][0, lo:hi] if c.id in valids else None)
            for c in comp.out_cols}


def _to_host(tensors: dict) -> dict:
    """Every tensor as a numpy array, with one wait for the card: each CUDA
    tensor is copied to pinned memory non_blocking but the last, whose
    blocking copy waits for the stream and so for every copy before it."""
    on_card = [k for k, t in tensors.items() if t.device.type == "cuda"]
    out = {}
    for k, t in tensors.items():
        if t.device.type == "cuda":
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            t = h.copy_(t, non_blocking=k != on_card[-1])
        out[k] = t.numpy()
    return out


def decode(c, data: np.ndarray, dictionary) -> np.ndarray:
    """One output column from its storage form to its presentation: TEXT
    codes via the dictionary (``dictionary(ref)`` -> list), DECIMAL to
    float64, DATE to datetime64; a hidden column stays as it is."""
    if c.hidden:
        return data
    if c.type.kind is T.Kind.TEXT and c.dict_ref is not None:
        d = dictionary(c.dict_ref)
        return np.array([d[x] if 0 <= x < len(d) else None for x in data],
                        dtype=object)
    if c.type.kind is T.Kind.DECIMAL:
        return data / (10.0 ** c.type.scale)
    if c.type.kind is T.Kind.DATE:
        return (np.datetime64("1970-01-01", "D")
                + data.astype("timedelta64[D]"))
    return data


def present(comp: CompileResult, rows: dict, flags: dict, metrics: dict,
            compiler, raw: bool = False) -> Result:
    """Host-side presentation: TEXT/decimal/date decode, Result assembly.
    ``raw`` keeps every column in its storage form (what a spill pass
    captures for the merge program)."""
    tensors = {}
    for cid, (data_t, valid_t) in rows.items():
        tensors[cid] = data_t
        if valid_t is not None:
            tensors[("@v", cid)] = valid_t
    host = _to_host(tensors)
    out_cols, out_valids, raw_cols = {}, {}, {}
    for c in comp.out_cols:
        data = host[c.id]
        valid = host.get(("@v", c.id))
        if valid is None:
            valid = np.ones(len(data), bool)
        raw_cols[c.id] = data
        out_cols[c.id] = data if raw else decode(c, data,
                                                  compiler.dictionary)
        out_valids[c.id] = None if valid.all() else valid
    visible = [c for c in comp.out_cols if not c.hidden]
    return Result(columns=[c.name for c in visible], cols=out_cols,
                  valids=out_valids, _order=[c.id for c in visible],
                  raw=raw_cols, flags=flags, metrics=metrics)


def run_tiers(plan, tables: dict, layout, settings,
              consts: dict | None = None, dictionary=None,
              no_direct: bool = False, cap_overrides: dict | None = None,
              stage=None, admit=None, launch=None, raw: bool = False,
              instrument: bool = False) -> Result:
    """Compile ``plan`` over ``tables`` and run it, retrying on overflow as
    the JAX executor's _run_tiers does: a capacity overflow re-runs at the
    next tier (capacities x4), sized from the exact count where the device
    reported one; a key-packing bounds violation re-runs the same tier
    with that node unpacked; duplicate keys on a unique join's build side
    raise QueryError (the session re-plans with the multi-match join).
    ``no_direct`` builds every join's hash table; ``cap_overrides`` seeds
    the exact-count sizes (the executor's cap hints).

    ``tables`` are the staged tables, or only their shapes when
    ``stage(comp)`` stages them after each compile; ``admit(comp, sig)``
    runs between the compile and the staging and raises to refuse (``sig``
    = the attempt's tier, its cap overrides and its unpacked nodes: what
    names the program), and ``launch(comp, tables)`` runs the program in
    its place (the executor measures first launches there).
    ``instrument`` counts every node's output rows (EXPLAIN ANALYZE);
    ``stats["node_rows"]`` holds each counted node's rows over every
    segment, by ``id`` of the plan node, and an instrumented run adds
    ``stats["node_est_bytes"]``."""
    t0 = time.perf_counter()
    tier = 0
    attempts = 0
    cap_overrides = dict(cap_overrides or {})
    pack_disabled: set = set()
    retried = []               # the flags each re-run attempt raised
    last_err = None
    # tiers grow capacities; a packing violation re-runs the SAME tier, so
    # the attempt bound covers both kinds of retry
    while tier < settings.motion_retry_tiers \
            and attempts < settings.motion_retry_tiers + 4:
        attempts += 1
        # retry-tier boundary: a flag set while the previous attempt ran
        # (cancel, statement timeout) ends the statement here
        interrupt.check_interrupts()
        compiler = Compiler(layout, tables, settings, consts, dictionary,
                            tier=tier, cap_overrides=cap_overrides,
                            pack_disabled=pack_disabled, no_direct=no_direct,
                            instrument=instrument)
        t_comp = time.perf_counter()
        with _trace.span("compile", cat="exec", tier=tier):
            comp = compiler.compile(plan)
        compile_ms = (time.perf_counter() - t_comp) * 1e3
        if admit is not None:
            admit(comp, (tier, tuple(sorted(cap_overrides.items())),
                         tuple(sorted(pack_disabled))))
        staged = stage(comp) if stage is not None else tables
        # the last cancellation point before the launch: once the
        # program is on the device it runs to its end
        faults.check("cancel_before_dispatch")
        interrupt.check_interrupts()
        # the span ends at the host's read of the flags, which waits for
        # the program
        t_disp = time.perf_counter()
        with _trace.span("dispatch", cat="device", tier=tier,
                         est_bytes=comp.est_bytes):
            if faults.check("device_oom"):
                # a faked allocator failure ('skip'): the OOM demotion
                # without exhausting the card
                raise torch.OutOfMemoryError(
                    f"out of memory while allocating {comp.est_bytes} "
                    "bytes per segment (fault injected: device_oom)")
            out = (launch(comp, staged) if launch is not None
                   else comp.program(staged))
            _, _, sel = _gather_rows(comp, out)
            host = _flag_tensor(out, comp, sel.sum()).cpu().numpy()
        dispatch_ms = (time.perf_counter() - t_disp) * 1e3
        nflags = len(comp.flag_names)
        flags = {n: bool(v) for n, v in zip(comp.flag_names, host[:nflags])}
        live = int(host[nflags])
        metrics, i = {}, nflags + 1
        for n in comp.metric_names:
            k = out.metrics[n].numel()
            metrics[n] = host[i:i + k]
            i += k
        if any(v for n, v in flags.items() if n.startswith("join_dup")):
            raise QueryError(
                "hash join build side has duplicate keys; only unique-key "
                "(PK-FK) hash joins are supported in this version")
        overflow = [n for n, v in flags.items() if v]
        if not overflow:
            t_fetch = time.perf_counter()
            with _trace.span("fetch", cat="device", rows=live):
                res = present(comp, gather(comp, out, compiler, live),
                              flags, metrics, compiler, raw=raw)
            fetch_ms = (time.perf_counter() - t_fetch) * 1e3
            res.wall_ms = (time.perf_counter() - t0) * 1e3
            res.cap_needs = {nid: int(metrics[m].max())
                             for nid, m in comp.flag_caps.values()
                             if m in metrics}
            res.stats = {"tiers_used": tier + 1, "attempts": attempts,
                         "retried": retried, "wall_ms": res.wall_ms,
                         "fused_gate": comp.uses_fused,
                         "segments": layout.nseg,
                         "metrics": {k: int(v.sum()) if k.startswith("nrows_")
                                     else int(v.max())
                                     for k, v in metrics.items()},
                         # per-node actual rows over every segment: the
                         # Filter counters of every run, every node's when
                         # instrumented (the feedback store's input)
                         "node_rows": {comp.node_rows[k]: int(v.sum())
                                       for k, v in metrics.items()
                                       if k in comp.node_rows},
                         "mem": {"est_bytes": int(comp.est_bytes)},
                         "compile_ms": compile_ms, "dispatch_ms": dispatch_ms,
                         "fetch_ms": fetch_ms}
            if instrument:
                # the per-node Memory annotation of EXPLAIN ANALYZE
                res.stats["node_est_bytes"] = dict(comp.node_est_bytes)
            return res
        retried.append(overflow)
        # a packing violation re-runs the SAME tier with that node
        # unpacked; an overflow that reports its exact need sizes the retry
        # from it; an overflowed compaction re-runs the SAME tier, and any
        # other capacity overflow grows every capacity 4x
        capacity_over = []
        for name in overflow:
            if name.startswith("pack_overflow"):
                pack_disabled.add(comp.flag_packs[name])
                continue
            capacity_over.append(name)
            hint = comp.flag_caps.get(name)
            if hint is not None:
                nid, metric = hint
                need = int(metrics[metric].max())
                cap_overrides[nid] = need + max(need // 16, 64)
        if [n for n in capacity_over
                if not n.startswith("gather_compact_overflow")]:
            tier += 1
        last_err = f"capacity overflow in {overflow} at tier {tier}"
        del out
    raise QueryError(f"query exceeded capacity tiers: {last_err}")


# ---------------------------------------------------------------------------
# the session's executor: admission, staging from the store, spill, hints
# ---------------------------------------------------------------------------

# the block cache's counters a statement's staging moves: its scan I/O
SCAN_COUNTERS = ("scan_files_read", "scan_bytes_decoded", "scan_cache_hit",
                 "scan_cache_miss", "scan_cache_evict")


class Executor:
    def __init__(self, catalog, store, layout, settings):
        self.catalog = catalog
        self.store = store
        self.layout = layout
        self.nseg = layout.nseg
        self.settings = settings
        # staged device inputs live in the store's byte-accounted LRU
        # registry (storage/blockcache.py), evicted by recency against the
        # card's budget (scan_cache_limit_mb on the CPU): (table, column,
        # capacity, version, direct segment, prune predicates, child
        # tables) -> staged [nseg, cap] tensor; column "@present" -> the
        # live-slot mask. A pruned scan is staged under its own key beside
        # the unpruned one
        self._stage_cache = store.blockcache.cache("stage")
        # join-driven partition selection, the registry's ``dyn`` member
        # tagged with its manifest version: (table, child tables, source,
        # version) -> the kept children
        self._dyn_prune_cache = store.blockcache.cache("dyn")
        # cap hints: plan-cache key -> {plan-node ordinal: capacity}, the
        # exact counts of the statement's last run (pow2-bucketed), LRU
        # within plan_cache_size
        self._cap_hints: OrderedDict = lockdebug.shared(
            OrderedDict(), "executor._cap_hints")
        # the stage cache, the cap hints and the cached programs are
        # shared by every thread's statements (and the batch server's
        # stager): their reads and writes, and a table's cold staging, run
        # under this lock (named for the lock-order witness)
        self._cache_mu = lockdebug.named(threading.RLock(),
                                         "executor._cache_mu")
        # the cached programs (measured admission): (plan-cache key,
        # store version, tier, cap overrides, no_direct, instrument, the
        # shape's calibration version) -> _ProgramMem, LRU within
        # plan_cache_size and dropped with their statement's cap hints
        self._programs: OrderedDict = lockdebug.shared(
            OrderedDict(), "executor._plan_cache")
        self._spill_dir: str | None = None
        # the feedback store (planner/feedback.py), wired by the owning
        # Database: a shape's calibration version joins its programs' key
        # (a re-planned shape is another program); each shape's measured
        # bytes and cap hints are mirrored there. A statement whose hints
        # left this executor (its bound plan was evicted) is seeded from
        # the store's, and a program not yet measured (a shape re-planned
        # by a promotion) is admitted by the shape's measured bytes
        self.feedback = None

    # ---- lifetime ------------------------------------------------------
    def default_spill_dir(self) -> str:
        """This executor's own spill directory, made on first use and
        removed by ``close`` (or when the executor is collected)."""
        if self._spill_dir is None:
            self._spill_dir = tempfile.mkdtemp(prefix="gg-spill-")
            self._spill_dir_rm = weakref.finalize(
                self, shutil.rmtree, self._spill_dir, ignore_errors=True)
        return self._spill_dir

    def close(self) -> None:
        with self._cache_mu:
            self._stage_cache.clear()
            self._cap_hints.clear()
            self._programs.clear()
        if self._spill_dir is not None:
            self._spill_dir_rm()
            self._spill_dir = None

    def invalidate_table(self, table: str) -> None:
        """Drop the staged inputs of ``table`` (a partition child names its
        parent): DROP TABLE, DROP PARTITION, CREATE INDEX and the spill
        release."""
        base = table.split("#", 1)[0]
        with self._cache_mu:
            self._stage_cache.drop(lambda k: k[0].split("#", 1)[0] == base)

    def forget(self, cache_key) -> None:
        """Drop a statement's cap hints and its cached programs (its bound
        plan left the cache)."""
        with self._cache_mu:
            self._cap_hints.pop(cache_key, None)
            for k in [k for k in self._programs if k[0] == cache_key]:
                del self._programs[k]

    def _dictionary(self, ref):
        return self.store.dictionary(*ref).values

    # ---- run -----------------------------------------------------------
    def run(self, plan, consts: dict, cache_key=None, raw: bool = False,
            scan_cap_override: dict | None = None,
            row_ranges: dict | None = None, aux_tables: dict | None = None,
            allow_spill: bool = True, no_direct: bool = False,
            prefetcher=None, instrument: bool = False) -> Result:
        """Run one planned statement. ``cache_key`` (the plan cache's key)
        seeds and records the cap hints. The spill passes drive the rest:
        ``scan_cap_override`` (table -> chunk rows), ``row_ranges`` (table
        -> the (lo, hi) slice of each segment's rows this pass reads),
        ``aux_tables`` (name -> (cols, valids) of captured host rows),
        ``allow_spill`` False inside a pass, ``prefetcher`` building the
        next pass's host buffers. ``instrument`` (EXPLAIN ANALYZE) counts
        every node's rows, through the spill passes and an OOM demotion
        too; an instrumented program is a program of its own: it is
        measured and admitted apart from the classic one.

        The statement holds an entry in the runaway tracker for the whole
        run (nested spill passes share it) and marks its device work for
        the measurement of first launches (memaccount.device_work)."""
        TRACKER.enter()
        try:
            with memaccount.device_work():
                return self._run(plan, consts, cache_key, raw,
                                 scan_cap_override, row_ranges, aux_tables,
                                 allow_spill, no_direct, prefetcher,
                                 instrument)
        finally:
            TRACKER.release()

    def _run(self, plan, consts, cache_key, raw, scan_cap_override,
             row_ranges, aux_tables, allow_spill, no_direct,
             prefetcher, instrument) -> Result:
        t0 = time.perf_counter()
        snapshot = self.store.manifest.snapshot()
        version = snapshot.get("version", 0)
        overrides = scan_cap_override or {}
        ranges = row_ranges or {}
        aux = aux_tables or {}
        # staged inputs and store cache entries of other manifest versions
        # are unreachable: free them (a staged CUDA tensor goes back to the
        # allocator once no statement holds it)
        with _trace.span("shapes", cat="stage"):
            self.store.blockcache.invalidate_versions(version)
            shapes = self.table_shapes(plan, snapshot, overrides, aux,
                                       (consts or {}).get("@params@"))
        with self._cache_mu:
            hints = dict(self._cap_hints.get(cache_key) or {})
            if hints:
                self._cap_hints.move_to_end(cache_key)
        if not hints and cache_key is not None and self.feedback is not None:
            # the store's copy of the shape's hints: a statement whose
            # bound plan left the cache sizes its capacities right on its
            # first launch instead of overflowing again
            hints = dict(self.feedback.caps(cache_key))
        # the store records the classic program of a statement: an
        # instrumented run is not recorded as it
        fb_key = cache_key if self.feedback is not None \
            and not instrument else None
        fbv = (self.feedback.version_for(shape_of(cache_key))
               if self.feedback is not None and cache_key is not None
               else 0)
        consts = self._with_params(consts)
        # a brownout scales the ceiling down: borderline statements take
        # the spill passes instead of racing a pressured allocator
        limit = _overload.CONTROLLER.scaled_vmem(
            effective_limit_bytes(self.settings, self.layout))
        # a cached program: the plan-cache key's statement at its hints,
        # no spill override in flight
        cacheable = cache_key is not None and not overrides and not ranges \
            and not aux
        hint_sig = tuple(sorted(hints.items()))
        mem_on = bool(self.settings.mem_accounting_enabled)
        last: dict = {}
        stage_s = [0.0]

        def admit(comp, sig):
            tier, caps, packs = sig
            prog = None
            if cacheable and caps == hint_sig and not packs:
                # an instrumented program is keyed apart: its counters
                # make it another program than the classic one
                prog = self._program((cache_key, version, tier, caps,
                                      no_direct, instrument, fbv), comp)
            admit_bytes, measured = self._admission_bytes(comp, prog,
                                                          fb_key)
            last.update(comp=comp, prog=prog, admit_bytes=admit_bytes,
                        measured=measured)
            if limit and admit_bytes > limit:
                if allow_spill:
                    raise _SpillNeeded
                raise AdmissionError(
                    f"query would allocate ~{admit_bytes >> 20} MB per "
                    f"segment, above the {limit >> 20} MB memory ceiling "
                    "(raise vmem_protect_limit_mb or reduce the data)")
            # mid-flight enforcement: ledger what this statement will hold
            # (the spill decision made), run the red-zone scan, and take a
            # cancellation aimed at this statement
            TRACKER.reprice(admit_bytes,
                            int(self.settings.vmem_global_limit_mb) << 20,
                            float(self.settings.runaway_red_zone),
                            measured=measured)
            TRACKER.check()
            acct = memaccount.ACCOUNTS.current()
            if acct is not None:
                acct.set_device(prog.mem_analysis if prog else None,
                                comp.est_bytes)

        def launch(comp, tables):
            prog = last.get("prog")
            if prog is None or prog.mem_analysis is not None or not mem_on:
                return comp.program(tables)
            return self._measure(comp, prog, tables, consts, fb_key)

        io0 = {k: counters.get(k) for k in SCAN_COUNTERS}

        def stage(comp):
            t = time.perf_counter()
            with _trace.span("stage", cat="stage", tables=len(shapes)):
                tables = self._stage(plan, snapshot, shapes, ranges, aux,
                                     prefetcher)
            stage_s[0] += time.perf_counter() - t
            return tables

        oom_msg = None
        try:
            res = run_tiers(plan, shapes, self.layout, self.settings, consts,
                            self._dictionary, no_direct=no_direct,
                            cap_overrides=hints, stage=stage, admit=admit,
                            launch=launch, raw=raw, instrument=instrument)
        except _SpillNeeded:
            res = None
        except torch.OutOfMemoryError as e:
            # only the message leaves this block: the traceback's frames
            # hold the failed attempt's tensors until it ends
            res, oom_msg = None, str(e)
        if res is None:
            comp = last.get("comp")
            est = comp.est_bytes if comp is not None else 0
            if oom_msg is not None:
                prog = last.get("prog")
                return self._handle_oom(
                    oom_msg, est, prog.mem_analysis if prog else None, plan,
                    consts, raw, allow_spill, t0, instrument)
            from greengage_tpu_torch.exec import spill

            try:
                return self._spill_fallback(plan, consts, raw, t0,
                                            instrument)
            except spill.NotSpillable:
                raise QueryError(
                    f"query would allocate ~{est >> 20} MB per segment, "
                    f"above vmem_protect_limit_mb="
                    f"{self.settings.vmem_protect_limit_mb}, and its shape "
                    "is not spillable (no partial-aggregate cut or sort "
                    "over a single-scan probe table)") from None
        if cache_key is not None and res.cap_needs:
            self._record_hints(cache_key, res.cap_needs)
        res.wall_ms = (time.perf_counter() - t0) * 1e3
        res.stats["stage_ms"] = stage_s[0] * 1e3
        res.stats["wall_ms"] = res.wall_ms
        res.stats.update(self.scan_stats(shapes))
        res.stats["scan_io"] = {k: counters.get(k) - io0[k]
                                for k in SCAN_COUNTERS}
        res.stats["mem"] = self._mem_stats(
            res.stats["mem"]["est_bytes"], last["admit_bytes"],
            last["measured"], last["prog"])
        histograms.observe("stage_ms", res.stats["stage_ms"])
        histograms.observe("dispatch_ms", res.stats["dispatch_ms"])
        histograms.observe("fetch_ms", res.stats["fetch_ms"])
        histograms.observe("compile_latency_ms", res.stats["compile_ms"])
        return res

    def run_single(self, plan, consts, raw=False, scan_cap_override=None,
                   row_ranges=None, aux_tables=None, no_direct=False,
                   prefetcher=None, instrument=False) -> Result:
        """One spill pass: no recursive spilling, no cap hints."""
        return self.run(plan, consts, cache_key=None, raw=raw,
                        scan_cap_override=scan_cap_override,
                        row_ranges=row_ranges, aux_tables=aux_tables,
                        allow_spill=False, no_direct=no_direct,
                        prefetcher=prefetcher, instrument=instrument)

    def compile(self, plan, consts, scan_cap_override=None, aux_tables=None,
                no_direct: bool = True) -> CompileResult:
        """Compile ``plan`` at tier 0 without staging or running it: the
        spill paths size their passes from its ``est_bytes``."""
        shapes = self.table_shapes(plan, self.store.manifest.snapshot(),
                                   scan_cap_override or {}, aux_tables or {},
                                   (consts or {}).get("@params@"))
        return Compiler(self.layout, shapes, self.settings, consts,
                        self._dictionary, no_direct=no_direct).compile(plan)

    def _record_hints(self, cache_key, needs: dict) -> None:
        with self._cache_mu:
            rec = self._cap_hints.setdefault(cache_key, {})
            self._cap_hints.move_to_end(cache_key)
            for nid, need in needs.items():
                # pow2 bucket: a small drift in the data re-records the
                # same hint
                rec[nid] = _pow2(need + max(need // 16, 64))
            bound = max(int(self.settings.plan_cache_size), 1)
            while len(self._cap_hints) > bound:
                self._cap_hints.popitem(last=False)
            rec = dict(rec)
        if self.feedback is not None:
            self.feedback.note_caps(cache_key, rec)

    def _with_params(self, consts: dict) -> dict:
        """The statement's hoisted literal values (sql/paramize.py) as one
        int64 tensor on the device under "@params@rt" (float64 values by
        bit pattern): one pinned, non_blocking copy per run."""
        pvec = (consts or {}).get("@params@")
        if pvec is None or not pvec.values:
            return consts
        host = staging.host_buffer(len(pvec.values), np.int64,
                                   self.layout.device)
        self._param_values(pvec, host.numpy())
        out = dict(consts)
        out["@params@rt"] = host.to(self.layout.device, non_blocking=True)
        return out

    @staticmethod
    def _param_values(pvec, arr) -> None:
        """A parameter vector's values into an int64 row (float64 values
        by bit pattern), as the program reads "@params@rt"."""
        for i, (v, t) in enumerate(zip(pvec.values, pvec.types)):
            arr[i] = (np.float64(v).view(np.int64)
                      if t.kind is T.Kind.FLOAT64 else int(v))

    # ---- batched serving (exec/batchserve.py) ---------------------------
    # One program serves a whole admission window of same-shape
    # statements: their hoisted parameter vectors stack along a leading
    # member axis and the batched program (compile.py batch_width) runs
    # once over the shared staged tables. Split into prepare (compile,
    # admit, stage) and dispatch (device) halves so the serving pipeline
    # stages batch k+1 while batch k runs.

    def prepare_batch(self, plan, consts, cache_key, pvec_rows):
        """Build the width-bucketed batched program, admit it and stage
        its (shared) tables and the stacked parameters. -> (comp, tables,
        compiler, compiled); ``compiled`` is always True: the port keeps no
        program cache, so every batch compiles (a closure over the plan,
        no device work). ``compiler.host_params`` keeps the members'
        parameter rows on the host for the demux. Raises BatchFallback
        when the batch cannot run as one program."""
        width = len(pvec_rows)
        bucket = _pow2(max(width, 1))
        snapshot = self.store.manifest.snapshot()
        with self._cache_mu:
            hints = dict(self._cap_hints.get(cache_key) or {})
        # parameter-valued prune predicates are DROPPED (no parameter
        # vector): pruning by one member's values would starve its
        # batch-mates of blocks their rows live in; value-pinned ones are
        # every member's and stay
        shapes = self.table_shapes(plan, snapshot)
        # members padded to the bucket with the last one's values
        padded = list(pvec_rows) + [pvec_rows[-1]] * (bucket - width)
        nparams = len(padded[0].values)
        if not nparams:
            raise BatchFallback("a batched program needs parameters")
        host = staging.host_buffer(bucket * nparams, np.int64,
                                   self.layout.device)
        rows = host.numpy().reshape(bucket, nparams)
        for m, pv in enumerate(padded):
            self._param_values(pv, rows[m])
        bconsts = dict(consts)
        bconsts["@params@rt"] = host.view(bucket, nparams).to(
            self.layout.device, non_blocking=True)
        # batched programs never take the fused kernel: it has no vmap
        # batching rule (nor has the Pallas kernel in the JAX package)
        compiler = Compiler(self.layout, shapes, self.settings, bconsts,
                            self._dictionary, tier=0, cap_overrides=hints,
                            batch_width=bucket)
        try:
            with _trace.span("compile", cat="exec", batch_width=bucket):
                comp = compiler.compile(plan)
        except (NotImplementedError, TypeError, ValueError) as e:
            raise BatchFallback(f"batched program not built: {e}") from None
        compiler.host_params = rows
        # admission, as the JAX executor does: each width bucket is keyed
        # f"{cache_key}@w{bucket}" (est_bytes already counts the bucket's
        # members), its first launch is measured (dispatch_batch) and a
        # warm bucket is admitted by its measured bytes
        if cache_key is not None:
            comp.fb_key = f"{cache_key}@w{bucket}"
            fbv = (self.feedback.version_for(shape_of(cache_key))
                   if self.feedback is not None else 0)
            comp.batch_prog = self._program(
                (comp.fb_key, snapshot.get("version", 0),
                 tuple(sorted(hints.items())), fbv), comp)
        admit_bytes, _measured = self._admission_bytes(
            comp, comp.batch_prog,
            comp.fb_key if self.feedback is not None else None)
        limit = effective_limit_bytes(self.settings, self.layout)
        if limit and admit_bytes > limit:
            raise BatchFallback(
                f"batched program would hold ~{admit_bytes >> 20} MB "
                f"per segment at width {bucket}, above the "
                f"{limit >> 20} MB ceiling")
        comp.batch_params = bconsts["@params@rt"]
        # staging as for one statement, over the shapes above
        with _trace.span("stage", cat="stage", tables=len(shapes),
                         batch_width=width, batch_bucket=bucket), \
                memaccount.device_work():
            tables = self._stage(plan, snapshot, shapes, {}, {}, None)
        return comp, tables, compiler, True

    def dispatch_batch(self, comp: CompileResult, tables) -> dict:
        """Run a prepared batched program and copy every member's outputs,
        flags and metrics to the host: one wait for the card. The serving
        pipeline's device stage — it runs on the dispatcher thread with NO
        statement context, so a member's cancellation never aborts its
        batch-mates (members are masked at demux). -> host arrays by name:
        ("c", id), ("v", id), "sel", ("f", flag), ("m", metric)."""
        with _trace.span("dispatch", cat="device",
                         batch_width=comp.batch_width,
                         est_bytes=comp.est_bytes) as sp, \
                memaccount.device_work():
            faults.check("batch_dispatch")
            err = None
            prog = comp.batch_prog
            try:
                if prog is not None and prog.mem_analysis is None \
                        and bool(self.settings.mem_accounting_enabled):
                    # a bucket's first launch, measured as a classic
                    # program's is (_measure)
                    out = self._measure(
                        comp, prog, tables,
                        {"@params@rt": comp.batch_params},
                        comp.fb_key if self.feedback is not None else None)
                else:
                    out = comp.program(tables)
            except RuntimeError as e:
                # a shape whose operators the batched program cannot run
                # (vmap refuses the op), or the card's allocator: only
                # the message leaves this block (an OOM's frames hold
                # the attempt's tensors)
                err = f"{type(e).__name__}: {e}"
            if err is not None:
                raise BatchFallback(f"batched program failed: {err}")
            tensors = {"sel": out.sel}
            tensors.update({("c", k): v for k, v in out.cols.items()})
            tensors.update({("v", k): v for k, v in out.valids.items()})
            tensors.update({("f", k): v.reshape(-1) for k, v in
                            out.flags.items()})
            tensors.update({("m", k): v for k, v in out.metrics.items()})
            del out
            host = _to_host(tensors)
            _trace.annotate(sp, bytes=int(sum(a.nbytes
                                              for a in host.values())))
        return host

    def batch_overflowed(self, comp: CompileResult, host) -> list[str]:
        """Flag names any member raised — capacity overflow, packing
        bounds, duplicate join keys. A batched program never retries in
        place (members' capacity needs differ); any flag sends every
        member down the classic path, whose tiers handle it."""
        return [n for n in comp.flag_names if host[("f", n)].any()]

    def demux_batch(self, comp: CompileResult, host, member: int,
                    compiler) -> Result:
        """One member's Result from a batch's host copy: its slice along
        the member axis, finished as a classic statement's Gather is
        (compaction, merge keys, LIMIT/OFFSET, decode), on the host."""
        with _trace.span("finalize", cat="host", member=member):
            hc = compiler.host_copy(compiler.host_params[member])
            sel = torch.from_numpy(host["sel"][member])
            out = ProgramOutput(
                {c.id: torch.from_numpy(host[("c", c.id)][member])
                 for c in comp.out_cols},
                {c.id: torch.from_numpy(host[("v", c.id)][member])
                 for c in comp.out_cols if ("v", c.id) in host},
                sel, {}, {})
            _, _, gsel = _gather_rows(comp, out)
            live = int(gsel.sum())
            flags = {n: bool(host[("f", n)][member])
                     for n in comp.flag_names}
            metrics = {n: host[("m", n)][member] for n in comp.metric_names}
            res = present(comp, gather(comp, out, hc, live), flags, metrics,
                          hc)
        res.stats = {"mem": {"est_bytes": int(comp.est_bytes)}}
        return res

    def run_batch(self, plan, consts, cache_key, pvec_rows) -> list[Result]:
        """Prepare, dispatch and demux one batch on the calling thread (the
        test surface; the serving pipeline calls the halves from its own
        threads). Raises BatchFallback when the batch must run serially."""
        comp, tables, compiler, compiled = self.prepare_batch(
            plan, consts, cache_key, pvec_rows)
        host = self.dispatch_batch(comp, tables)
        over = self.batch_overflowed(comp, host)
        if over:
            raise BatchFallback(f"overflow flags {over} at width "
                                f"{len(pvec_rows)}")
        out = []
        for m in range(len(pvec_rows)):
            res = self.demux_batch(comp, host, m, compiler)
            res.stats.update(batched=True, batch_width=len(pvec_rows),
                             batch_bucket=comp.batch_width,
                             compiled=compiled, segments=self.nseg)
            out.append(res)
        return out

    # ---- measured memory accounting (runtime/memaccount.py) -------------
    def _program(self, key, comp) -> _ProgramMem:
        """The cached program under ``key`` (made on its first run, a
        ``program_cache_miss``; a ``program_cache_hit`` after), moved to
        the LRU's end."""
        with self._cache_mu:
            prog = self._programs.get(key)
            hit = prog is not None
            if hit:
                self._programs.move_to_end(key)
            else:
                prog = self._programs[key] = _ProgramMem(int(comp.est_bytes))
                bound = max(int(self.settings.plan_cache_size), 1)
                while len(self._programs) > bound:
                    self._programs.popitem(last=False)
        counters.inc("program_cache_hit" if hit else "program_cache_miss")
        return prog

    def _measure(self, comp, prog: _ProgramMem, tables, consts,
                 fb_key=None):
        """Launch a cached program for the first time, measured: its staged
        inputs (tables and parameters), its outputs, and the allocator's
        peak above what was allocated before the launch less the outputs
        (the peak holds them), so the three sum to the inputs plus the
        launch's growth. Kept only when no other statement's device work
        ran beside it; otherwise the program stays unmeasured until a
        later run. With ``fb_key`` the measurement also goes to the
        feedback store under that shape, and the ``mem_est_error_pct``
        gauge compares it with the store's earlier measurement of the
        shape when there is one (the prediction), else with the
        estimate. -> the program's output."""
        dev = self.layout.device
        epoch = memaccount.exclusive_epoch()
        if epoch is None:
            return comp.program(tables)
        base = memaccount.peak_begin(dev)
        out = comp.program(tables)
        peak = memaccount.peak_read(dev) if base is not None else None
        if not memaccount.still_exclusive(epoch):
            return out
        inputs = [t for td in tables.values()
                  for t in (*td.cols.values(), td.present)]
        params = (consts or {}).get("@params@rt")
        if params is not None:
            inputs.append(params)
        out_bytes = _output_bytes(out)
        temp = (max(peak - base - out_bytes, 0)
                if base is not None and peak is not None else 0)
        analysis = {"argument_bytes": _nbytes(inputs),
                    "output_bytes": out_bytes, "temp_bytes": temp}
        with self._cache_mu:
            if prog.mem_analysis is not None:
                return out
            prog.mem_analysis = analysis
        counters.inc("mem_analysis_runs")
        total = sum(analysis.values())
        histograms.observe("executable_mem_mb", total / 1e6,
                           buckets=DEFAULT_BUCKETS_MB)
        # the measurement covers every segment on the card: compare it
        # with the estimate of those segments, or with the store's
        # prediction once the shape was measured before
        est_dev = comp.est_bytes * segments_per_device(self.layout)
        pred = (self.feedback.measured_bytes(fb_key)
                if fb_key is not None else None)
        if pred:
            counters.set("mem_est_error_pct",
                         int(round(100.0 * (total - pred) / pred)))
        elif est_dev > 0:
            counters.set("mem_est_error_pct",
                         int(round(100.0 * (total - est_dev) / est_dev)))
        if fb_key is not None:
            # only a measurement with a peak reading admits (as the
            # program's own does in _admission_bytes)
            self.feedback.note_measured(fb_key, total, est_dev,
                                        admits=temp > 0)
        acct = memaccount.ACCOUNTS.current()
        if acct is not None:
            acct.set_device(analysis, comp.est_bytes)
        return out

    def _admission_bytes(self, comp, prog: _ProgramMem | None,
                         fb_key=None) -> tuple[int, bool]:
        """Bytes admission and the runaway ledger charge for this program
        -> (bytes per segment, measured?). The measured bytes once the
        program was measured and the card reported a peak (temp_bytes > 0;
        an allocator to read: device_memory_stats()); a program not yet
        measured, of a classic statement (``fb_key``) whose shape was
        measured before, is admitted by the feedback store's measurement
        of the shape (a promotion re-plans a shape into a new program),
        as in the JAX executor, scaled up by the two programs' estimates
        where this one is estimated larger (a retry tier, a multi-match
        re-plan: the JAX executor reads each program's own analysis
        before it runs); else the compiled estimate. A CPU device
        has no allocator to read, so the estimate governs there, as on the
        JAX CPU backend."""
        ma = prog.mem_analysis if prog is not None else None
        on_card = bool(self.settings.mem_accounting_enabled) \
            and memaccount.device_memory_stats() is not None
        per_dev = segments_per_device(self.layout)
        if ma and on_card and ma["temp_bytes"] > 0:
            measured = sum(ma.values()) // per_dev
            if measured > 0:
                counters.inc("admission_measured_total")
                return measured, True
        if ma is None and on_card and fb_key is not None:
            mtot = self.feedback.measured_bytes(fb_key, admitting=True)
            if mtot and int(mtot) // per_dev > 0:
                # the shape's measurement is a sibling program's (the run
                # before a promotion, a first run at other capacities): a
                # program estimated larger than that one (a retry tier's
                # x4 capacities, a multi-match re-plan) is charged the
                # measurement scaled up by the two estimates, never less
                est_then = self.feedback.measured_est_bytes(fb_key)
                est_now = int(comp.est_bytes) * per_dev
                if est_then and est_now > est_then:
                    mtot = int(mtot) * est_now // est_then
                counters.inc("admission_measured_total")
                counters.inc("admission_measured_feedback_total")
                return int(mtot) // per_dev, True
        counters.inc("admission_estimated_total")
        return int(comp.est_bytes), False

    def _mem_stats(self, est_bytes: int, admit_bytes: int, measured: bool,
                   prog: _ProgramMem | None) -> dict:
        """The Result.stats["mem"] block: the estimate, what admission
        charged and by which, the program's measurement, the allocator's
        counters (on a card) and the statement's owner totals."""
        out = {"est_bytes": int(est_bytes), "admitted_bytes": int(admit_bytes),
               "admitted_by": "measured" if measured else "estimate",
               "measured": (dict(prog.mem_analysis)
                            if prog is not None and prog.mem_analysis
                            else None)}
        dstats = memaccount.device_memory_stats()
        if dstats is not None:
            out["device_bytes_in_use"] = dstats["bytes_in_use"]
            out["device_peak_bytes_in_use"] = dstats["peak_bytes_in_use"]
        acct = memaccount.ACCOUNTS.current()
        if acct is not None:
            out["owners"] = acct.owner_totals()
        return out

    # ---- spill and out-of-memory ---------------------------------------
    def _release_for_spill(self, plan) -> None:
        """Drop the cached whole columns of the tables a spilling statement
        reads, and on a card hand the allocator's free blocks back, so the
        passes run without them."""
        for table in collect_scans(plan):
            self.invalidate_table(table)
        if self.layout.device.type == "cuda":
            torch.cuda.empty_cache()

    def _spill_fallback(self, plan, consts, raw, t0,
                        instrument=False) -> Result:
        """The spill paths, shared by the admission refusal and the OOM
        demotion: partial-aggregate passes first, then window-partition
        passes over the PARTITION BY hash space, then the external-merge
        sort. Raises spill.NotSpillable through when no shape applies.
        ``instrument`` sums every pass's per-node rows onto the original
        plan's nodes."""
        from greengage_tpu_torch.exec import spill

        self._release_for_spill(plan)
        try:
            res, npasses = spill.spill_run(self, plan, consts, raw,
                                           instrument)
        except spill.NotSpillable:
            try:
                res, npasses = spill.spill_window_run(self, plan, consts,
                                                      raw, instrument)
            except spill.NotSpillable:
                res, npasses = spill.spill_sort_run(self, plan, consts, raw,
                                                    instrument)
        res.stats = dict(res.stats or {})
        if not instrument:
            # outside EXPLAIN ANALYZE a spilled result's counters cover one
            # pass (or the merge program's clones), not the statement:
            # the feedback loop reads the exact row count alone (a sum
            # over the passes would count each pass's whole tables again)
            res.stats.pop("node_rows", None)
        res.stats["spill_passes"] = npasses
        res.wall_ms = (time.perf_counter() - t0) * 1e3
        res.stats["wall_ms"] = res.wall_ms
        return res

    def _handle_oom(self, msg, est_bytes, mem_analysis, plan, consts, raw,
                    allow_spill, t0, instrument=False) -> Result:
        """The allocator refused the statement: build the typed
        OutOfDeviceMemory (the statement's accounting snapshot with the
        allocator's counters, the program's measurement), then demote to
        the spill path once when allowed (``oom_spill_retry``), else
        raise it."""
        counters.inc("oom_events")
        acct = memaccount.ACCOUNTS.current()
        snap = acct.snapshot() if acct is not None else {}
        snap["device_stats"] = memaccount.device_memory_stats()
        oom = OutOfDeviceMemory(
            f"out of device memory (estimated ~{est_bytes >> 20} MB per "
            f"segment): {msg}", snapshot=snap, mem_analysis=mem_analysis,
            est_bytes=est_bytes)
        if allow_spill and bool(self.settings.oom_spill_retry):
            from greengage_tpu_torch.exec import spill

            try:
                res = self._spill_fallback(plan, consts, raw, t0, instrument)
            except spill.NotSpillable:
                raise oom from None
            counters.inc("oom_spill_retries")
            res.stats["oom_demoted"] = True
            return res
        raise oom

    # ---- staging -------------------------------------------------------
    def staged_columns(self, plan, snapshot, aux: dict | None = None) -> dict:
        """table -> the staged column names a plan's scans read: storage
        columns and the "@v:" NULL mask of each that has NULLs (in any
        child of a partitioned parent)."""
        aux = aux or {}
        out = {}
        for table, spec in sorted(collect_scans(plan).items()):
            want = []
            for c in sorted(spec.cols):
                want.append(c)
                if table in aux:
                    if aux[table][1].get(c) is not None:
                        want.append(VALID_PREFIX + c)
                elif self.store.has_nulls(table, c, snapshot):
                    want.append(VALID_PREFIX + c)
            out[table] = want
        return out

    @staticmethod
    def _resolve_prune(prune, pvec):
        """Substitute hoisted-parameter operands in pushed zone-map
        predicates with the statement's CURRENT values
        (sql/paramize.resolve_param_value): pruning stays value-exact
        while the bound plan stays value-generic. Without a parameter
        vector (a batch) such a predicate is dropped."""
        if not prune or not any(isinstance(v, E.Expr) for _, _, v in prune):
            return prune
        from greengage_tpu_torch.sql.paramize import resolve_param_value

        out = []
        for col, op, v in prune:
            if isinstance(v, E.Expr):
                if pvec is None:
                    continue   # no vector bound: skip only this predicate
                val = resolve_param_value(v, pvec)
                v = (float(val) if isinstance(val, (float, np.floating))
                     else int(val))
            out.append((col, op, v))
        return tuple(out)

    def table_shapes(self, plan, snapshot, overrides: dict | None = None,
                     aux: dict | None = None, pvec=None) -> dict:
        """table -> TableShape of every scanned table, with staging's
        decisions: the direct-dispatch segment (read alone, as the JAX
        executor reads it), the zone-map predicates (hoisted values
        resolved from ``pvec``), and a partitioned parent's children after
        the join-driven selector (_dyn_pruned_parts). The staged capacity
        is the largest segment's rows as the read returns them (visible
        rows of the kept children, kept blocks; a spill chunk caps it);
        the reference capacity is the JAX compiler's: the power of two of
        the manifest's rows of the statically kept children (of the pinned
        segment under a direct dispatch), the chunk exactly, or an aux
        table's even split."""
        overrides, aux = overrides or {}, aux or {}
        out = {}
        for table, spec in collect_scans(plan).items():
            if table in aux:
                cols0 = aux[table][0]
                n = len(next(iter(cols0.values()))) if cols0 else 0
                cap = max(-(-max(n, 1) // self.nseg), 1)
                out[table] = TableShape(table, cap, cap)
                continue
            ds = spec.direct
            if ds is not None and not 0 <= ds < self.nseg:
                ds = None
            prune = self._resolve_prune(spec.staged_prune, pvec) or None
            parts, dyn_stat = spec.parts, None
            dyn = spec.staged_dyn
            if parts is not None and dyn is not None:
                dyn = (dyn[0], self._resolve_prune(dyn[1], pvec) or (),
                       dyn[2])
                parts, dyn_stat = self._dyn_pruned_parts(table, parts, dyn,
                                                         snapshot)
            # the reference capacity counts the manifest's rows, deleted
            # ones too, of the statically kept children, as the JAX
            # compiler does; the staged one the rows the reads return
            counts = self.store.segment_rowcounts(table, snapshot,
                                                  spec.parts)
            live = self.store.pruned_rowcounts(table, snapshot, prune, parts)
            zone = None
            if prune:
                kept = total = 0
                for name in (parts if parts is not None else (table,)):
                    for seg in ([ds] if ds is not None
                                else range(self.nseg)):
                        plan_s = self.store.prune_plan(name, seg, snapshot,
                                                       prune)
                        if plan_s is not None:
                            kept += plan_s[1]
                            total += plan_s[2]
                zone = (kept, total) if total else None
            chunk = overrides.get(table)
            if chunk is not None:
                counts = [min(c, chunk) for c in counts]
                live = [min(c, chunk) for c in live]
            if ds is not None:
                cap = max(live[ds], 1)
            else:
                cap = max(max(live, default=0), 1)
            if chunk is not None:
                ref = max(max(counts, default=0), 1)
            elif ds is not None:
                ref = _pow2(max(counts[ds], 1))
            else:
                ref = _pow2(max(max(counts, default=0), 1))
            out[table] = TableShape(table, cap, ref, direct=ds, prune=prune,
                                    parts=parts, zone=zone, dyn=dyn_stat,
                                    index=spec.index_hits if zone else ())
        return out

    @staticmethod
    def scan_stats(shapes: dict) -> dict:
        """The statement's pruning stats, as the JAX executor reports
        them: ``partitions`` (children staged per partitioned parent),
        ``zone_prune`` ((kept, total) blocks per pruned table),
        ``dynamic_prune`` ((kept, total) children after the join-driven
        selector) and ``index_hits`` (the block indexes a pruned read
        probed, per table)."""
        out = {"partitions": {}, "zone_prune": {}, "dynamic_prune": {},
               "index_hits": {}}
        for t, sh in shapes.items():
            if sh.parts is not None:
                out["partitions"][t] = len(sh.parts)
            if sh.zone is not None:
                out["zone_prune"][t] = sh.zone
            if sh.dyn is not None:
                out["dynamic_prune"][t] = sh.dyn
            if sh.index:
                out["index_hits"][t] = len(sh.index)
        return out

    def _dyn_pruned_parts(self, table, child_parts, dyn, snapshot):
        """-> (the child partitions surviving the build-side key-value
        probe, (kept, total)): the execution-time PartitionSelector
        (nodePartitionSelector.c). The build table's pushed filter runs on
        the host over its rows; a child survives when a surviving key can
        land in it. Cached per manifest version; on any irregularity every
        child is kept (a missed prune only costs time)."""
        version = snapshot.get("version", 0)
        ck = (table, child_parts, dyn, version)
        hit = self._dyn_prune_cache.get(ck)
        if hit is not None:
            return hit, (len(hit), len(child_parts))
        dim_table, preds, key_col = dyn
        try:
            schema = self.catalog.get(table)
            dim_schema = self.catalog.get(dim_table)
            need = {key_col} | {c for c, _, _ in preds}
            segs = ([0] if dim_schema.policy.kind is PolicyKind.REPLICATED
                    else range(dim_schema.policy.numsegments))
            vals_parts = []
            for seg in segs:
                c, v, n = self.store.read_segment(dim_table, seg,
                                                  sorted(need), snapshot)
                m = np.ones(n, dtype=bool)
                for col, op, val in preds:
                    arr = c[col]
                    cv = v.get(col)
                    if cv is not None:
                        m &= np.asarray(cv, bool)
                    m &= {"=": arr == val, "<": arr < val, "<=": arr <= val,
                          ">": arr > val, ">=": arr >= val}[op]
                kv = v.get(key_col)
                if kv is not None:
                    m &= np.asarray(kv, bool)   # NULL keys never join
                vals_parts.append(c[key_col][m])
            values = (np.unique(np.concatenate(vals_parts)) if vals_parts
                      else np.empty(0))
            keep_idx = set(schema.partitions_for_values(values))
            name_keep = {schema.partitions[i].storage_name(table)
                         for i in keep_idx}
            kept = tuple(p for p in child_parts if p in name_keep)
        except Exception:
            return child_parts, None   # never fail the query for a prune
        self._dyn_prune_cache.put(ck, kept, version=version)
        return kept, (len(kept), len(child_parts))

    def _stage(self, plan, snapshot, shapes, ranges, aux,
               prefetcher) -> dict[str, TableData]:
        """Every scanned table's needed columns on the device in segment
        layout: whole tables from the stage cache or staged now; a spill
        pass's ranged table and an aux table staged apart from it."""
        version = snapshot.get("version", 0)
        out = {}
        for table, want in self.staged_columns(plan, snapshot, aux).items():
            interrupt.check_interrupts()   # between per-table assemblies
            with _trace.span("stage:" + table, cat="stage"):
                out[table] = self._stage_table(
                    table, want, shapes[table], version, snapshot, ranges,
                    aux, prefetcher)
        return out

    def _stage_table(self, table, want, shape, version, snapshot, ranges,
                     aux, prefetcher) -> TableData:
        """One table's staged columns: a whole table from the stage cache
        (a cold one staged once, under the cache lock, however many
        statements want it at once), or a spill pass's range or an aux
        table staged apart from it. The cache's entries are the registry's
        (LRU within the card's budget): this statement keeps the tensors
        it found or staged even when a later insert evicts them."""
        cap = shape.capacity
        how = dict(parts=shape.parts, prune=shape.prune,
                   direct=shape.direct)
        if table in aux:
            t = self._upload(self._aux_buffers(want, cap, aux[table]), cap)
            memaccount.charge("staging", _nbytes(t.values()), item=table)
        elif table in ranges:
            rng = ranges[table]
            bufs = (prefetcher.take(table, rng)
                    if prefetcher is not None else None)
            if bufs is None:
                bufs = self.host_buffers(table, want, cap, snapshot, rng,
                                         **how)
            if prefetcher is not None:
                prefetcher.kick()
            t = self._upload(bufs, cap)
            memaccount.charge("staging", _nbytes(t.values()), item=table)
        else:
            tail = (shape.direct, shape.prune, shape.parts)
            with self._cache_mu:
                t, missing = {}, []
                for c in want + ["@present"]:
                    hit = self._stage_cache.get((table, c, cap, version)
                                                + tail, MISS)
                    if hit is MISS:
                        missing.append(c)
                    else:
                        t[c] = hit
                if missing:
                    staged = self._upload(self.host_buffers(
                        table, [c for c in missing if c != "@present"], cap,
                        snapshot, None, **how), cap)
                    memaccount.charge("staging", _nbytes(staged.values()),
                                      item=table)
                    for c, v in staged.items():
                        if c in missing:
                            t[c] = v
                            self._stage_cache.put(
                                (table, c, cap, version) + tail, v,
                                version=version)
        return TableData(table, {c: t[c] for c in want}, t["@present"],
                         ref_capacity=shape.ref_capacity)

    def host_buffers(self, table, names, cap, snapshot, rng, parts=None,
                     prune=None, direct=None) -> dict:
        """Read ``names`` of every segment from the store (rows [lo, hi) of
        each when ``rng`` is given) into [nseg * cap] host buffers, pinned
        for a card, with the "@present" live-slot mask. A partitioned
        parent reads its ``parts`` one after another in each segment,
        ``prune`` skips the blocks the zone maps and block indexes rule
        out, and a ``direct`` dispatch reads its one segment (the others
        stage no rows). Each segment is one unit of the read pool; units
        write disjoint slices."""
        schema = self.catalog.get(table)
        dev = self.layout.device
        storage = sorted({c[len(VALID_PREFIX):] if c.startswith(VALID_PREFIX)
                          else c for c in names})
        # the statement's interrupt context, captured HERE because the read
        # units run on pool threads (REGISTRY.current() is per thread):
        # each unit is a cancellation point, and the raise travels back to
        # the statement's thread through the unit's result
        stmt_ctx = interrupt.REGISTRY.current()
        # the statement's memory account travels the same way: a unit's
        # pool thread binds to it for the unit's duration
        stmt_acct = memaccount.ACCOUNTS.current()
        dtypes = {"@present": np.dtype(bool)}
        for c in names:
            dtypes[c] = (np.dtype(bool) if c.startswith(VALID_PREFIX)
                         else schema.column(c).type.np_dtype)
        bufs = {c: staging.host_buffer(self.nseg * cap, dt, dev)
                for c, dt in dtypes.items()}
        views = {c: b.numpy() for c, b in bufs.items()}

        def unit(seg):
            faults.check("cancel_in_staging", segment=seg)
            if stmt_ctx is not None:
                stmt_ctx.check()
            if direct is not None and seg != direct:
                cols, valids, n = {}, {}, 0
            else:
                # a whole segment decodes its block files straight into
                # its slot of each buffer, a partitioned parent's children
                # each at its offset (a directory's store; the in-memory
                # one copies there)
                dest = ({c: views[c][seg * cap: (seg + 1) * cap]
                         for c in storage if c in views}
                        if rng is None else None)
                with memaccount.ACCOUNTS.bind(stmt_acct):
                    cols, valids, n = self.store.read_segment(
                        table, seg, storage, snapshot, prune=prune,
                        dest=dest, parts=parts)
            lo = 0
            if rng is not None:
                lo, n = rng[0], max(min(n, rng[1]) - rng[0], 0)
            for c, view in views.items():
                if not n:
                    pass
                elif c == "@present":
                    arr = np.ones(n, dtype=bool)
                elif c.startswith(VALID_PREFIX):
                    v = valids.get(c[len(VALID_PREFIX):])
                    arr = np.ones(n, dtype=bool) if v is None \
                        else v[lo:lo + n]
                else:
                    arr = cols[c][lo:lo + n]
                if n:
                    slot = view[seg * cap: seg * cap + n]
                    if not np.may_share_memory(arr, slot):
                        slot[:] = arr
                view[seg * cap + n: (seg + 1) * cap] = 0
            return n

        with staging.pool(self.settings) as p:
            for f in [p.submit(unit, seg) for seg in range(self.nseg)]:
                f.result()
        return bufs

    def _aux_buffers(self, names, cap, data) -> dict:
        """An aux table's host buffers: its rows split contiguously across
        segments, ``cap`` per segment (the JAX executor's _stage_aux)."""
        aux_cols, aux_valids = data
        n = len(next(iter(aux_cols.values()))) if aux_cols else 0
        counts = [max(min(n, (s + 1) * cap) - s * cap, 0)
                  for s in range(self.nseg)]
        dev = self.layout.device
        out = {}
        for c in names + ["@present"]:
            if c == "@present":
                src = np.ones(n, dtype=bool)
            elif c.startswith(VALID_PREFIX):
                src = aux_valids.get(c[len(VALID_PREFIX):])
                src = np.ones(n, dtype=bool) if src is None \
                    else np.asarray(src, bool)
            else:
                src = np.asarray(aux_cols[c])
            buf = staging.host_buffer(self.nseg * cap, src.dtype, dev)
            staging.fill_buffer(
                self.nseg, cap, src.dtype,
                ((s, src[s * cap: s * cap + counts[s]])
                 for s in range(self.nseg)), 0, out=buf.numpy())
            out[c] = buf
        return out

    def _upload(self, bufs: dict, cap: int) -> dict:
        """Host buffers -> [nseg, cap] device tensors (non_blocking from
        pinned memory on a card; the buffers themselves on the CPU)."""
        dev = self.layout.device
        return {c: b.view(self.nseg, cap).to(dev, non_blocking=True)
                for c, b in bufs.items()}
