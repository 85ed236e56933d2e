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
one, or one inside a pass, raises ``OutOfDeviceMemory``.

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
parameters, admission of ``est_bytes`` (W members) against
``effective_limit_bytes``, one flag read and one copy of every member's
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

from greengage_tpu_torch import types as T
from greengage_tpu_torch.exec import staging
from greengage_tpu_torch.exec.compile import (
    VALID_PREFIX, CompileResult, Compiler, ProgramOutput, TableData,
    TableShape, _pow2,
)
from greengage_tpu_torch.ops import sort as sort_ops
from greengage_tpu_torch.ops.batch import Batch
from greengage_tpu_torch.planner.logical import Plan, Scan
from greengage_tpu_torch.runtime import interrupt
from greengage_tpu_torch.runtime import trace as _trace
from greengage_tpu_torch.runtime.faultinject import faults
from greengage_tpu_torch.runtime.logger import counters
from greengage_tpu_torch.runtime.resgroup import current_memory_limit_mb


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
    Carries the admission estimate and the allocator's counters."""

    def __init__(self, message: str, est_bytes: int = 0,
                 device_stats: dict | None = None):
        super().__init__(message)
        self.est_bytes = int(est_bytes)
        self.device_stats = device_stats or {}


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
              stage=None, admit=None, raw: bool = False) -> Result:
    """Compile ``plan`` over ``tables`` and run it, retrying on overflow as
    the JAX executor's _run_tiers does: a capacity overflow re-runs at the
    next tier (capacities x4), sized from the exact count where the device
    reported one; a key-packing bounds violation re-runs the same tier
    with that node unpacked; duplicate keys on a unique join's build side
    raise QueryError (the session re-plans with the multi-match join).
    ``no_direct`` builds every join's hash table; ``cap_overrides`` seeds
    the exact-count sizes (the executor's cap hints).

    ``tables`` are the staged tables, or only their shapes when
    ``stage(comp)`` stages them after each compile; ``admit(comp)`` runs
    between the compile and the staging and raises to refuse."""
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
                            pack_disabled=pack_disabled, no_direct=no_direct)
        with _trace.span("compile", cat="exec", tier=tier):
            comp = compiler.compile(plan)
        if admit is not None:
            admit(comp)
        staged = stage(comp) if stage is not None else tables
        # the last cancellation point before the launch: once the
        # program is on the device it runs to its end
        faults.check("cancel_before_dispatch")
        interrupt.check_interrupts()
        # the span ends at the host's read of the flags, which waits for
        # the program
        with _trace.span("dispatch", cat="device", tier=tier,
                         est_bytes=comp.est_bytes):
            if faults.check("device_oom"):
                # a faked allocator failure ('skip'): the OOM demotion
                # without exhausting the card
                raise torch.OutOfMemoryError(
                    f"out of memory while allocating {comp.est_bytes} "
                    "bytes per segment (fault injected: device_oom)")
            out = comp.program(staged)
            _, _, sel = _gather_rows(comp, out)
            host = _flag_tensor(out, comp, sel.sum()).cpu().numpy()
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
            with _trace.span("fetch", cat="device", rows=live):
                res = present(comp, gather(comp, out, compiler, live),
                              flags, metrics, compiler, raw=raw)
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
                         "mem": {"est_bytes": int(comp.est_bytes)}}
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

def _scans(plan: Plan, out: dict) -> dict:
    """table -> (the storage columns its Scans read (every scan's union),
    the direct-dispatch segment of each scan)."""
    if isinstance(plan, Scan):
        names, directs = out.setdefault(plan.table, (set(), []))
        names.update(c.name for c in plan.cols)
        directs.append(plan.direct_seg)
    for c in plan.children:
        _scans(c, out)
    return out


class Executor:
    def __init__(self, catalog, store, layout, settings):
        self.catalog = catalog
        self.store = store
        self.layout = layout
        self.nseg = layout.nseg
        self.settings = settings
        # (table, column, capacity, version) -> staged [nseg, cap] tensor;
        # (table, "@present", capacity, version) -> the live-slot mask
        self._stage_cache: dict = {}
        # cap hints: plan-cache key -> {plan-node ordinal: capacity}, the
        # exact counts of the statement's last run (pow2-bucketed), LRU
        # within plan_cache_size
        self._cap_hints: OrderedDict = OrderedDict()
        # the stage cache and the cap hints are shared by every thread's
        # statements (and the batch server's stager): their reads and
        # writes, and a table's cold staging, run under this lock
        self._cache_mu = threading.RLock()
        self._spill_dir: str | None = None

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
        if self._spill_dir is not None:
            self._spill_dir_rm()
            self._spill_dir = None

    def invalidate_table(self, table: str) -> None:
        with self._cache_mu:
            for k in [k for k in self._stage_cache if k[0] == table]:
                del self._stage_cache[k]

    def forget(self, cache_key) -> None:
        """Drop a statement's cap hints (its bound plan left the cache)."""
        with self._cache_mu:
            self._cap_hints.pop(cache_key, None)

    def _dictionary(self, ref):
        return self.store.dictionary(*ref).values

    # ---- run -----------------------------------------------------------
    def run(self, plan, consts: dict, cache_key=None, raw: bool = False, scan_cap_override: dict | None = None,
            row_ranges: dict | None = None, aux_tables: dict | None = None,
            allow_spill: bool = True, no_direct: bool = False,
            prefetcher=None) -> Result:
        """Run one planned statement. ``cache_key`` (the plan cache's key)
        seeds and records the cap hints. The spill passes drive the rest:
        ``scan_cap_override`` (table -> chunk rows), ``row_ranges`` (table
        -> the (lo, hi) slice of each segment's rows this pass reads),
        ``aux_tables`` (name -> (cols, valids) of captured host rows),
        ``allow_spill`` False inside a pass, ``prefetcher`` building the
        next pass's host buffers."""
        t0 = time.perf_counter()
        snapshot = self.store.manifest.snapshot()
        version = snapshot.get("version", 0)
        overrides = scan_cap_override or {}
        ranges = row_ranges or {}
        aux = aux_tables or {}
        shapes = self.table_shapes(plan, snapshot, overrides, aux)
        with self._cache_mu:
            # staged copies of older versions are unreachable: free them
            for k in [k for k in self._stage_cache if k[3] != version]:
                del self._stage_cache[k]
            hints = dict(self._cap_hints.get(cache_key) or {})
            if hints:
                self._cap_hints.move_to_end(cache_key)
        consts = self._with_params(consts)
        limit = effective_limit_bytes(self.settings, self.layout)
        last: dict = {}
        stage_s = [0.0]

        def admit(comp):
            last["comp"] = comp
            if limit and comp.est_bytes > limit:
                if allow_spill:
                    raise _SpillNeeded
                raise AdmissionError(
                    f"query would allocate ~{comp.est_bytes >> 20} MB per "
                    f"segment, above the {limit >> 20} MB memory ceiling "
                    "(raise vmem_protect_limit_mb or reduce the data)")

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
                            raw=raw)
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
                return self._handle_oom(oom_msg, est, plan, consts, raw,
                                        allow_spill, t0)
            from greengage_tpu_torch.exec import spill

            try:
                return self._spill_fallback(plan, consts, raw, t0)
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
        res.stats["mem"] = self._mem_stats(res.stats["mem"]["est_bytes"])
        return res

    def run_single(self, plan, consts, raw=False, scan_cap_override=None,
                   row_ranges=None, aux_tables=None, no_direct=False,
                   prefetcher=None) -> Result:
        """One spill pass: no recursive spilling, no cap hints."""
        return self.run(plan, consts, cache_key=None, raw=raw,
                        scan_cap_override=scan_cap_override,
                        row_ranges=row_ranges, aux_tables=aux_tables,
                        allow_spill=False, no_direct=no_direct,
                        prefetcher=prefetcher)

    def compile(self, plan, consts, scan_cap_override=None, aux_tables=None,
                no_direct: bool = True) -> CompileResult:
        """Compile ``plan`` at tier 0 without staging or running it: the
        spill paths size their passes from its ``est_bytes``."""
        shapes = self.table_shapes(plan, self.store.manifest.snapshot(),
                                   scan_cap_override or {}, aux_tables or {})
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
        # admission: est_bytes already counts the bucket's members
        limit = effective_limit_bytes(self.settings, self.layout)
        if limit and comp.est_bytes > limit:
            raise BatchFallback(
                f"batched program would hold ~{comp.est_bytes >> 20} MB "
                f"per segment at width {bucket}, above the "
                f"{limit >> 20} MB ceiling")
        # staging as for one statement; the port's in-memory store prunes
        # no blocks by value, so no member's parameters can starve
        # another's rows (the JAX package drops its parameter-valued
        # prune predicates here)
        with _trace.span("stage", cat="stage", tables=len(shapes),
                         batch_width=width, batch_bucket=bucket):
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
                         est_bytes=comp.est_bytes) as sp:
            faults.check("batch_dispatch")
            err = None
            try:
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

    def _mem_stats(self, est_bytes: int) -> dict:
        """The Result.stats["mem"] block: the estimate, what admission
        charged (the estimate: the port has no measured admission yet,
        ROADMAP Queue 1 item 7) and, on a card, the allocator's counters."""
        out = {"est_bytes": int(est_bytes), "admitted_bytes": int(est_bytes),
               "admitted_by": "estimate"}
        if self.layout.device.type == "cuda":
            out["device_bytes_in_use"] = int(
                torch.cuda.memory_allocated(self.layout.device))
            out["device_peak_bytes_in_use"] = int(
                torch.cuda.max_memory_allocated(self.layout.device))
        return out

    # ---- spill and out-of-memory ---------------------------------------
    def _release_for_spill(self, plan) -> None:
        """Drop the cached whole columns of the tables a spilling statement
        reads, and on a card hand the allocator's free blocks back, so the
        passes run without them."""
        for table in _scans(plan, {}):
            self.invalidate_table(table)
        if self.layout.device.type == "cuda":
            torch.cuda.empty_cache()

    def _spill_fallback(self, plan, consts, raw, t0) -> Result:
        """The spill paths, shared by the admission refusal and the OOM
        demotion: partial-aggregate passes first, then window-partition
        passes over the PARTITION BY hash space, then the external-merge
        sort. Raises spill.NotSpillable through when no shape applies."""
        from greengage_tpu_torch.exec import spill

        self._release_for_spill(plan)
        try:
            res, npasses = spill.spill_run(self, plan, consts, raw)
        except spill.NotSpillable:
            try:
                res, npasses = spill.spill_window_run(self, plan, consts,
                                                      raw)
            except spill.NotSpillable:
                res, npasses = spill.spill_sort_run(self, plan, consts, raw)
        res.stats = dict(res.stats or {})
        res.stats["spill_passes"] = npasses
        res.wall_ms = (time.perf_counter() - t0) * 1e3
        res.stats["wall_ms"] = res.wall_ms
        return res

    def _handle_oom(self, msg, est_bytes, plan, consts, raw, allow_spill,
                    t0) -> Result:
        """The allocator refused the statement: demote to the spill path
        once when allowed (``oom_spill_retry``), else raise the typed
        OutOfDeviceMemory."""
        counters.inc("oom_events")
        stats = {}
        if self.layout.device.type == "cuda":
            stats = {"bytes_in_use": int(torch.cuda.memory_allocated()),
                     "peak_bytes_in_use": int(
                         torch.cuda.max_memory_allocated())}
        oom = OutOfDeviceMemory(
            f"out of device memory (estimated ~{est_bytes >> 20} MB per "
            f"segment): {msg}", est_bytes=est_bytes, device_stats=stats)
        if allow_spill and bool(self.settings.oom_spill_retry):
            from greengage_tpu_torch.exec import spill

            try:
                res = self._spill_fallback(plan, consts, raw, t0)
            except spill.NotSpillable:
                raise oom from None
            counters.inc("oom_spill_retries")
            res.stats["oom_demoted"] = True
            return res
        raise oom

    # ---- staging -------------------------------------------------------
    def staged_columns(self, plan, snapshot, aux: dict | None = None) -> dict:
        """table -> the staged column names a plan's scans read: storage
        columns and the "@v:" NULL mask of each that has NULLs."""
        aux = aux or {}
        out = {}
        for table, (names, _d) in sorted(_scans(plan, {}).items()):
            want = []
            for c in sorted(names):
                want.append(c)
                if table in aux:
                    if aux[table][1].get(c) is not None:
                        want.append(VALID_PREFIX + c)
                elif self.store.has_nulls(table, c, snapshot):
                    want.append(VALID_PREFIX + c)
            out[table] = want
        return out

    def table_shapes(self, plan, snapshot, overrides: dict | None = None,
                     aux: dict | None = None) -> dict:
        """table -> TableShape of every scanned table. The staged capacity
        is the largest segment's rows (a spill chunk caps it); the
        reference capacity is the JAX compiler's: that count's power of
        two (of the pinned segment's under a consistent direct dispatch),
        the chunk exactly, or an aux table's even split."""
        overrides, aux = overrides or {}, aux or {}
        out = {}
        for table, (_names, directs) in _scans(plan, {}).items():
            if table in aux:
                cols0 = aux[table][0]
                n = len(next(iter(cols0.values()))) if cols0 else 0
                cap = max(-(-max(n, 1) // self.nseg), 1)
                out[table] = TableShape(table, cap, cap)
                continue
            counts = self.store.segment_rowcounts(table, snapshot)
            chunk = overrides.get(table)
            if chunk is not None:
                counts = [min(c, chunk) for c in counts]
            cap = max(max(counts, default=0), 1)
            ds = directs[0] if all(d == directs[0] for d in directs) \
                else None
            if chunk is not None:
                ref = cap
            elif ds is not None and 0 <= ds < len(counts):
                ref = _pow2(max(counts[ds], 1))
            else:
                ref = _pow2(cap)
            out[table] = TableShape(table, cap, ref)
        return out

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
        table staged apart from it."""
        cap = shape.capacity
        if table in aux:
            t = self._upload(self._aux_buffers(want, cap, aux[table]), cap)
        elif table in ranges:
            rng = ranges[table]
            bufs = (prefetcher.take(table, rng)
                    if prefetcher is not None else None)
            if bufs is None:
                bufs = self.host_buffers(table, want, cap, snapshot, rng)
            if prefetcher is not None:
                prefetcher.kick()
            t = self._upload(bufs, cap)
        else:
            with self._cache_mu:
                missing = [c for c in want + ["@present"]
                           if (table, c, cap, version)
                           not in self._stage_cache]
                if missing:
                    staged = self._upload(self.host_buffers(
                        table, [c for c in missing if c != "@present"], cap,
                        snapshot, None), cap)
                    self._stage_cache.update(
                        {(table, c, cap, version): v
                         for c, v in staged.items() if c in missing})
                t = {c: self._stage_cache[(table, c, cap, version)]
                     for c in want + ["@present"]}
        return TableData(table, {c: t[c] for c in want}, t["@present"],
                         ref_capacity=shape.ref_capacity)

    def host_buffers(self, table, names, cap, snapshot, rng) -> dict:
        """Read ``names`` of every segment from the store (rows [lo, hi) of
        each when ``rng`` is given) into [nseg * cap] host buffers, pinned
        for a card, with the "@present" live-slot mask. Each segment is
        one unit of the read pool; units write disjoint slices."""
        schema = self.catalog.get(table)
        dev = self.layout.device
        storage = sorted({c[len(VALID_PREFIX):] if c.startswith(VALID_PREFIX)
                          else c for c in names})
        # the statement's interrupt context, captured HERE because the read
        # units run on pool threads (REGISTRY.current() is per thread):
        # each unit is a cancellation point, and the raise travels back to
        # the statement's thread through the unit's result
        stmt_ctx = interrupt.REGISTRY.current()
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
            cols, valids, n = self.store.read_segment(table, seg, storage,
                                                      snapshot)
            lo = 0
            if rng is not None:
                lo, n = rng[0], max(min(n, rng[1]) - rng[0], 0)
            for c, view in views.items():
                if c == "@present":
                    arr = np.ones(n, dtype=bool)
                elif c.startswith(VALID_PREFIX):
                    v = valids.get(c[len(VALID_PREFIX):])
                    arr = np.ones(n, dtype=bool) if v is None \
                        else v[lo:lo + n]
                else:
                    arr = cols[c][lo:lo + n]
                view[seg * cap: seg * cap + n] = arr
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
