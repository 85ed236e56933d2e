"""Database session — the port's counterpart of greengage_tpu/exec/session.py.

One object owns the catalog, the table store, the settings, the segment
layout on the device and the executor; ``sql()`` is exec_simple_query:

  parse -> bind -> plan -> compile -> stage -> run -> Gather -> rows

each statement through the same steps as the JAX session's ``_sql_inner``
-> ``_execute`` -> ``_cached_plan`` -> ``_select``: a SELECT's bound plan
is kept per literal-stripped statement shape and store version, so a
repeat skips bind and plan.

One Database serves many threads at once, as the JAX session does (one
thread per connection, runtime/server.py): each statement's plan-cache
outcome is kept per thread, and the bound-plan LRU (and the executor's
caches) are locked. Every statement registers a ``StatementContext``
(runtime/interrupt.py: ``statement_timeout_s``, cancel by id through
``REGISTRY.cancel``), a trace (runtime/trace.py) and a memory account
(runtime/memaccount.py), evaluates the brownout controller
(runtime/overload.py), and waits for its resource group's and the
resource queue's admission (runtime/resgroup.py, runtime/resqueue.py)
before it runs. With ``batch_serving_enabled`` a parameterised SELECT
joins its shape's admission window in the batch server
(exec/batchserve.py) and runs as one member of a batched program; a batch
that cannot run as one program sends its members back to the classic
path.

The cost-feedback loop runs as in the JAX session (``cost_feedback``):
after every SELECT the per-node actual rows (the Filter counters of every
run, every node's under EXPLAIN ANALYZE) and the exact result count are
reconciled against the planner's estimates in the feedback store
(planner/feedback.py, ``db.feedback``); a promoted correction bumps the
shape's calibration version, which joins the plan-cache key, so the next
run re-plans with the corrected estimate. ``db.fts`` probes every primary
(runtime/fts.py).

The statements handled: SELECT (joins, subqueries, window functions,
UNION [ALL], GROUPING SETS / ROLLUP / CUBE, SELECT without FROM — a
constant target list on the host, anything else through the ConstRel
device path — and WITH RECURSIVE, a fixpoint over worktables), EXPLAIN
[ANALYZE] of a SELECT, CREATE TABLE (DISTRIBUTED BY / RANDOMLY /
REPLICATED, PARTITION BY RANGE | LIST with a DEFAULT), ALTER TABLE ...
ADD | DROP PARTITION, DROP TABLE, CREATE | DROP INDEX (block-value
indexes), ANALYZE [table], CREATE EXTENSION, SET and SHOW of the settings
the port holds, INSERT (VALUES and SELECT), COPY FROM and TO a file,
DELETE and UPDATE (autocommit: deletion bitmaps and appended row
versions, the store's visimap; a partitioned table's children
republished in one commit), ``load_table`` for bulk loads (a partitioned
table's rows routed to its children), ``vacuum`` for compaction and
``expand`` for a new width. Writers are serialised against each other by
``_RWLock`` (appends share it, one per table; DELETE, UPDATE and DDL hold
it alone) and readers read one committed snapshot, so a statement never
sees half of a write. Every other statement raises a SqlError naming the
ROADMAP item it waits for; a plan node the compiler cannot lower raises
NotImplementedError before anything runs, never a wrong answer.
"""

from __future__ import annotations

import copy as _copy
import dataclasses as _dc
import itertools
import json
import os
import shutil
import tempfile
import threading
import time
import warnings
import weakref
from collections import OrderedDict
from contextlib import ExitStack, contextmanager
from types import SimpleNamespace

import numpy as np
import torch

from greengage_tpu_torch import resolve_device
from greengage_tpu_torch import expr as E
from greengage_tpu_torch import types as T
from greengage_tpu_torch.analysis.plancheck import validate_plan
from greengage_tpu_torch.catalog import (Catalog, Column, DistPolicy,
                                         Partition, PolicyKind, TableSchema)
from greengage_tpu_torch.config import Settings
from greengage_tpu_torch.exec.compile import collect_scans
from greengage_tpu_torch.exec.executor import (Executor, OutOfDeviceMemory,
                                               QueryError, Result, shape_of)
from greengage_tpu_torch.parallel.mesh import make_layout
from greengage_tpu_torch.planner import cost as _cost
from greengage_tpu_torch.planner import plan_query
from greengage_tpu_torch.planner.feedback import FeedbackStore
from greengage_tpu_torch.planner.logical import describe
from greengage_tpu_torch.runtime import memaccount as _memaccount
from greengage_tpu_torch.runtime import overload as _overload
from greengage_tpu_torch.runtime import trace as _trace
from greengage_tpu_torch.runtime.fts import FtsProber
from greengage_tpu_torch.runtime.interrupt import REGISTRY as _INTERRUPTS
from greengage_tpu_torch.runtime.interrupt import (StatementCancelled,
                                                  check_interrupts)
from greengage_tpu_torch.runtime.logger import ClusterLog, counters, histograms
from greengage_tpu_torch.runtime.resgroup import (ResourceGroup,
                                                 ResourceGroupManager)
from greengage_tpu_torch.runtime.resqueue import ResourceQueue
from greengage_tpu_torch.runtime.trace import TRACES as _TRACES
from greengage_tpu_torch.sql import ast as A
from greengage_tpu_torch.sql.binder import (Binder, Scope, _ast_name,
                                           _contains_agg, type_from_name)
from greengage_tpu_torch.sql.parser import SqlError, parse
from greengage_tpu_torch.storage import MemoryTableStore, TableStore

# statements of the JAX session that wait for a later slice -> the ROADMAP
# item that ports them
_LATER = {
    A.TxStmt: "transactions: ROADMAP Queue 1 item 1a-iii (runtime/dtm.py)",
    A.DeclareCursorStmt: "cursors: ROADMAP Queue 1 item 1h",
    A.RetrieveStmt: "cursors: ROADMAP Queue 1 item 1h",
    A.CloseCursorStmt: "cursors: ROADMAP Queue 1 item 1h",
    A.CreateExternalTableStmt: "external tables: ROADMAP Queue 1 item 1b-ii",
}



class Database:
    def __init__(self, path: str | None = None, numsegments: int | None = None,
                 mirrors: bool = False, multihost=None, device=None):
        """``path``: a database directory, created or reopened in the JAX
        package's format (catalog.json, the manifest, block files,
        calibration.json, feedback.json, the users file), as the JAX
        session opens one: the catalog's width is checked against
        ``numsegments`` and ``manifest.recover()`` resolves a write a
        killed process left in doubt. None: in memory (the catalog and the
        rows), with a scratch directory for the log and the users file
        that goes at close."""
        if mirrors:
            raise NotImplementedError(
                "mirrors: ROADMAP Queue 1 item 10 (replication)")
        if multihost is not None:
            raise NotImplementedError("multi-GPU: ROADMAP Queue 1 item 8")
        self.device = resolve_device(device)
        if path is not None \
                and os.path.exists(os.path.join(path, "catalog.json")):
            self.catalog = Catalog.load(path)
            width = self.catalog.segments.numsegments
            if numsegments is None:
                numsegments = width
            elif width != numsegments:
                raise ValueError(
                    f"cluster width mismatch: on-disk {width}, requested "
                    f"{numsegments} (run gpexpand-style redistribution)")
            if self.catalog.segments.has_mirrors():
                raise NotImplementedError(
                    f"{path} has segment mirrors: ROADMAP Queue 1 item 10 "
                    "(replication)")
        else:
            if numsegments is None:
                # one segment per visible device, as the JAX session takes
                # one per visible chip
                numsegments = (torch.cuda.device_count()
                               if self.device.type == "cuda" else 1)
            self.catalog = Catalog(numsegments, path=path)
        self.numsegments = numsegments
        self.durable = path is not None
        if self.durable:
            os.makedirs(path, exist_ok=True)
            self.path = path
            self._path_rm = None
            self.catalog._save()   # the width, before the first table
            self.store = TableStore(path, self.catalog)
            # in-doubt resolution on open: a load staged but not committed
            # rolls back, committed lines fold into the root; a width the
            # manifest committed but the catalog missed (an expand cut
            # short) is adopted
            self.store.manifest.recover()
            self.store.reconcile_widths()
        else:
            self.path = tempfile.mkdtemp(prefix="ggtpu_")
            self._path_rm = weakref.finalize(self, shutil.rmtree, self.path,
                                             ignore_errors=True)
            self.store = MemoryTableStore(self.catalog)
        self.log = ClusterLog(self.path)
        # the brownout state this Database last saw (_overload_tick)
        self._overload_seen = False
        self.settings = Settings()
        self.store.settings = self.settings
        # the block cache reads scan_cache_limit_mb live, and holds the
        # staged tensors on a card to a share of the card's memory
        self.store.blockcache.settings = self.settings
        if self.device.type == "cuda":
            self.store.blockcache.card_bytes = \
                torch.cuda.get_device_properties(self.device).total_memory
        self.store.log = self.log
        # the cost model's process-wide knobs, installed as the JAX session
        # installs them at connect: the directory's calibration.json (the
        # card's primitives, mgmt/cli.py) or the defaults, always
        # reinstalled, so a directory opened after a calibrated one in the
        # same process gets the defaults back
        _cost.set_calibration(self._read_calibration())
        _cost.set_motion_overlap(self._motion_overlap_factor())
        self.layout = make_layout(numsegments, self.device)
        self.executor = Executor(self.catalog, self.store, self.layout,
                                 self.settings)
        # the cost-feedback store (planner/feedback.py): observed actuals
        # against the planner's estimates per plan-node digest, in the
        # directory's feedback.json (kept across a reopen)
        self.feedback = FeedbackStore(os.path.join(self.path,
                                                   "feedback.json"),
                                      settings=self.settings)
        # the executor keys re-calibrated plans apart and keeps measured
        # bytes and cap hints per shape in the store (exec/executor.py)
        self.executor.feedback = self.feedback
        # FTS (runtime/fts.py): one probe round trip per primary on this
        # Database's device; no background prober (the JAX session starts
        # one for a registered standby, ROADMAP Queue 1 item 10)
        self.fts = FtsProber(self.catalog.segments, self.device)
        counters.set("mh_topology_version", self.catalog.segments.version)
        # the bound-plan LRU (_cached_plan): (statement signature, store
        # version, calibration version) -> (planned, consts, outs, exec
        # key, param types). Its
        # get/move/insert/evict and the fallback set run under _cache_mu:
        # statements of many threads share them
        self._select_cache: OrderedDict = OrderedDict()
        self._cache_mu = threading.Lock()
        # signatures whose parameterized form the binder refused: they
        # plan value-pinned straight away
        self._paramize_fallback: set = set()
        # (signature, store version) of shapes whose unique-key joins met
        # duplicate build keys: they plan multi-match joins straight away
        self._multi_join: set = set()
        # each thread's last _cached_plan outcome (the _plan_cache_info
        # property)
        self._pc_info_local = threading.local()
        # admission (_admission): the resource queue and the resource
        # groups, whose definitions the catalog keeps (catalog.json)
        self.resqueue = ResourceQueue(self.settings)
        self.resgroups = ResourceGroupManager(
            self.settings, {d["name"]: ResourceGroup.from_dict(d)
                            for d in self.catalog.resource_groups})
        # the batch server (exec/batchserve.py): made on the first
        # batch-eligible statement, so its two threads exist only while
        # batch_serving_enabled is on
        self._batch_server = None
        self._batch_server_mu = threading.Lock()
        # the writers' lock: DDL, DELETE, UPDATE and VACUUM hold it alone;
        # autocommit appends (INSERT, COPY) share it, each under its
        # table's own lock (_table_lock). Readers take neither: they read
        # one committed snapshot
        self._write_lock = _RWLock()
        self._table_locks: dict = {}
        self._table_locks_mu = threading.Lock()
        # tables dropped (DROP TABLE, DROP PARTITION): the log cursors
        # check when they register (ROADMAP Queue 1 item 1h), bounded
        self._drop_log: list[str] = []
        self._load_extensions()

    def _load_extensions(self) -> None:
        """Load the extensions the catalog records. Best-effort: a recorded
        extension whose module is gone must not keep the Database from
        opening; its functions stay unknown. A reopened directory's
        catalog.json lists them; a new catalog starts with none."""
        from greengage_tpu_torch import extensions as X

        for name in self.catalog.extensions:
            try:
                X.load(name)
            except ValueError as e:
                warnings.warn(f"extension {name!r} failed to load: {e}")

    def _read_calibration(self) -> dict | None:
        if not self.durable:
            return None
        try:
            with open(os.path.join(self.path, "calibration.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def set_calibration(self, values: dict | None) -> None:
        """Install measured cost-model primitives (planner/cost.py
        ``set_calibration``, process-wide; None restores the defaults) and
        drop this Database's bound plans, priced under the others. A
        directory keeps them in calibration.json, which the JAX session
        (and the next open) installs at connect."""
        _cost.set_calibration(values)
        if self.durable:
            cal = os.path.join(self.path, "calibration.json")
            if values is None:
                try:
                    os.remove(cal)
                except OSError:
                    pass
            else:
                tmp = cal + f".{os.getpid()}.tmp"
                with open(tmp, "w") as f:
                    json.dump(values, f, indent=1)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, cal)
        with self._cache_mu:
            self._select_cache.clear()

    def _motion_overlap_factor(self) -> float:
        """Redistribute overlap credit from motion_pipeline_buckets
        (planner/cost.set_motion_overlap), as the JAX session derives it
        with its motion_pipeline on (the port has no host bucket pipeline
        to turn off)."""
        nb = max(int(self.settings.motion_pipeline_buckets), 1)
        if nb <= 1:
            return 0.9
        return max(0.5, 0.5 + 0.5 / min(nb, 8))

    # ------------------------------------------------------------------
    def sql(self, text: str):
        """Execute one or more statements; returns the last statement's
        Result (or a status string for DDL).

        Every call registers a StatementContext in the process-wide
        interrupt registry (runtime/interrupt.py): ``REGISTRY.cancel``
        and ``statement_timeout_s`` set its flag, and the statement dies
        at its next cancellation point with a typed cause, counted once
        in ``statements_cancelled_<cause>``. Its trace (runtime/trace.py)
        and its memory account (runtime/memaccount.py: staging, spill and
        device charges) have the statement's id; nested calls on the same
        thread share the outermost statement's context, trace and
        account. The outermost call evaluates the brownout controller
        first (``_overload_tick``)."""
        ctx, _outer = _INTERRUPTS.enter(
            text, timeout_s=float(self.settings.statement_timeout_s))
        tr, t_outer = _TRACES.enter(
            ctx.statement_id, text,
            enabled=bool(self.settings.trace_enabled),
            ring_size=int(self.settings.trace_ring_size))
        acct, a_outer = _memaccount.ACCOUNTS.enter(
            ctx.statement_id, text,
            enabled=bool(self.settings.mem_accounting_enabled))
        t0 = time.monotonic()
        root = (tr.begin("statement", cat="statement")
                if tr is not None and t_outer else None)
        if t_outer:
            self._overload_tick()
        try:
            return self._sql_inner(text)
        except StatementCancelled as e:
            if not ctx.counted:
                ctx.counted = True
                counters.inc(f"statements_cancelled_{e.cause}")
            raise
        except OutOfDeviceMemory as e:
            if a_outer:
                self._dump_mem_forensics(e, ctx.statement_id, text)
            raise
        finally:
            if root is not None:
                tr.end(root)
            if t_outer:
                histograms.observe("statement_ms",
                                   (time.monotonic() - t0) * 1e3)
            _memaccount.ACCOUNTS.exit(acct)
            _TRACES.exit(tr)
            _INTERRUPTS.exit(ctx)

    def _dump_mem_forensics(self, e: OutOfDeviceMemory, statement_id: int,
                            text: str) -> None:
        """Write ``mem-<statement id>.json`` into the log directory: the
        per-owner accounting tree (with the allocator's counters at the
        failure), the program's measurement and the admission estimate.
        Never raises: forensics must not replace the typed error."""
        try:
            if not self.log.enabled:
                return
            payload = {"statement_id": statement_id,
                       "sql": text.strip()[:500], "error": str(e),
                       "est_bytes": e.est_bytes,
                       "memory_analysis": e.mem_analysis,
                       "accounting": e.snapshot,
                       "ts_unix_s": round(time.time(), 3)}
            os.makedirs(self.log.dir, exist_ok=True)
            path = os.path.join(self.log.dir, f"mem-{statement_id}.json")
            with open(path, "w") as f:
                json.dump(payload, f, indent=1, default=str)
            self.log.error("out_of_device_memory", f"{e} [mem dump={path}]")
        except Exception:
            pass

    def _overload_tick(self) -> None:
        """Evaluate the process-wide brownout controller (rate-limited
        inside) and, on a transition this Database has not seen yet, evict
        the block cache to its budget (``limit_bytes`` reads the brownout
        factor, so entry frees bytes now, staged device tensors included,
        instead of at the next insert) and log the edge. Never raises:
        overload protection must not fail the statement it protects."""
        try:
            state = _overload.CONTROLLER.evaluate(self.settings)
            if state == self._overload_seen:
                return
            self._overload_seen = state
            snap = _overload.CONTROLLER.snapshot()
            with _trace.span("brownout-transition", cat="overload",
                             entered=state):
                self.store.blockcache.evict_to_fit()
                if state:
                    self.log.log(
                        "WARNING", "overload",
                        f"brownout entered: {snap.get('reason')} — "
                        f"block-cache budget x{snap.get('cache_factor')}, "
                        "batch serving disabled, admissions prefer the "
                        "spill passes")
                else:
                    self.log.info(
                        "overload", "brownout cleared: pressure below the "
                        "exit threshold for brownout_exit_s")
        except Exception:
            pass

    def _sql_inner(self, text: str):
        t0 = time.perf_counter()
        with _trace.span("parse", cat="front"):
            stmts = parse(text)
        parse_ms = (time.perf_counter() - t0) * 1e3
        out = None
        for stmt in stmts:
            t1 = time.perf_counter()
            out = self._execute(stmt)
        if isinstance(out, Result):
            # the text's parse and the last statement, end to end
            out.wall_ms = parse_ms + (time.perf_counter() - t1) * 1e3
            out.stats.update(parse_ms=parse_ms, wall_ms=out.wall_ms)
        return out

    def _execute(self, stmt):
        if isinstance(stmt, (A.SelectStmt, A.UnionStmt)):
            return self._select(stmt)
        if isinstance(stmt, A.ExplainStmt):
            return self._explain(stmt)
        if isinstance(stmt, (A.InsertStmt, A.CopyStmt)) \
                and stmt.table in self.catalog:
            # autocommit appends take the SHARED write mode plus their
            # table's lock: appenders to different tables stage and commit
            # at once (per-table delta manifests, write intents), while
            # DDL, DELETE and UPDATE drain them through the exclusive mode
            with self._write_lock.shared(), \
                    (self._table_lock(stmt.table)
                     if self._append_needs_table_lock(stmt.table)
                     else _NullSlot()):
                if isinstance(stmt, A.InsertStmt):
                    return self._insert(stmt)
                return self._copy(stmt)
        # every other statement changes shared state (the catalog, the
        # manifest, the dictionaries, the settings): one writer at a time
        with self._write_lock:
            return self._execute_write(stmt)

    def _table_lock(self, table: str):
        """The per-table append serializer (same-table appenders queue; the
        base table keys it, so partition children share their parent's)."""
        base = table.split("#", 1)[0]
        with self._table_locks_mu:
            lk = self._table_locks.get(base)
            if lk is None:
                lk = self._table_locks[base] = threading.RLock()
            return lk

    def _append_needs_table_lock(self, table: str) -> bool:
        """Must same-table appenders still queue? With write intents on,
        appenders commit concurrently with no claim retry, unless the
        table has a dictionary-coded TEXT column: codes two appenders
        assign at once are reconciled only by the per-table claim's
        conflict, so those tables keep the serializer (as in the JAX
        session)."""
        if not bool(self.settings.write_intents_enabled):
            return True
        schema = self.catalog.get(table.split("#", 1)[0])
        return any(c.type.kind is T.Kind.TEXT and c.encoding != "raw"
                   for c in schema.columns)

    def _execute_write(self, stmt):
        if isinstance(stmt, A.DeleteStmt):
            return self._delete(stmt)
        if isinstance(stmt, A.UpdateStmt):
            return self._update(stmt)
        if isinstance(stmt, (A.InsertStmt, A.CopyStmt)):
            # its table does not exist: the statement raises as it would
            return (self._insert(stmt) if isinstance(stmt, A.InsertStmt)
                    else self._copy(stmt))
        if isinstance(stmt, A.CreateExtensionStmt):
            return self._create_extension(stmt)
        if isinstance(stmt, A.CreateTableStmt):
            return self._create_table(stmt)
        if isinstance(stmt, A.AlterTableStmt):
            return self._alter_table(stmt)
        if isinstance(stmt, A.CreateIndexStmt):
            return self._create_index(stmt)
        if isinstance(stmt, A.DropIndexStmt):
            return self._drop_index(stmt)
        if isinstance(stmt, A.DropTableStmt):
            existed = stmt.name in self.catalog
            # every storage table backing the relation: a partitioned
            # table's children are "<parent>#<part>"
            storage = (self.catalog.get(stmt.name).storage_tables()
                       if existed else [])
            self.catalog.drop_table(stmt.name, stmt.if_exists)
            if existed:
                self._note_drop(stmt.name)
                self.store.drop_table(stmt.name, storage)
                self.executor.invalidate_table(stmt.name)
            return "DROP TABLE"
        if isinstance(stmt, A.AnalyzeStmt):
            return self._analyze(stmt.table)
        if isinstance(stmt, A.ShowStmt):
            if stmt.what == "resource_group":
                return self.resgroups.current_group()
            return str(self._setting(self.settings.show, stmt.what))
        if isinstance(stmt, A.SetStmt):
            if stmt.name == "resource_group":
                # per-THREAD binding (one connection = one thread), like
                # SET ROLE picking the backend's resource group
                self.resgroups.set_group(str(stmt.value))
                return "SET"
            self._setting(self.settings.set, stmt.name, stmt.value)
            if stmt.name.startswith("resource_"):
                # wake blocked waiters: a raised or disabled cap admits
                # them now, not at their timeout
                self.resgroups.kick()
            if stmt.name == "cost_feedback":
                # cached bound plans were made under the other regime
                with self._cache_mu:
                    self._select_cache.clear()
            if stmt.name == "motion_pipeline_buckets":
                _cost.set_motion_overlap(self._motion_overlap_factor())
            elif stmt.name == "spill_dir" and self.settings.spill_dir:
                # spill files a killed process left in the directory now
                # in use (live processes' files stay)
                from greengage_tpu_torch.exec import workfile

                workfile.sweep_orphans(self.settings.spill_dir)
            elif stmt.name == "plan_cache_size":
                with self._cache_mu:
                    self._trim_plan_cache()
            return "SET"
        if isinstance(stmt, A.ResourceGroupStmt):
            return self._resource_group(stmt)
        later = _LATER.get(type(stmt))
        if later is not None:
            raise SqlError(f"{type(stmt).__name__} is not ported yet ({later})")
        raise SqlError(f"unsupported statement {type(stmt).__name__}")

    @staticmethod
    def _setting(fn, name, *value):
        try:
            return fn(name, *value)
        except ValueError as e:
            raise SqlError(f"{e} (the port holds the settings its modules "
                           "read; the rest come with ROADMAP Queue 1's "
                           "later items)") from None

    # ------------------------------------------------------------------
    def _create_table(self, stmt: A.CreateTableStmt) -> str:
        """CREATE TABLE, with PARTITION BY RANGE | LIST (single-level
        partitioning, cdbpartition.c's role): each partition's rows live
        in a child storage table ``<name>#<partition>``."""
        cols = [Column(c.name, type_from_name(c.type_name, c.typmod),
                       not c.not_null) for c in stmt.columns]
        kind = {"hash": PolicyKind.HASH, "random": PolicyKind.RANDOM,
                "replicated": PolicyKind.REPLICATED}[stmt.dist_kind]
        policy = DistPolicy(kind, tuple(stmt.dist_keys)
                            if kind is PolicyKind.HASH else (),
                            self.numsegments)
        schema = TableSchema(stmt.name, cols, policy, dict(stmt.options))
        if stmt.partition_kind is not None:
            if stmt.partition_col not in [c.name for c in cols]:
                raise SqlError(
                    f"partition column {stmt.partition_col} is not a column")
            pcol = schema.column(stmt.partition_col)
            if pcol.type.kind is T.Kind.TEXT:
                raise SqlError("TEXT partition keys are not supported")
            if policy.kind is PolicyKind.REPLICATED:
                # as in Greenplum: replicated tables cannot be partitioned
                raise SqlError("DISTRIBUTED REPLICATED tables cannot be "
                               "partitioned")
            schema.partition_by = (stmt.partition_kind, stmt.partition_col)
            parts: list[Partition] = []
            for pd in stmt.partition_defs:
                parts.extend(self._build_partitions(pd, pcol,
                                                    stmt.partition_kind))
            self._validate_partitions(parts, stmt.partition_kind, stmt.name)
            schema.partitions = parts
        self.catalog.create_table(schema, stmt.if_not_exists)
        return "CREATE TABLE"

    def _part_literal(self, node, col):
        """A partition bound literal in the column's storage representation
        (dates as epoch days, decimals scaled); NULL bounds are meaningless
        (NULL keys route to the DEFAULT partition) and rejected."""
        binder = Binder(self.catalog, self.store)
        lit = binder._expr(node, _EmptyScope())
        if not isinstance(lit, E.Literal):
            raise SqlError("partition bounds must be literals")
        lit = binder._coerce_literal(lit, col.type)
        if lit.value is None:
            raise SqlError("partition bounds/values cannot be NULL")
        return lit.value

    def _build_partitions(self, pd, pcol, kind) -> list[Partition]:
        """One partition definition -> its partitions (EVERY expands a
        RANGE definition into ``<name>_<k>`` steps of the column's storage
        units: days for a DATE)."""
        if pd.default:
            return [Partition(pd.name, default=True)]
        if kind == "list":
            if not pd.values:
                raise SqlError(
                    f"partition {pd.name}: LIST partitions need VALUES")
            if pd.lo is not None or pd.hi is not None or pd.every is not None:
                raise SqlError(
                    f"partition {pd.name}: START/END/EVERY are RANGE syntax")
            vals = tuple(self._part_literal(v, pcol) for v in pd.values)
            return [Partition(pd.name, values=vals)]
        if pd.values:
            raise SqlError(
                f"partition {pd.name}: VALUES is LIST syntax; this table "
                "is partitioned BY RANGE")
        lo = self._part_literal(pd.lo, pcol) if pd.lo is not None else None
        hi = self._part_literal(pd.hi, pcol) if pd.hi is not None else None
        if pd.every is None:
            return [Partition(pd.name, lo=lo, hi=hi)]
        if lo is None or hi is None:
            raise SqlError("EVERY requires both START and END")
        binder = Binder(self.catalog, self.store)
        step_lit = binder._expr(pd.every, _EmptyScope())
        if not isinstance(step_lit, E.Literal) \
                or not isinstance(step_lit.value, (int, float)):
            raise SqlError("EVERY step must be a numeric literal "
                           "(storage units: days for DATE)")
        step = int(step_lit.value) if isinstance(lo, int) else step_lit.value
        if not step or step <= 0:
            raise SqlError("EVERY step must be positive")
        out, k, cur = [], 1, lo
        while cur < hi:
            nxt = min(cur + step, hi)
            out.append(Partition(f"{pd.name}_{k}", lo=cur, hi=nxt))
            cur, k = nxt, k + 1
        return out

    @staticmethod
    def _validate_partitions(parts, kind, table) -> None:
        names = [p.name for p in parts]
        if len(set(names)) != len(names):
            raise SqlError(f"duplicate partition name in {table}")
        if sum(1 for p in parts if p.default) > 1:
            raise SqlError("multiple DEFAULT partitions")
        real = [p for p in parts if not p.default]
        if kind == "range":
            bounded = sorted(real, key=lambda p: (
                p.lo is not None, p.lo if p.lo is not None else 0))
            for a, b in zip(bounded, bounded[1:]):
                if a.hi is None or b.lo is None or b.lo < a.hi:
                    raise SqlError(
                        f"overlapping range partitions {a.name}/{b.name}")
        else:
            seen: set = set()
            for p in real:
                for v in p.values:
                    if v in seen:
                        raise SqlError(
                            f"value {v!r} in multiple list partitions")
                    seen.add(v)
        if not parts:
            raise SqlError("partitioned table needs at least one partition")

    def _alter_table(self, stmt: A.AlterTableStmt) -> str:
        """ALTER TABLE ... ADD | DROP PARTITION (cdbpartition.c's partition
        maintenance). DROP is O(1): the child storage table goes, no other
        partition moves."""
        schema = self.catalog.get(stmt.table)
        if not schema.is_partitioned:
            raise SqlError(f'table "{stmt.table}" is not partitioned')
        kind, pcol_name = schema.partition_by
        if stmt.action == "add_partition":
            new = self._build_partitions(stmt.partition,
                                         schema.column(pcol_name), kind)
            self._validate_partitions(schema.partitions + new, kind,
                                      stmt.table)
            schema.partitions.extend(new)
            self.catalog._save()
            with self._cache_mu:
                self._select_cache.clear()
            return "ALTER TABLE"
        part = schema.partition(stmt.partition_name)   # KeyError -> message
        child = part.storage_name(stmt.table)
        if len(schema.partitions) == 1:
            raise SqlError("cannot drop the last partition; DROP TABLE")
        schema.partitions = [p for p in schema.partitions
                             if p.name != part.name]
        self.catalog._save()
        self._note_drop(stmt.table)
        self.store.drop_table(child, [child])
        with self._cache_mu:
            self._select_cache.clear()
        self.executor.invalidate_table(stmt.table)
        return "ALTER TABLE"

    def _note_drop(self, table: str) -> None:
        self._drop_log.append(table)
        del self._drop_log[:-256]

    # ---- CREATE INDEX, DROP INDEX (pg_index's role) ----------------------
    def _create_index(self, stmt: A.CreateIndexStmt) -> str:
        """CREATE INDEX registers the index and builds the block-value
        index of every data file (or chunk) of the column now, so the
        first probe does not pay it. 'btree' and 'bitmap' both lower to
        the block index (storage/table_store.py)."""
        if stmt.using not in ("btree", "bitmap"):
            raise SqlError(f"unknown index access method {stmt.using!r}")
        for schema in (self.catalog.get(t) for t in self.catalog.tables):
            if stmt.name in schema.indexes:
                if stmt.if_not_exists:
                    return "CREATE INDEX"
                raise SqlError(f'index "{stmt.name}" already exists')
        schema = self.catalog.get(stmt.table)
        col = schema.column(stmt.column)
        if col.type.kind is T.Kind.TEXT and col.encoding == "raw":
            raise SqlError(
                "raw-encoded text cannot be indexed (block indexes probe "
                "storage values; raw storage has no per-row value column)")
        schema.indexes[stmt.name] = {"column": stmt.column,
                                     "using": stmt.using}
        self.catalog._save()
        self._build_index_sidecars(schema)
        with self._cache_mu:
            self._select_cache.clear()
        # staged inputs predate the index (same manifest version): drop
        # them so the next scan prunes
        self.executor._stage_cache.clear()
        return "CREATE INDEX"

    def _build_index_sidecars(self, schema) -> None:
        snap = self.store.manifest.snapshot()
        cols = {d["column"] for d in schema.indexes.values()}
        for storage in schema.storage_tables():
            self.store.build_block_indexes(storage, cols, snap)

    def _drop_index(self, stmt: A.DropIndexStmt) -> str:
        for schema in (self.catalog.get(t) for t in self.catalog.tables):
            if stmt.name in schema.indexes:
                del schema.indexes[stmt.name]
                self.catalog._save()
                with self._cache_mu:
                    self._select_cache.clear()
                # staged inputs an index pruned must not serve the scans
                # that no longer probe it
                self.executor._stage_cache.clear()
                return "DROP INDEX"
        if stmt.if_exists:
            return "DROP INDEX"
        raise SqlError(f'index "{stmt.name}" does not exist')

    def _create_extension(self, stmt) -> str:
        """Import the extension module (registering its functions) and
        record it in the catalog, which makes its functions visible to
        this Database's statements (reference:
        src/backend/commands/extension.c:1546)."""
        from greengage_tpu_torch import extensions as X

        if stmt.name in self.catalog.extensions:
            if stmt.if_not_exists:
                return "CREATE EXTENSION"
            raise ValueError(f'extension "{stmt.name}" already exists')
        X.load(stmt.name)
        self.catalog.extensions.append(stmt.name)
        self.catalog._save()
        return "CREATE EXTENSION"

    def _analyze(self, table: str | None) -> str:
        """ANALYZE [table]: per-column NDV/min-max/null-frac/MCV into the
        catalog (planner/stats.py)."""
        from greengage_tpu_torch.planner.stats import analyze_table

        names = [table] if table else list(self.catalog.tables)
        snap = self.store.manifest.snapshot()
        for n in names:
            schema = self.catalog.get(n)
            schema.stats = analyze_table(self.store, schema, snap)
        self.catalog._save()   # a directory keeps the statistics
        return "ANALYZE"

    def load_table(self, table: str, columns: dict, valids: dict | None = None):
        """Bulk load host arrays (the gpfdist/COPY fast path); a
        partitioned table's rows are routed to its children."""
        with self._write_lock.shared(), \
                (self._table_lock(table)
                 if table in self.catalog
                 and self._append_needs_table_lock(table) else _NullSlot()):
            return self._write_rows(table, columns, valids)

    def _write_rows(self, table: str, columns, valids) -> int:
        """Every append (INSERT, COPY, ``load_table``): a partitioned
        table's rows are routed to its children here."""
        schema = self.catalog.get(table)
        if schema.is_partitioned and "#" not in table:
            return self._write_routed(schema, columns, valids or {})
        return self.store.insert(table, columns, valids)

    def _write_routed(self, schema, columns, valids) -> int:
        """Split a row batch by partition and append each slice to its
        child table, every child in ONE commit (the JAX session's
        autocommit transaction over the children). The whole batch is
        checked before any child stages."""
        for c in schema.columns:
            v = valids.get(c.name)
            if not c.nullable and v is not None and not np.all(v):
                raise SqlError(
                    f'null value in column "{c.name}" violates not-null '
                    "constraint")
        _kind, pcol = schema.partition_by
        col = schema.column(pcol)
        raw = columns[pcol]
        if col.type.kind is T.Kind.DATE and not isinstance(raw, np.ndarray):
            vals = np.array([T.date_to_days(v) for v in raw], dtype=np.int32)
        elif col.type.kind is T.Kind.DECIMAL \
                and not isinstance(raw, np.ndarray):
            vals = np.array([T.decimal_to_int(v, col.type.scale)
                             for v in raw], dtype=np.int64)
        else:
            vals = np.asarray(raw, dtype=col.type.np_dtype)
        pidx = np.asarray(schema.route_rows(vals, valids.get(pcol)))
        if (pidx < 0).any():
            bad = vals[pidx < 0][0]
            raise SqlError(
                f"no partition of {schema.name} accepts value {bad!r} "
                "(and there is no DEFAULT partition)")

        def _slice(v, m):
            if isinstance(v, T.Coded):
                return T.Coded(v.vocab, v.codes[m])
            if isinstance(v, np.ndarray):
                return v[m]
            return np.asarray(v, dtype=object)[m]

        items = []
        for i, p in enumerate(schema.partitions):
            m = pidx == i
            if not m.any():
                continue
            items.append((p.storage_name(schema.name),
                          {k: _slice(v, m) for k, v in columns.items()},
                          {k: _slice(v, m) for k, v in valids.items()
                           if v is not None}))
        return self.store.insert_parts(items)

    # ---- INSERT, COPY (the JAX session's _insert, _copy) ----------------
    def _insert(self, stmt: A.InsertStmt) -> str:
        schema = self.catalog.get(stmt.table)
        if stmt.query is not None:
            return self._insert_select(schema, stmt)
        names = stmt.columns or schema.column_names
        if set(names) != set(schema.column_names):
            raise SqlError("INSERT must provide all columns")
        cols: dict[str, list] = {n: [] for n in names}
        valids: dict[str, list] = {n: [] for n in names}
        binder = Binder(self.catalog, self.store)
        scope = _EmptyScope()
        for row in stmt.rows:
            if len(row) != len(names):
                raise SqlError("INSERT row arity mismatch")
            for n, v in zip(names, row):
                col = schema.column(n)
                lit = binder._expr(v, scope)
                if not isinstance(lit, E.Literal):
                    raise SqlError("INSERT values must be literals")
                lit = binder._coerce_literal(lit, col.type)
                if lit.value is None:
                    valids[n].append(False)
                    cols[n].append(_zero_for(col.type))
                else:
                    valids[n].append(True)
                    cols[n].append(lit.value)
        enc_cols, enc_valids = {}, {}
        for n in names:
            col = schema.column(n)
            if col.type.kind is T.Kind.TEXT:
                enc_cols[n] = cols[n]
            else:
                enc_cols[n] = np.array(cols[n], dtype=col.type.np_dtype)
            va = np.array(valids[n], dtype=bool)
            if not va.all():
                enc_valids[n] = va
        n = self._write_rows(stmt.table, enc_cols, enc_valids)
        return f"INSERT 0 {n}"

    def _insert_select(self, schema, stmt) -> str:
        """INSERT INTO t SELECT ...: run the query, convert the presented
        values back to storage representation (DECIMAL re-scaled with
        round-half-away, the engine's numeric rounding) and append."""
        res = (self._select(stmt.query)
               if not isinstance(stmt.query, A.UnionStmt)
               else self._execute(stmt.query))
        names = stmt.columns or schema.column_names
        if set(names) != set(schema.column_names):
            raise SqlError("INSERT must provide all columns")
        if len(res.columns) != len(names):
            raise SqlError(
                f"INSERT SELECT arity mismatch: query returns "
                f"{len(res.columns)} columns, target has {len(names)}")
        cols: dict = {}
        valids: dict = {}
        for n, oid in zip(names, res._order):
            c = schema.column(n)
            data = res.cols[oid]
            v = res.valids.get(oid)
            if c.type.kind is T.Kind.DECIMAL:
                f = np.asarray(data, dtype=np.float64) * (10.0 ** c.type.scale)
                data = (np.floor(np.abs(f) + 0.5) * np.sign(f)).astype(
                    np.int64)
            elif c.type.kind is T.Kind.DATE:
                data = (np.asarray(data, dtype="datetime64[D]")
                        - np.datetime64("1970-01-01", "D")).astype(np.int32)
            elif c.type.kind is T.Kind.TEXT:
                data = ["" if s is None else str(s) for s in data]
            else:
                data = np.asarray(data)
                if v is not None:
                    # NULL slots may carry NaN or garbage: zero them so the
                    # cast cannot fail
                    data = np.where(v, data, 0)
                data = data.astype(c.type.np_dtype)
            cols[n] = data
            if v is not None:
                valids[n] = np.asarray(v, dtype=bool)
        n = self._write_rows(schema.name, cols, valids)
        return f"INSERT 0 {n}"

    def _copy(self, stmt: A.CopyStmt) -> str:
        """COPY t FROM 'file' [WITH (delimiter, header, null,
        segment_reject_limit)]: the native reader first
        (storage/csv_native.py), the quoting-aware reader for what it
        cannot parse, rejected rows logged under SREH. COPY t TO 'file'
        writes the table's rows as CSV. A gpfdist source is the ingest
        plane's (ROADMAP Queue 1 item 10)."""
        from greengage_tpu_torch.storage import csv_native

        schema = self.catalog.get(stmt.table)
        if stmt.path.startswith("gpfdist://"):
            raise SqlError("COPY from a gpfdist:// source is not ported yet "
                           "(ROADMAP Queue 1 item 10, runtime/ingest.py)")
        delim = stmt.options.get("delimiter", ",")
        header = str(stmt.options.get("header", "false")).lower() in (
            "true", "1")
        null_s = stmt.options.get("null", "")
        if stmt.direction == "to":
            res = self._select(A.SelectStmt(
                items=[A.SelectItem(A.Star())],
                from_=[A.BaseTable(stmt.table)]))
            n = csv_native.write_file(stmt.path, res.rows(), delim,
                                      schema.column_names if header
                                      else None, null_s)
            return f"COPY {n}"
        reject_limit = stmt.options.get("segment_reject_limit")
        reject_limit = int(reject_limit) if reject_limit is not None else None
        if reject_limit is None:
            parsed = None
            try:
                parsed = csv_native.parse_file(stmt.path, schema, delim,
                                               header, null_s)
            except (csv_native.CsvFallback, ValueError):
                # quoted fields, custom NULL markers and bad data go to the
                # reader below (its error names the offending line); the
                # try covers the parse alone, never a write
                pass
            if parsed is not None:
                n = self._write_rows(stmt.table, *parsed)
                return f"COPY {n}"
        with open(stmt.path, "rb") as f:
            blob = f.read()
        rejects: list = []
        try:
            text = blob.decode("utf-8")
        except UnicodeDecodeError:
            # undecodable lines are rejected, the numbering kept
            lines = []
            for li, raw in enumerate(blob.split(b"\n")):
                try:
                    lines.append(raw.decode("utf-8"))
                except UnicodeDecodeError:
                    rejects.append((li + 1, repr(raw), "invalid UTF-8"))
                    lines.append("")
            text = "\n".join(lines)
        cols, valids, rej = csv_native.parse_csv_rows(text, schema, delim,
                                                      header, null_s)
        rejects.extend(rej)
        if rejects and reject_limit is None:
            line, _raw, err = rejects[0]
            raise SqlError(f"COPY line {line}: {err}")
        if reject_limit is not None and len(rejects) > reject_limit:
            raise SqlError(
                f"COPY aborted: {len(rejects)} rejected rows exceed "
                f"SEGMENT REJECT LIMIT {reject_limit}")
        if rejects:
            csv_native.append_error_log(self.path, stmt.table, rejects)
        enc_cols, enc_valids = {}, {}
        for c in schema.columns:
            va = np.array(valids[c.name], dtype=bool)
            if c.type.kind is T.Kind.TEXT:
                enc_cols[c.name] = cols[c.name]
            else:
                enc_cols[c.name] = np.array(cols[c.name],
                                            dtype=c.type.np_dtype)
            if not va.all():
                enc_valids[c.name] = va
        n = self._write_rows(stmt.table, enc_cols, enc_valids)
        tag = f"COPY {n}"
        if rejects:
            tag += f" (rejected {len(rejects)} rows, logged)"
        return tag

    def error_log(self, table: str) -> list[dict]:
        """Rejected-row log of a table (gp_read_error_log analog)."""
        from greengage_tpu_torch.storage import csv_native

        return csv_native.read_error_log(self.path, table)

    # ---- DELETE, UPDATE, VACUUM (the visimap and SplitUpdate roles) ------
    def _run_raw(self, sel_stmt):
        """Plan and run a SELECT, its columns in storage form."""
        planned, consts, outs = self._plan(sel_stmt)
        res = self.executor.run(planned, consts, raw=True)
        return res, outs

    def _check_no_raw_dml(self, table: str) -> None:
        if self.store.raw_column_names(table):
            raise SqlError(
                f'table "{table}" has raw-encoded TEXT columns: raw TEXT is '
                "not ported yet (ROADMAP Queue 1 item 1e)")

    def _replace_table(self, schema, enc, valids) -> None:
        """Republish a table whole. A partitioned table routes the rows by
        partition key and replaces EVERY child in one commit (a child that
        gets no rows becomes empty): an UPDATE may move rows between
        partitions."""
        if not schema.is_partitioned:
            self.store.replace_contents(schema.name, enc, valids)
            return
        _kind, pcol = schema.partition_by
        pidx = np.asarray(schema.route_rows(enc[pcol], valids.get(pcol)))
        if (pidx < 0).any():
            bad = enc[pcol][pidx < 0][0]
            raise SqlError(
                f"no partition of {schema.name} accepts value {bad!r} "
                "(and there is no DEFAULT partition)")
        self.store.replace_parts(
            [(p.storage_name(schema.name),
              {k: v[pidx == i] for k, v in enc.items()},
              {k: v[pidx == i] for k, v in valids.items()})
             for i, p in enumerate(schema.partitions)])

    def _predicate_mask(self, table: str, where) -> np.ndarray:
        """A DML predicate over every visible row: -> bool mask in Gather
        order (segment-major, storage row order; the plain projection
        keeps it), NULL = False."""
        sel = A.SelectStmt(items=[A.SelectItem(where, alias="__dml_pred")],
                           from_=[A.BaseTable(table)])
        res, outs = self._run_raw(sel)
        o = outs[0]
        val = np.asarray(res.cols[o.id]).astype(bool)
        v = res.valids.get(o.id)
        return val if v is None else (val & np.asarray(v, bool))

    def _visimap_masks(self, table: str, pred_mask: np.ndarray) -> dict:
        """A predicate mask over the VISIBLE rows -> per-segment bitmaps
        over all the segment's rows (1 = deleted). A replicated table
        reads one copy and stamps every segment with its bitmap (its
        copies share row order)."""
        schema = self.catalog.get(table)
        snap = self.store.manifest.snapshot()
        replicated = schema.policy.kind is PolicyKind.REPLICATED
        nseg = schema.policy.numsegments
        full = self.store.segment_rowcounts(table, snap)
        masks: dict = {}
        off = 0
        for seg in ([0] if replicated else range(nseg)):
            keep = self.store.delmask_keep(table, seg, snap)
            live = int(keep.sum()) if keep is not None else full[seg]
            m = pred_mask[off: off + live]
            off += live
            if not m.any():
                continue
            newdel = (np.zeros(full[seg], np.uint8) if keep is None
                      else (~keep).astype(np.uint8))
            live_pos = (np.flatnonzero(keep) if keep is not None
                        else np.arange(full[seg]))
            newdel[live_pos[m]] = 1
            masks[seg] = newdel
        if off != len(pred_mask):
            raise RuntimeError(
                f"DML scan returned {len(pred_mask)} rows but storage holds "
                f"{off} visible rows: a concurrent write raced the "
                "statement; retry")
        if replicated and masks:
            masks = {s: masks[0] for s in range(nseg)}
        return masks

    def _delete(self, stmt: A.DeleteStmt) -> str:
        """DELETE: a bitmap of the rows the predicate holds for (no data
        file rewritten); without WHERE the table is republished empty.
        The tag counts visible rows only."""
        self._check_no_raw_dml(stmt.table)
        _reject_dml_subqueries(stmt.where)
        schema = self.catalog.get(stmt.table)
        total = sum(self.store.live_rowcounts(stmt.table))
        if stmt.where is None:
            empty = {c.name: np.empty(0, dtype=c.type.np_dtype)
                     for c in schema.columns}
            self._replace_table(schema, empty, {})
            return f"DELETE {total}"
        if not schema.is_partitioned:
            mask = self._predicate_mask(stmt.table, stmt.where)
            masks = self._visimap_masks(stmt.table, mask)
            if masks:
                self.store.set_delmask(stmt.table, masks)
            return f"DELETE {int(mask.sum())}"
        # a partitioned table republishes its survivors (the predicate
        # false or NULL), as the JAX session does: per-child bitmaps would
        # need each child's row span in the scan
        survive = A.Bin("or", A.Unary("not", stmt.where),
                        A.IsNullTest(stmt.where, False))
        sel = A.SelectStmt(items=[A.SelectItem(A.Star())],
                           from_=[A.BaseTable(stmt.table)], where=survive)
        res, outs = self._run_raw(sel)
        enc, valids = {}, {}
        for c, o in zip(schema.columns, outs):
            enc[c.name] = np.ascontiguousarray(res.cols[o.id],
                                               dtype=c.type.np_dtype)
            v = res.valids.get(o.id)
            if v is not None:
                valids[c.name] = v
        self._replace_table(schema, enc, valids)
        return f"DELETE {total - len(res)}"

    def _update(self, stmt: A.UpdateStmt) -> str:
        """UPDATE: the matched rows' old versions marked in the bitmap and
        their new versions appended, placed by their (new) distribution
        key, in one commit; without WHERE the table is republished."""
        self._check_no_raw_dml(stmt.table)
        _reject_dml_subqueries(stmt.where)
        schema = self.catalog.get(stmt.table)
        seen = set()
        for cname, _ in stmt.sets:
            if cname not in schema.column_names:
                raise SqlError(f'column "{cname}" of relation '
                               f'"{stmt.table}" does not exist')
            if cname in seen:
                raise SqlError(f'multiple assignments to column "{cname}"')
            seen.add(cname)
        # one raw pass: every column, one slot per SET evaluated on the
        # device, then the flag, tracked by position (user names never
        # collide with these)
        items = [A.SelectItem(A.Star())]
        text_literals = {}
        device_slots: dict[str, int] = {}
        ncols = len(schema.columns)
        next_slot = ncols
        dict_dirty = False
        for cname, e in stmt.sets:
            col = schema.column(cname)
            if col.type.kind is T.Kind.TEXT:
                if isinstance(e, A.Str):
                    code = self.store.dictionary(stmt.table, cname).encode(
                        [e.value])[0]
                    dict_dirty = True
                    text_literals[cname] = np.int32(code)
                    continue
                if isinstance(e, A.Null):
                    text_literals[cname] = None
                    continue
                items.append(A.SelectItem(e, alias=f"__new_{cname}"))
            else:
                tname, typmod = _sql_type_name(col.type)
                items.append(A.SelectItem(A.CastExpr(e, tname, typmod),
                                          alias=f"__new_{cname}"))
            device_slots[cname] = next_slot
            next_slot += 1
        if dict_dirty:
            self.store.flush_dicts(stmt.table)
        flag = stmt.where if stmt.where is not None else A.Bool(True)
        items.append(A.SelectItem(flag, alias="__upd"))
        flag_slot = next_slot
        # a partitioned table (and an UPDATE without WHERE) republishes
        visimap = not schema.is_partitioned and stmt.where is not None
        pred_mask = (self._predicate_mask(stmt.table, stmt.where)
                     if visimap else None)
        sel = A.SelectStmt(items=items, from_=[A.BaseTable(stmt.table)],
                           where=stmt.where if visimap else None)
        res, outs = self._run_raw(sel)
        fo = outs[flag_slot]
        fval = res.cols[fo.id].astype(bool)
        fv = res.valids.get(fo.id)
        mask = fval if fv is None else (fval & fv)   # NULL: not updated
        enc, valids = {}, {}
        for c, o in zip(schema.columns, outs[:ncols]):
            old = np.ascontiguousarray(res.cols[o.id], dtype=c.type.np_dtype)
            oldv = res.valids.get(o.id)
            oldv = np.ones(len(old), bool) if oldv is None else oldv
            if c.name in text_literals:
                lit = text_literals[c.name]
                if lit is None:
                    new, newv = old, np.zeros(len(old), bool)
                else:
                    new = np.full(len(old), lit, dtype=np.int32)
                    newv = np.ones(len(old), bool)
            elif c.name in device_slots:
                no = outs[device_slots[c.name]]
                if (c.type.kind is T.Kind.TEXT and no.dict_ref is not None
                        and no.dict_ref != (stmt.table, c.name)):
                    raise SqlError("text UPDATE from a different dictionary "
                                   "is not supported")
                new = np.ascontiguousarray(res.cols[no.id],
                                           dtype=c.type.np_dtype)
                nv = res.valids.get(no.id)
                newv = np.ones(len(new), bool) if nv is None else nv
            else:
                new, newv = old, oldv
            merged = np.where(mask, new, old)
            mergedv = np.where(mask, newv, oldv)
            enc[c.name] = merged.astype(c.type.np_dtype)
            if not mergedv.all():
                valids[c.name] = mergedv
        if visimap:
            if len(res) != int(pred_mask.sum()):
                raise RuntimeError(
                    f"UPDATE matched-row scan returned {len(res)} rows but "
                    f"the predicate pass marked {int(pred_mask.sum())}: a "
                    "concurrent write raced the statement; retry")
            masks = self._visimap_masks(stmt.table, pred_mask)
            if masks or len(res):
                self.store.update_split(stmt.table, masks, enc, valids)
            return f"UPDATE {int(pred_mask.sum())}"
        self._replace_table(schema, enc, valids)
        return f"UPDATE {int(mask.sum())}"

    def vacuum(self, table: str | None = None) -> dict:
        """Compact deletion bitmaps away (lazy VACUUM for the visimap):
        every table carrying a bitmap is rewritten with its live rows
        only, at its width. -> {table: live rows kept}."""
        with self._write_lock:
            compacted: dict = {}
            snap = self.store.manifest.snapshot()
            for t, tmeta in snap.get("tables", {}).items():
                if table is not None and t != table:
                    continue
                if tmeta.get("delmask"):
                    compacted[t] = self.store.rewrite_table(
                        t, self.catalog.get(t).policy.numsegments)
            self.store.reap_gc()
        return compacted

    # ---- WITH RECURSIVE (nodeRecursiveunion.c / WorkTableScan role) ------
    def _select_recursive(self, stmt, rctes: dict) -> Result:
        """Fixpoint iteration in the session: each recursive CTE is
        materialised by running its base term, then its recursive term
        against a worktable of the previous iteration's NEW rows until
        none appear. Every term runs as an ordinary statement; the
        accumulation tables are real (ephemeral) tables, so the final
        query plans and distributes as any other. UNION (not ALL) drops
        rows seen in earlier iterations, which is also the cycle guard."""
        max_iter = 500
        mapping: dict[str, str] = {}
        created: list[str] = []
        # unique names: concurrent statements, and other processes on the
        # same directory, never collide
        uid = f"{os.getpid():x}_{next(_REC_COUNTER)}"
        try:
            for name, rc in rctes.items():
                acc = f"__rec_{uid}_{name}"
                wtbl = f"__recw_{uid}_{name}"
                base = _rename_base_tables(_copy.deepcopy(rc.base), mapping)
                # bound once for exact output types (a constant-only base
                # term skips the binder and infers them from its result)
                outs0 = None
                try:
                    _, outs0 = Binder(
                        self.catalog, self.store,
                        subquery_executor=self._scalar_subquery
                    ).bind_select(_copy.deepcopy(base))
                except SqlError:
                    pass
                r = self._execute(base)
                if outs0 is None:
                    outs0 = [_inferred_col(nm, np.asarray(r.cols[cid]))
                             for nm, cid in zip(r.columns, r._order)]
                coldefs = ", ".join(f"{c.name} {_ddl_type(c.type)}"
                                    for c in outs0)
                for t in (acc, wtbl):
                    self.sql(f"drop table if exists {t}")
                    self.sql(f"create table {t} ({coldefs}) "
                             "distributed randomly")
                    created.append(t)
                rows = r.rows()
                seen = set(rows) if not rc.union_all else None
                if seen is not None:
                    rows = list(seen)
                self._load_rows(acc, outs0, rows)
                cur = rows
                it = 0
                while cur:
                    it += 1
                    if it > max_iter:
                        raise QueryError(
                            f'recursive CTE "{name}" exceeded {max_iter} '
                            "iterations (cycle? use UNION instead of UNION "
                            "ALL, or add a bound)")
                    self.sql(f"delete from {wtbl}")
                    self._load_rows(wtbl, outs0, cur)
                    rec = _rename_base_tables(_copy.deepcopy(rc.rec),
                                              {**mapping, name: wtbl})
                    nr = self._execute(rec).rows()
                    if seen is not None:
                        fresh = []
                        for t in nr:
                            if t not in seen:
                                seen.add(t)
                                fresh.append(t)
                        nr = fresh
                    if nr:
                        self._load_rows(acc, outs0, nr)
                    cur = nr
                mapping[name] = acc
            final = _rename_base_tables(_copy.deepcopy(stmt), mapping)
            if hasattr(final, "_recursive_ctes"):
                del final._recursive_ctes
            return self._execute(final)
        finally:
            for t in created:
                try:
                    self.sql(f"drop table if exists {t}")
                except Exception:
                    pass

    def _load_rows(self, table: str, outs, rows: list) -> None:
        """Host row tuples -> one bulk load of ``outs``' types (DECIMAL
        results arrive descaled as float64 and reload as double
        precision, _ddl_type)."""
        cols: dict = {}
        valids: dict = {}
        epoch = np.datetime64("1970-01-01")
        for i, c in enumerate(outs):
            vals = [r[i] for r in rows]
            mask = np.array([v is not None for v in vals], bool)
            kind = c.type.kind
            if kind is T.Kind.TEXT:
                cols[c.name] = ["" if v is None else str(v) for v in vals]
            elif kind in (T.Kind.FLOAT64, T.Kind.DECIMAL):
                cols[c.name] = np.array(
                    [0.0 if v is None else float(v) for v in vals],
                    np.float64)
            elif kind is T.Kind.DATE:
                cols[c.name] = np.array(
                    [0 if v is None else
                     int((np.datetime64(v, "D") - epoch)
                         .astype("timedelta64[D]").astype(np.int64))
                     for v in vals], np.int32)
            else:
                cols[c.name] = np.array(
                    [0 if v is None else int(v) for v in vals],
                    c.type.np_dtype)
            valids[c.name] = None if mask.all() else mask
        if rows:
            self.load_table(table, cols, valids)

    # ------------------------------------------------------------------
    def _plan(self, stmt, force_multi_join: bool = False,
              info: dict | None = None):
        """-> (planned tree, binder consts, output columns): bind, then
        parallelize (Motion insertion, loci, estimates, the feedback
        store's row-scale corrections while ``cost_feedback`` is on). IN,
        EXISTS and NOT IN subqueries arrive from the binder as semi, anti
        and null-aware anti joins. ``force_multi_join`` plans every
        equi-join with the multi-match (duplicate-capable) join. ``info``
        receives ``memo_used`` (did the memo order the joins)."""
        binder = Binder(self.catalog, self.store,
                        subquery_executor=self._scalar_subquery)
        logical, outs = binder.bind_select(stmt)
        planned = plan_query(logical, self.catalog, self.store,
                             self.numsegments,
                             force_multi_join=force_multi_join,
                             feedback=(self.feedback
                                       if bool(self.settings.cost_feedback)
                                       else None))
        if self.settings.plan_validate:
            # checkPlan before dispatch (analysis/plancheck.py): a plan that
            # breaks a Motion, locality or prune invariant dies here with
            # its node path, never as a wrong answer after dispatch
            validate_plan(planned, self.catalog)
        if info is not None:
            info["memo_used"] = binder.memo_used
        return planned, binder.consts, outs

    def _select(self, stmt) -> Result:
        rctes = getattr(stmt, "_recursive_ctes", None)
        if rctes:
            return self._select_recursive(stmt, rctes)
        if isinstance(stmt, A.SelectStmt) and not stmt.from_ \
                and not stmt.group_by and not stmt.having \
                and not stmt.distinct and not stmt.order_by \
                and not any(_contains_agg(it.expr) or isinstance(it.expr,
                                                                 A.Star)
                            for it in stmt.items):
            # screened BEFORE the host fast path, as the JAX session does:
            # a bind-time failure after an InitPlan scalar subquery ran
            # would run that subquery again on the device path
            try:
                return self._const_select(stmt)
            except SqlError:
                pass   # the host path's residual rejections (non-constant
                # text expressions) go on to the ConstRel device path
        t0 = time.perf_counter()
        with _trace.span("plan", cat="front"):
            planned, consts, _outs, exec_key = self._cached_plan(stmt)
        info = dict(self._plan_cache_info)
        plan_ms = (time.perf_counter() - t0) * 1e3
        # admission (the ResLockPortal analog): the resource group's slot
        # and the resource queue's, held while the statement runs — a
        # batched member holds its slot while it waits for batch-mates
        with self._admission():
            if self._batch_eligible(consts):
                # batched serving: join the admission window of this
                # statement's shape; one batched program serves every
                # member. None = the batch fell back: run classically
                res = self._batcher().submit(planned, consts, exec_key,
                                             consts["@params@"])
                if res is not None:
                    res.stats.update(plan_ms=plan_ms, plan_cache=info,
                                     multi_join_replan=False)
                    self._feedback_reconcile(planned, exec_key, res)
                    return res
            res, planned, exec_key, replanned = self._run_or_replan(
                stmt, planned, consts, exec_key)
            if replanned:
                info = dict(self._plan_cache_info)
        res.stats.update(plan_ms=plan_ms, multi_join_replan=replanned,
                         plan_cache=info)
        self._feedback_reconcile(planned, exec_key, res)
        return res

    def _run_or_replan(self, stmt, planned, consts, exec_key,
                       instrument: bool = False):
        """Run a planned SELECT. Where a unique-key join meets duplicate
        build keys at run time (the uniqueness heuristic was wrong), re-plan
        with the multi-match join everywhere, as the JAX session does,
        cached under the plain key so repeats skip the failing plan, and
        run that. -> (result, planned, exec key, re-planned?)."""
        try:
            return (self.executor.run(planned, consts, cache_key=exec_key,
                                      instrument=instrument),
                    planned, exec_key, False)
        except QueryError as e:
            if "duplicate keys" not in str(e) or exec_key.endswith("#multi"):
                raise
        planned, consts, _outs, exec_key = self._cached_plan(
            stmt, force_multi_join=True)
        return (self.executor.run(planned, consts, cache_key=exec_key,
                                  instrument=instrument),
                planned, exec_key, True)

    # ---- the cost-feedback loop (planner/feedback.py) ------------------
    def _feedback_reconcile(self, planned, exec_key: str, res) -> None:
        """Close the measurement loop after one execution: per-node actual
        rows (the Filter counters of every run, every node's when
        instrumented) and the exact row count reconcile against the
        planner's ``est_rows`` per structural digest; the measured program
        bytes against ``est_bytes`` per shape. Batched members share one
        program and are skipped, as in the JAX session: the classic runs
        of the shape feed the loop."""
        if not bool(self.settings.cost_feedback):
            return
        stats = res.stats or {}
        if stats.get("batched"):
            return
        key_sig = shape_of(exec_key)
        mem = stats.get("mem") or {}
        measured = mem.get("measured") or {}
        measured_total = (measured.get("temp_bytes", 0)
                          + measured.get("argument_bytes", 0)
                          + measured.get("output_bytes", 0)) or None
        self.feedback.reconcile(
            key_sig, planned, len(res), stats.get("node_rows"),
            measured_bytes=measured_total, est_bytes=mem.get("est_bytes"))

    # ---- EXPLAIN [ANALYZE] ---------------------------------------------
    def _explain(self, stmt: A.ExplainStmt) -> Result:
        """EXPLAIN: the planned tree (planner/logical.describe) under an
        ``Optimizer:`` line naming the planner that ordered the joins.
        EXPLAIN ANALYZE runs the statement's cached plan as an
        instrumented program (every node counts its rows; a program of its
        own for measurement and admission, exec/executor.py) and annotates
        each node with its actual rows, its share of the device time in
        proportion to its rows (one program has no per-node clocks), a
        Motion's moved bytes and the node's slice of the memory estimate,
        then the statement-level lines. The run feeds the feedback store
        with every node's rows."""
        if not isinstance(stmt.query, (A.SelectStmt, A.UnionStmt)):
            raise SqlError("EXPLAIN supports SELECT only")
        if not stmt.analyze:
            info: dict = {}
            planned, _consts, _outs = self._plan(stmt.query, info=info)
            text = ("Optimizer: %s\n" % (
                "memo (Cascades-lite)" if info.get("memo_used")
                else "fallback (left-deep DP/greedy)")) + describe(planned)
        else:
            planned, consts, _outs, ek = self._cached_plan(stmt.query)
            pc_info = dict(self._plan_cache_info)
            # the SELECT's multi-match re-plan too, so EXPLAIN ANALYZE
            # answers wherever the statement does
            res, planned, ek, _r = self._run_or_replan(
                stmt.query, planned, consts, ek, instrument=True)
            self._feedback_reconcile(planned, ek, res)
            s = res.stats or {}
            text = describe(planned,
                            annot=self._analyze_annotations(planned, s))
            text += (f"\n Plan cache: "
                     f"{'hit' if pc_info.get('hit') else 'miss'}"
                     f"{' (fallback: unparameterizable shape)' if pc_info.get('fallback') else ''}"
                     f", {pc_info.get('params', 0)} params hoisted, "
                     f"compile {s.get('compile_ms', 0)} ms")
            text += (
                f"\n Execution time: {res.wall_ms:.2f} ms, rows: {len(res)}"
                f"\n Segments: {s.get('segments')}, capacity tiers used: "
                f"{s.get('tiers_used')}"
                f"\n Tables scanned: {', '.join(sorted(collect_scans(planned)))}")
            if s.get("stage_ms") is not None \
                    and s.get("dispatch_ms") is not None:
                text += (f"\n Host data path: staging {s['stage_ms']:.2f} ms"
                         f", device compute {s['dispatch_ms']:.2f} ms, "
                         f"result fetch {s['fetch_ms']:.2f} ms")
            mline = self._memory_line(s.get("mem"))
            if mline:
                text += "\n " + mline
            if s.get("fused_gate"):
                # what ran: the CUDA kernel on a card, its plain torch
                # version on the CPU (ops/fused_agg.py)
                route = "cuda" if self.device.type == "cuda" else "plain"
                text += f"\n Fused dense-agg kernel: {route}"
            io = s.get("scan_io") or {}
            if io:
                text += (f"\n Scan I/O: {io.get('scan_files_read', 0)} files"
                         f" read, {io.get('scan_bytes_decoded', 0)} bytes "
                         f"decoded, block cache "
                         f"{io.get('scan_cache_hit', 0)} hit / "
                         f"{io.get('scan_cache_miss', 0)} miss / "
                         f"{io.get('scan_cache_evict', 0)} evicted")
            for t, (kept, total) in (s.get("zone_prune") or {}).items():
                text += f"\n Zone-map prune {t}: {kept}/{total} blocks"
            for t, (kept, total) in (s.get("dynamic_prune") or {}).items():
                text += (f"\n Dynamic partition selector {t}: "
                         f"{kept}/{total} children staged")
            if s.get("spill_passes"):
                text += f"\n Spill passes: {s['spill_passes']}"
            for k, v in (s.get("metrics") or {}).items():
                if not k.startswith("nrows_"):
                    text += f"\n {k}: {v}"
        r = Result(columns=["QUERY PLAN"],
                   cols={"p": np.array(text.split("\n"), dtype=object)},
                   valids={}, _order=["p"])
        r.plan_text = text
        return r

    @staticmethod
    def _memory_line(mem: dict | None) -> str | None:
        """The statement-level EXPLAIN ANALYZE Memory line: the admission
        estimate beside the measured program bytes (exec/executor.py
        ``_measure``: args, temps, output) and, on a card, the allocator's
        peak."""
        if not mem:
            return None
        line = (f"Memory: vmem estimate "
                f"{mem.get('est_bytes', 0) / 1e6:.1f} MB/segment")
        meas = mem.get("measured")
        if meas:
            total = (meas.get("argument_bytes", 0)
                     + meas.get("temp_bytes", 0)
                     + meas.get("output_bytes", 0))
            line += (f"; executable measured: "
                     f"args {meas.get('argument_bytes', 0) / 1e6:.1f}"
                     f" + temps {meas.get('temp_bytes', 0) / 1e6:.1f}"
                     f" + out {meas.get('output_bytes', 0) / 1e6:.1f}"
                     f" = {total / 1e6:.1f} MB")
        if mem.get("admitted_by") == "measured":
            line += " (admitted by measured bytes)"
        if mem.get("device_peak_bytes_in_use") is not None:
            line += (f"; device peak "
                     f"{mem['device_peak_bytes_in_use'] / 1e6:.1f} MB")
        return line

    @staticmethod
    def _analyze_annotations(planned, s: dict) -> dict:
        """Per-node EXPLAIN ANALYZE annotations, keyed by id(plan node) as
        describe() takes them: actual rows out, the device time split in
        proportion to each node's rows (host-attributed), a Motion's moved
        bytes (rows x output row width) and the node's slice of the memory
        estimate."""
        from greengage_tpu_torch.planner.logical import Motion as _Motion

        node_rows = s.get("node_rows") or {}
        if not node_rows:
            return {}
        node_mem = s.get("node_est_bytes") or {}
        id2node = {}
        stack = [planned]
        while stack:
            p = stack.pop()
            id2node[id(p)] = p
            stack.extend(p.children)
        total = sum(node_rows.values())
        compute = float(s.get("dispatch_ms") or 0.0)
        annot = {}
        for pid, n in node_rows.items():
            parts = [f"actual rows={n}"]
            if total > 0 and compute > 0:
                parts.append(f"device ~{compute * n / total:.2f} ms "
                             f"(host-attributed)")
            node = id2node.get(pid)
            if isinstance(node, _Motion):
                width = sum(int(c.type.np_dtype.itemsize)
                            for c in node.out_cols())
                parts.append(f"motion ~{n * width} B")
            mb = node_mem.get(pid)
            if mb:
                parts.append(f"memory ~{mb >> 10} KB")
            annot[pid] = ", ".join(parts)
        return annot

    # ---- admission (runtime/resgroup.py, runtime/resqueue.py) ----------
    def _admission(self):
        """Statement admission: a resource-group slot (weighted backoff
        when the global cap binds) with the resource queue's; either is a
        no-op when unconfigured. The wait is metered into the
        ``queue_wait_ms`` histogram and the statement's trace. The group
        slot binds the group's memory cap to the thread
        (exec/executor.effective_limit_bytes) and charges the group the
        host-clock time until the statement's result is on the host."""
        t0 = time.monotonic()
        st = ExitStack()
        try:
            with _trace.span("admission", cat="queue"):
                st.enter_context(self.resgroups.admit())
                st.enter_context(self.resqueue.admit())
        except BaseException:
            # a queue timeout after the group slot was granted releases
            # the slot (and the thread's group memory cap)
            st.close()
            raise
        finally:
            histograms.observe("queue_wait_ms",
                               (time.monotonic() - t0) * 1e3)
        return st

    def resgroup_status(self) -> list[dict]:
        """gp_toolkit.gp_resgroup_status analog."""
        return self.resgroups.status()

    def _resource_group(self, stmt) -> str:
        """CREATE / ALTER / DROP RESOURCE GROUP; the definitions (built-ins
        included, so tuned caps survive) persist in the catalog, as in the
        JAX session."""
        allowed = {"concurrency", "memory_limit_mb", "cpu_weight"}
        bad = set(stmt.options) - allowed
        if bad:
            raise SqlError(f"unknown resource group option(s): "
                           f"{', '.join(sorted(bad))}")
        if stmt.action == "create":
            self.resgroups.create(stmt.name, **stmt.options)
            tag = "CREATE RESOURCE GROUP"
        elif stmt.action == "drop":
            self.resgroups.drop(stmt.name)
            tag = "DROP RESOURCE GROUP"
        else:
            self.resgroups.alter(stmt.name, **stmt.options)
            tag = "ALTER RESOURCE GROUP"
        self.catalog.resource_groups = [
            g.to_dict() for g in self.resgroups.groups.values()]
        self.catalog._save()
        return tag

    # ---- batched serving (exec/batchserve.py) --------------------------
    def _batcher(self):
        b = self._batch_server
        if b is None:
            with self._batch_server_mu:
                b = self._batch_server
                if b is None:
                    from greengage_tpu_torch.exec.batchserve import \
                        BatchServer

                    b = self._batch_server = BatchServer(self)
        return b

    def _batch_eligible(self, consts) -> bool:
        """May this SELECT ride the batched-serving path? Parameterised
        statements only, with batching on and no brownout (stacked
        members' parameters multiply footprints exactly when the card has
        no headroom). The JAX session also keeps external-table loads
        (``aux`` tables), statements inside an open transaction and
        multihost serial; the port has none of these yet (ROADMAP Queue 1
        items 1a, 1b and 8)."""
        if not bool(self.settings.batch_serving_enabled):
            return False
        if _overload.CONTROLLER.brownout_active():
            return False
        return (consts or {}).get("@params@") is not None

    # ------------------------------------------------------------------
    @property
    def _plan_cache_info(self) -> dict:
        """The last _cached_plan outcome, PER THREAD: concurrent
        statements must not report each other's plan-cache outcome
        (Result.stats["plan_cache"])."""
        return getattr(self._pc_info_local, "info", {})

    @_plan_cache_info.setter
    def _plan_cache_info(self, info: dict) -> None:
        self._pc_info_local.info = info

    @staticmethod
    def _attach_params(consts, pv, ptypes, info):
        """Bind the statement's CURRENT hoisted values into a fresh consts
        dict (the cached plan's pool is shared across statements)."""
        from greengage_tpu_torch.sql.paramize import ParamVector

        consts = dict(consts)
        if ptypes is not None:
            consts["@params@"] = ParamVector(pv.values, ptypes)
            counters.inc("params_hoisted", len(pv.values))
        else:
            info["params"] = 0
        return consts

    def _cached_plan(self, stmt, force_multi_join: bool = False):
        """Memoized planning for SELECT-shaped statements (the JAX session's
        _cached_plan, the plancache.c role). Plan-safe literals are hoisted
        into a parameter vector (sql/paramize.py) and the key becomes the
        literal-STRIPPED statement signature plus the hoisted literals'
        types, so `WHERE x > 5` and `WHERE x > 6` share one bound plan;
        unsafe literals stay pinned in the key. The key also carries the
        store version (bound plans embed dictionary codes). A
        force_multi_join re-plan is kept under the PLAIN key so repeats
        skip the failing unique-join plan, and remembered per shape and
        store version, so a re-plan of the shape (a feedback promotion, an
        eviction) plans the multi-match joins at once instead of running
        the failing plan again. LRU, bounded by plan_cache_size. The
        feedback store's calibration version of the shape joins the key.
        -> (planned, consts, outs, exec key): the exec key names the
        statement's cap hints in the executor."""
        from greengage_tpu_torch.sql.paramize import paramize

        version = self.store.manifest.version()
        norm, pv, sig = (paramize(stmt, self.catalog)
                         if self.settings.plan_cache_params
                         else (stmt, None, None))
        fb = self.feedback
        with self._cache_mu:
            pinned = sig is not None and sig in self._paramize_fallback
        if pinned:
            # known-unparameterizable shape: plan value-pinned directly
            norm, pv, sig = stmt, None, None
        info = {"hit": False, "params": 0, "fallback": False}
        self._plan_cache_info = info
        if pv is not None:
            info["params"] = len(pv.values)
        key_sig = sig if sig is not None else repr(stmt)
        # the calibration version joins the key: a feedback promotion
        # touching this shape's digests bumps it, so a re-calibrated shape
        # re-plans instead of serving the stale bound plan
        key = (key_sig, version, fb.version_for(key_sig))
        cache = self._select_cache
        if not force_multi_join:
            with self._cache_mu:
                hit = cache.get(key)
                if hit is None and sig is not None:
                    # this shape fell back to a value-pinned plan before:
                    # look it up under the full repr
                    fbk = (repr(stmt), version, fb.version_for(repr(stmt)))
                    pinned_hit = cache.get(fbk)
                    if pinned_hit is not None and pinned_hit[4] is None:
                        key, hit = fbk, pinned_hit
                if hit is not None:
                    cache.move_to_end(key)
            if hit is not None:
                counters.inc("plan_cache_hit")
                info["hit"] = True
                planned, consts, outs, ek, ptypes = hit
                return planned, self._attach_params(consts, pv, ptypes,
                                                    info), outs, ek
        counters.inc("plan_cache_miss")
        ptypes = pv.types if (pv is not None and norm is not stmt) else None
        multi = self._multi_join_shape(key_sig, version, force_multi_join)
        try:
            planned, consts, outs = self._plan(norm, force_multi_join=multi)
        except (SqlError, NotImplementedError, TypeError):
            if ptypes is None:
                raise
            # a shape the binder cannot parameterize: pin every value and
            # re-plan classically (a genuine user error surfaces the same
            # from the re-plan); later literal variants skip the doomed
            # parameterized bind
            counters.inc("plan_cache_fallback")
            info.update(fallback=True, params=0)
            with self._cache_mu:
                if len(self._paramize_fallback) > 1024:
                    self._paramize_fallback.clear()
                self._paramize_fallback.add(key_sig)
            ptypes = None
            key_sig = repr(stmt)
            key = (key_sig, version, fb.version_for(key_sig))
            multi = self._multi_join_shape(key_sig, version,
                                           force_multi_join)
            planned, consts, outs = self._plan(stmt, force_multi_join=multi)
        ek = key_sig + ("#multi" if multi else "")
        # the shape -> digests dependency set: a promotion on any digest
        # this plan uses bumps version_for(key_sig)
        fb.note_shape(key_sig, planned)
        with self._cache_mu:
            cache[key] = (planned, consts, outs, ek, ptypes)
            cache.move_to_end(key)
            self._trim_plan_cache()
        return planned, self._attach_params(consts, pv, ptypes, info), \
            outs, ek

    def _multi_join_shape(self, key_sig, version, force: bool) -> bool:
        """Plan this shape with multi-match joins? Yes when asked (the
        unique-key plan met duplicate build keys: remembered for the shape
        at this store version) or when remembered."""
        with self._cache_mu:
            if force:
                if len(self._multi_join) > 1024:
                    self._multi_join.clear()
                self._multi_join.add((key_sig, version))
                return True
            return (key_sig, version) in self._multi_join

    def _trim_plan_cache(self) -> None:
        """Evict least-recently-used bound plans past plan_cache_size; a
        statement's cap hints go with its last plan. Runs under
        ``_cache_mu``."""
        cache = self._select_cache
        bound = max(int(self.settings.plan_cache_size), 1)
        while len(cache) > bound:
            _k, old = cache.popitem(last=False)
            if not any(v[3] == old[3] for v in cache.values()):
                self.executor.forget(old[3])

    def _const_select(self, stmt: A.SelectStmt) -> Result:
        """FROM-less SELECT: one constant row evaluated on the host (the
        coordinator-only Result node analog — no dispatch, no segments).
        The row is a CPU tensor by intent, as the binder's constant
        folding is: this is host work, not a fallback from the card."""
        from greengage_tpu_torch.ops.batch import Batch
        from greengage_tpu_torch.ops.expr_eval import Evaluator

        binder = Binder(self.catalog, self.store,
                        subquery_executor=self._scalar_subquery)
        scope = Scope()
        one_row = Batch({"__one__": torch.zeros((1, 1), dtype=torch.int32)},
                        {}, None)
        where_false = False
        if stmt.where is not None:
            pred = binder._predicate(stmt.where, scope)
            keep = Evaluator(one_row, binder.consts).predicate(pred)
            where_false = not bool(keep.reshape(-1)[0])
        cols, valids, names, order = {}, {}, [], []
        for i, it in enumerate(stmt.items):
            e = binder._expr(it.expr, scope)
            cid = f"c#{i}"
            t = e.type
            if isinstance(e, E.Literal) and e.value is None:
                val, valid_np = np.array([None], dtype=object), \
                    np.array([False])
            elif t.kind is T.Kind.TEXT:
                if not isinstance(e, E.Literal):
                    raise SqlError("SELECT without FROM supports only "
                                   "constant text expressions")
                val, valid_np = np.array([e.value], dtype=object), None
            else:
                arr, valid = Evaluator(one_row, binder.consts).column(e)
                arr = arr.reshape(-1).numpy()
                if valid is not None and not bool(valid.reshape(-1)[0]):
                    val, valid_np = np.array([None], dtype=object), \
                        np.array([False])
                elif t.kind is T.Kind.DECIMAL:
                    val, valid_np = arr / (10.0 ** t.scale), None
                elif t.kind is T.Kind.DATE:
                    val = (np.datetime64("1970-01-01", "D")
                           + arr.astype("timedelta64[D]"))
                    valid_np = None
                else:
                    val, valid_np = arr, None
            cols[cid] = val
            valids[cid] = valid_np
            names.append(it.alias or _ast_name(it.expr))
            order.append(cid)
        limit = stmt.limit if stmt.limit is not None else 1
        if limit == 0 or stmt.offset or where_false:
            cols = {k: v[:0] for k, v in cols.items()}
            valids = {k: (None if v is None else v[:0])
                      for k, v in valids.items()}
        return Result(columns=names, cols=cols, valids=valids, _order=order)

    def _scalar_subquery(self, stmt):
        """Run an uncorrelated scalar subquery at bind time (InitPlan
        analog): the value is inlined as a literal into the outer plan."""
        planned, consts, outs = self._plan(stmt)
        if len(outs) != 1:
            raise SqlError("scalar subquery must return one column")
        res = self.executor.run(planned, consts)
        if len(res) > 1:
            raise SqlError("more than one row returned by a scalar subquery")
        t = outs[0].type
        if len(res) == 0:
            return None, t
        valid = res.valids.get(outs[0].id)
        if valid is not None and not valid[0]:
            return None, t
        # the storage representation, as the binder inlines literals
        v = res.raw[outs[0].id][0]
        if t.kind is T.Kind.TEXT:
            return str(res.cols[outs[0].id][0]), T.TEXT
        if t.kind is T.Kind.FLOAT64:
            return float(v), t
        if t.kind is T.Kind.BOOL:
            return bool(v), t
        return int(v), t

    def expand(self, new_numsegments: int) -> dict:
        """gpexpand's role: widen the cluster and redistribute every table.
        Phase 1 adds segments to the topology and rebuilds the layout (the
        port's segments are a leading tensor axis, so a new width is a new
        ``nseg``): the executor's programs, stage cache and bound plans
        are dropped with the old layout. Phase 2 rewrites each table at the
        new width (ALTER TABLE ... EXPAND TABLE); a partitioned table's
        children each, their shared policy moving once. -> {table: rows
        re-placed}."""
        with self._write_lock:
            if new_numsegments <= self.numsegments:
                raise ValueError("expansion must increase the segment count")
            self.catalog.segments.expand(new_numsegments)
            self.numsegments = new_numsegments
            self.catalog._save()
            self.executor.close()
            self.layout = make_layout(new_numsegments, self.device)
            self.executor = Executor(self.catalog, self.store, self.layout,
                                     self.settings)
            self.executor.feedback = self.feedback
            with self._cache_mu:
                self._select_cache.clear()
            self.fts.stop()
            self.fts = FtsProber(self.catalog.segments, self.device)
            counters.set("mh_topology_version", self.catalog.segments.version)
            moved = {}
            for name in list(self.catalog.tables):
                schema = self.catalog.get(name)
                moved[name] = sum(
                    self.store.rewrite_table(st, new_numsegments)
                    for st in schema.storage_tables())
            self.store.reap_gc()
        return moved

    def close(self):
        """Stop the FTS prober and the batch server (its parked members go
        on on the classic path), then free the staged tables, the plan
        cache and this Database's own spill directory. A directory keeps
        its feedback store (feedback.json); an in-memory Database's
        scratch directory goes."""
        try:
            self.feedback.save()
        except Exception:
            pass
        self.fts.stop()
        if self._batch_server is not None:
            self._batch_server.stop()
        with self._cache_mu:
            self._select_cache.clear()
        self.executor.close()
        self.log.close()
        if self._path_rm is not None:
            self._path_rm()


class _RWLock:
    """The writers' lock, with a SHARED mode for appenders (the JAX
    session's). Exclusive: DDL, DELETE, UPDATE, VACUUM; one holder,
    re-entrant per thread. Shared: autocommit appends, any number of
    holders, each also under its table's lock. A waiting exclusive
    holder stops NEW shared entrants (no writer starvation); a thread
    holding exclusive may take shared (nested statement paths). Waits are
    cut into slices, each a cancellation point."""

    def __init__(self):
        self._c = threading.Condition()
        self._excl: int | None = None     # owning thread ident
        self._depth = 0
        self._excl_waiting = 0
        self._shared: dict[int, int] = {}  # thread ident -> hold depth

    def __enter__(self):
        me = threading.get_ident()
        with self._c:
            self._excl_waiting += 1
            try:
                while not (self._excl in (None, me)
                           and all(t == me for t in self._shared)):
                    self._c.wait(0.25)
                    check_interrupts()
            finally:
                self._excl_waiting -= 1
            self._excl = me
            self._depth += 1
        return self

    def __exit__(self, *a):
        with self._c:
            self._depth -= 1
            if self._depth == 0:
                self._excl = None
            self._c.notify_all()
        return False

    @contextmanager
    def shared(self):
        me = threading.get_ident()
        with self._c:
            while (self._excl not in (None, me)
                   or (self._excl_waiting and self._excl is None
                       and me not in self._shared)):
                self._c.wait(0.25)
                check_interrupts()
            self._shared[me] = self._shared.get(me, 0) + 1
        try:
            yield self
        finally:
            with self._c:
                n = self._shared.get(me, 1) - 1
                if n:
                    self._shared[me] = n
                else:
                    self._shared.pop(me, None)
                self._c.notify_all()


class _NullSlot:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class _EmptyScope:
    tables: list = []

    def resolve(self, parts):
        raise SqlError(f'column "{".".join(parts)}" does not exist')


def _zero_for(t: T.SqlType):
    if t.kind is T.Kind.TEXT:
        return ""
    return 0


def _reject_dml_subqueries(where) -> None:
    """IN/EXISTS in a DML WHERE need their own survivor semantics (x IN S
    being NULL must survive a DELETE): refused, as in the JAX session."""
    if where is None:
        return
    stack = [where]
    while stack:
        n = stack.pop()
        if isinstance(n, (A.InSubquery, A.ExistsExpr)):
            raise SqlError("IN/EXISTS subqueries in DELETE/UPDATE WHERE are "
                           "not supported yet")
        for f in ("left", "right", "arg", "lo", "hi", "else_"):
            v = getattr(n, f, None)
            if isinstance(v, A.ANode):
                stack.append(v)
        for v in getattr(n, "args", []) or []:
            stack.append(v)
        for v in getattr(n, "values", []) or []:
            if isinstance(v, A.ANode):
                stack.append(v)
        for cond, val in getattr(n, "whens", []) or []:
            stack.append(cond)
            stack.append(val)


def _sql_type_name(t: T.SqlType) -> tuple[str, tuple[int, ...]]:
    """SqlType -> (type name, typmod) of a CAST."""
    k = t.kind
    if k is T.Kind.DECIMAL:
        return "numeric", (38, t.scale)
    return {
        T.Kind.INT32: ("int", ()),
        T.Kind.INT64: ("bigint", ()),
        T.Kind.FLOAT64: ("double precision", ()),
        T.Kind.DATE: ("date", ()),
        T.Kind.BOOL: ("bool", ()),
        T.Kind.TEXT: ("text", ()),
    }[k]


_REC_COUNTER = itertools.count()


def _ddl_type(t) -> str:
    """SqlType -> DDL text of a recursive CTE's worktable (DECIMAL as
    double precision: the host sees descaled floats)."""
    k = t.kind
    if k is T.Kind.INT32:
        return "int"
    if k is T.Kind.INT64:
        return "bigint"
    if k in (T.Kind.FLOAT64, T.Kind.DECIMAL):
        return "double precision"
    if k is T.Kind.BOOL:
        return "bool"
    if k is T.Kind.DATE:
        return "date"
    return "text"


def _rename_base_tables(node, mapping: dict):
    """Rewrite BaseTable references by ``mapping`` everywhere in the AST,
    subqueries included (the worktable substitution)."""
    if isinstance(node, A.BaseTable):
        if node.name in mapping:
            if node.alias is None:
                node.alias = node.name       # keep qualified refs valid
            node.name = mapping[node.name]
        return node
    if isinstance(node, A.ANode):
        for f in _dc.fields(node):
            v = getattr(node, f.name)
            setattr(node, f.name, _rename_base_tables(v, mapping))
        return node
    if isinstance(node, list):
        return [_rename_base_tables(v, mapping) for v in node]
    if isinstance(node, tuple):
        return tuple(_rename_base_tables(v, mapping) for v in node)
    return node


def _inferred_col(name: str, arr):
    """Name and type from a host result array: the typing of a
    constant-only recursive base term."""
    k = arr.dtype.kind
    if k == "M":
        t = T.DATE
    elif k == "b":
        t = T.BOOL
    elif k == "i" and arr.dtype.itemsize <= 4:
        t = T.INT32
    elif k in ("i", "u"):
        t = T.INT64
    elif k == "f":
        t = T.FLOAT64
    else:
        t = T.TEXT
    return SimpleNamespace(name=name, type=t)
