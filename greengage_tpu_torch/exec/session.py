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
UNION [ALL], GROUPING SETS / ROLLUP / CUBE, and SELECT without FROM — a
constant target list on the host, anything else through the ConstRel
device path), EXPLAIN [ANALYZE] of a SELECT, CREATE TABLE (DISTRIBUTED BY
/ RANDOMLY / REPLICATED), DROP TABLE, ANALYZE [table], CREATE EXTENSION,
SET and SHOW of the settings the port holds, and ``load_table`` for bulk
loads. Every other statement, and WITH RECURSIVE, raises a SqlError
naming the ROADMAP item it waits for; a plan node the compiler cannot
lower raises NotImplementedError before anything runs, never a wrong
answer.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
import warnings
import weakref
from collections import OrderedDict
from contextlib import ExitStack

import numpy as np
import torch

from greengage_tpu_torch import resolve_device
from greengage_tpu_torch import expr as E
from greengage_tpu_torch import types as T
from greengage_tpu_torch.analysis.plancheck import validate_plan
from greengage_tpu_torch.catalog import (Catalog, Column, DistPolicy,
                                         PolicyKind, TableSchema)
from greengage_tpu_torch.config import Settings
from greengage_tpu_torch.exec.executor import (Executor, OutOfDeviceMemory,
                                               QueryError, Result, _scans,
                                               shape_of)
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
from greengage_tpu_torch.runtime.interrupt import StatementCancelled
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
    A.InsertStmt: "DML and COPY: ROADMAP Queue 1 item 1b",
    A.CopyStmt: "DML and COPY: ROADMAP Queue 1 item 1b",
    A.UpdateStmt: "DML and COPY: ROADMAP Queue 1 item 1b",
    A.DeleteStmt: "DML and COPY: ROADMAP Queue 1 item 1b",
    A.TxStmt: "transactions: ROADMAP Queue 1 item 1a-iii (runtime/dtm.py)",
    A.DeclareCursorStmt: "cursors: ROADMAP Queue 1 item 1h",
    A.RetrieveStmt: "cursors: ROADMAP Queue 1 item 1h",
    A.CloseCursorStmt: "cursors: ROADMAP Queue 1 item 1h",
    A.CreateExternalTableStmt: "external tables: ROADMAP Queue 1 item 1b",
    A.AlterTableStmt: "ALTER TABLE: ROADMAP Queue 1 item 1a-ii",
    A.CreateIndexStmt: "indexes: ROADMAP Queue 1 item 1a-ii",
    A.DropIndexStmt: "indexes: ROADMAP Queue 1 item 1a-ii",
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
            # rolls back, committed lines fold into the root
            self.store.manifest.recover()
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
        inside) and log a transition this Database has not seen yet. The
        JAX session also evicts its block cache to the shrunken budget on
        entry; the port has no block cache (ROADMAP Queue 1 item 1a-ii).
        Never raises: overload protection must not fail the statement it
        protects."""
        try:
            state = _overload.CONTROLLER.evaluate(self.settings)
            if state == self._overload_seen:
                return
            self._overload_seen = state
            snap = _overload.CONTROLLER.snapshot()
            with _trace.span("brownout-transition", cat="overload",
                             entered=state):
                if state:
                    self.log.log(
                        "WARNING", "overload",
                        f"brownout entered: {snap.get('reason')} — batch "
                        "serving disabled, admissions prefer the spill "
                        "passes")
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
        if isinstance(stmt, A.CreateExtensionStmt):
            return self._create_extension(stmt)
        if isinstance(stmt, A.CreateTableStmt):
            return self._create_table(stmt)
        if isinstance(stmt, A.DropTableStmt):
            existed = stmt.name in self.catalog
            self.catalog.drop_table(stmt.name, stmt.if_exists)
            if existed:
                self.store.drop_table(stmt.name)
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
        if stmt.partition_kind is not None:
            raise SqlError("partitioned tables are not ported yet (ROADMAP "
                           "Queue 1 item 1a-ii)")
        cols = [Column(c.name, type_from_name(c.type_name, c.typmod),
                       not c.not_null) for c in stmt.columns]
        kind = {"hash": PolicyKind.HASH, "random": PolicyKind.RANDOM,
                "replicated": PolicyKind.REPLICATED}[stmt.dist_kind]
        policy = DistPolicy(kind, tuple(stmt.dist_keys)
                            if kind is PolicyKind.HASH else (),
                            self.numsegments)
        self.catalog.create_table(TableSchema(stmt.name, cols, policy,
                                              dict(stmt.options)),
                                  stmt.if_not_exists)
        return "CREATE TABLE"

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
        """Bulk load host arrays (the gpfdist/COPY fast path)."""
        return self.store.insert(table, columns, valids)

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
        if getattr(stmt, "_recursive_ctes", None):
            # the JAX session's fixpoint deletes from and loads rows into
            # its worktables: it waits for DML
            raise SqlError("recursive CTEs are not ported yet (ROADMAP "
                           "Queue 1 item 1b)")
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
                f"\n Tables scanned: {', '.join(sorted(_scans(planned, {})))}")
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

