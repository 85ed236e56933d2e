"""Database session — the port's counterpart of greengage_tpu/exec/session.py.

One object owns the catalog, the table store, the settings, the segment
layout on the device and the executor; ``sql()`` is exec_simple_query:

  parse -> bind -> plan -> compile -> stage -> run -> Gather -> rows

each statement through the same steps as the JAX session's ``_sql_inner``
-> ``_execute`` -> ``_cached_plan`` -> ``_select``: a SELECT's bound plan
is kept per literal-stripped statement shape and store version, so a
repeat skips bind and plan.

One Database serves many threads at once, as the JAX session does (one
thread per connection): each statement's plan-cache outcome is kept per
thread, and the bound-plan LRU (and the executor's caches) are locked.
Every statement registers a ``StatementContext`` (runtime/interrupt.py:
``statement_timeout_s``, cancel by id through ``REGISTRY.cancel``) and a
trace (runtime/trace.py) and waits for its resource group's and the
resource queue's admission (runtime/resgroup.py, runtime/resqueue.py)
before it runs. With ``batch_serving_enabled`` a parameterised SELECT
joins its shape's admission window in the batch server
(exec/batchserve.py) and runs as one member of a batched program; a batch
that cannot run as one program sends its members back to the classic
path.

The statements handled: SELECT (joins, subqueries, window functions,
UNION [ALL], GROUPING SETS / ROLLUP / CUBE, and SELECT without FROM — a
constant target list on the host, anything else through the ConstRel
device path), CREATE TABLE (DISTRIBUTED BY / RANDOMLY / REPLICATED), DROP
TABLE, ANALYZE [table], SET and SHOW of the settings the port holds, and
``load_table`` for bulk loads. Every other statement, and WITH RECURSIVE,
raises a SqlError naming the ROADMAP item it waits for; a plan node the
compiler cannot lower raises NotImplementedError before anything runs,
never a wrong answer.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from contextlib import ExitStack
from functools import partial

import numpy as np
import torch

from greengage_tpu_torch import resolve_device
from greengage_tpu_torch import expr as E
from greengage_tpu_torch import types as T
from greengage_tpu_torch.catalog import (Catalog, Column, DistPolicy,
                                         PolicyKind, TableSchema)
from greengage_tpu_torch.config import Settings
from greengage_tpu_torch.exec.executor import (Executor, QueryError,
                                               Result)
from greengage_tpu_torch.parallel.mesh import make_layout
from greengage_tpu_torch.planner import cost as _cost
from greengage_tpu_torch.planner import plan_query
from greengage_tpu_torch.runtime import trace as _trace
from greengage_tpu_torch.runtime.interrupt import REGISTRY as _INTERRUPTS
from greengage_tpu_torch.runtime.interrupt import StatementCancelled
from greengage_tpu_torch.runtime.logger import counters, histograms
from greengage_tpu_torch.runtime.resgroup import ResourceGroupManager
from greengage_tpu_torch.runtime.resqueue import ResourceQueue
from greengage_tpu_torch.runtime.trace import TRACES as _TRACES
from greengage_tpu_torch.sql import ast as A
from greengage_tpu_torch.sql.binder import (Binder, Scope, _ast_name,
                                           _contains_agg, type_from_name)
from greengage_tpu_torch.sql.parser import SqlError, parse
from greengage_tpu_torch.storage import TableStore

# statements of the JAX session that wait for a later slice -> the ROADMAP
# item that ports them
_LATER = {
    A.InsertStmt: "DML and COPY: ROADMAP Queue 1 item 1b",
    A.CopyStmt: "DML and COPY: ROADMAP Queue 1 item 1b",
    A.UpdateStmt: "DML and COPY: ROADMAP Queue 1 item 1b",
    A.DeleteStmt: "DML and COPY: ROADMAP Queue 1 item 1b",
    A.TxStmt: "transactions: ROADMAP Queue 1 item 1a (durable storage)",
    A.ExplainStmt: "EXPLAIN: ROADMAP Queue 1 item 1c",
    A.DeclareCursorStmt: "cursors: ROADMAP Queue 1 item 1h",
    A.RetrieveStmt: "cursors: ROADMAP Queue 1 item 1h",
    A.CloseCursorStmt: "cursors: ROADMAP Queue 1 item 1h",
    A.CreateExternalTableStmt: "external tables: ROADMAP Queue 1 item 1b",
    A.AlterTableStmt: "ALTER TABLE: ROADMAP Queue 1 item 1a (durable storage)",
    A.CreateIndexStmt: "indexes: ROADMAP Queue 1 item 1a (durable storage)",
    A.DropIndexStmt: "indexes: ROADMAP Queue 1 item 1a (durable storage)",
    A.CreateExtensionStmt: "extensions: ROADMAP Queue 1 item 7",
}


def allocated_bytes(index: int) -> int:
    """The caching allocator's allocated bytes on card ``index`` (what
    ``torch.cuda.memory_allocated`` returns)."""
    return int(torch._C._cuda_memoryStats(index)["allocated_bytes"]["all"]
               ["current"])


class Database:
    def __init__(self, path: str | None = None, numsegments: int | None = None,
                 mirrors: bool = False, multihost=None, device=None):
        if path is not None:
            raise NotImplementedError(
                "a database directory (durable storage, catalog.json): "
                "ROADMAP Queue 1 item 1a; connect(path=None) is in memory")
        if mirrors:
            raise NotImplementedError("mirrors: ROADMAP Queue 1 item 1a")
        if multihost is not None:
            raise NotImplementedError("multi-GPU: ROADMAP Queue 1 item 8")
        self.device = resolve_device(device)
        if numsegments is None:
            # one segment per visible device, as the JAX session takes one
            # per visible chip
            numsegments = (torch.cuda.device_count()
                           if self.device.type == "cuda" else 1)
        self.numsegments = numsegments
        self.catalog = Catalog(numsegments)
        self.store = TableStore(self.catalog)
        self.settings = Settings()
        # the cost model's process-wide knobs, installed as the JAX session
        # installs them at connect (no calibration file in memory)
        _cost.set_calibration(None)
        _cost.set_motion_overlap(self._motion_overlap_factor())
        self.layout = make_layout(numsegments, self.device)
        self.executor = Executor(self.catalog, self.store, self.layout,
                                 self.settings)
        # the bound-plan LRU (_cached_plan): (statement signature, store
        # version) -> (planned, consts, outs, exec key, param types). Its
        # get/move/insert/evict and the fallback set run under _cache_mu:
        # statements of many threads share them
        self._select_cache: OrderedDict = OrderedDict()
        self._cache_mu = threading.Lock()
        # signatures whose parameterized form the binder refused: they
        # plan value-pinned straight away
        self._paramize_fallback: set = set()
        # each thread's last _cached_plan outcome (the _plan_cache_info
        # property)
        self._pc_info_local = threading.local()
        # admission (_admission): the resource queue and the resource
        # groups. Groups live in memory with the catalog: persistence
        # across a reopen waits for durable storage (ROADMAP Queue 1 item
        # 1a)
        self.resqueue = ResourceQueue(self.settings)
        self.resgroups = ResourceGroupManager(self.settings)
        # the batch server (exec/batchserve.py): made on the first
        # batch-eligible statement, so its two threads exist only while
        # batch_serving_enabled is on
        self._batch_server = None
        self._batch_server_mu = threading.Lock()
        if self.device.type == "cuda":
            # spans carry the card's allocated bytes at their ends: the
            # counter torch.cuda.memory_allocated reads, taken from the
            # allocator's stats without the flattening of every other
            # stat that costs memory_allocated ~7x as much (chip_smoke's
            # serve phase times both)
            idx = self.device.index
            _trace.set_mem_sampler(partial(
                allocated_bytes,
                torch.cuda.current_device() if idx is None else idx))

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
        has the statement's id; nested calls on the same thread share
        the outermost statement's context and trace."""
        ctx, _outer = _INTERRUPTS.enter(
            text, timeout_s=float(self.settings.statement_timeout_s))
        tr, t_outer = _TRACES.enter(
            ctx.statement_id, text,
            enabled=bool(self.settings.trace_enabled),
            ring_size=int(self.settings.trace_ring_size))
        t0 = time.monotonic()
        root = (tr.begin("statement", cat="statement")
                if tr is not None and t_outer else None)
        try:
            return self._sql_inner(text)
        except StatementCancelled as e:
            if not ctx.counted:
                ctx.counted = True
                counters.inc(f"statements_cancelled_{e.cause}")
            raise
        finally:
            if root is not None:
                tr.end(root)
            if t_outer:
                histograms.observe("statement_ms",
                                   (time.monotonic() - t0) * 1e3)
            _TRACES.exit(tr)
            _INTERRUPTS.exit(ctx)

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
                           "Queue 1 item 1a, durable storage)")
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

    def _analyze(self, table: str | None) -> str:
        """ANALYZE [table]: per-column NDV/min-max/null-frac/MCV into the
        catalog (planner/stats.py)."""
        from greengage_tpu_torch.planner.stats import analyze_table

        names = [table] if table else list(self.catalog.tables)
        snap = self.store.manifest.snapshot()
        for n in names:
            schema = self.catalog.get(n)
            schema.stats = analyze_table(self.store, schema, snap)
        return "ANALYZE"

    def load_table(self, table: str, columns: dict, valids: dict | None = None):
        """Bulk load host arrays (the gpfdist/COPY fast path)."""
        return self.store.insert(table, columns, valids)

    # ------------------------------------------------------------------
    def _plan(self, stmt, force_multi_join: bool = False):
        """-> (planned tree, binder consts, output columns): bind, then
        parallelize (Motion insertion, loci, estimates). IN, EXISTS and NOT
        IN subqueries arrive from the binder as semi, anti and null-aware
        anti joins. ``force_multi_join`` plans every equi-join with the
        multi-match (duplicate-capable) join."""
        binder = Binder(self.catalog, self.store,
                        subquery_executor=self._scalar_subquery)
        logical, outs = binder.bind_select(stmt)
        planned = plan_query(logical, self.catalog, self.store,
                             self.numsegments,
                             force_multi_join=force_multi_join)
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
        replanned = False
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
                    return res
            try:
                res = self.executor.run(planned, consts, cache_key=exec_key)
            except QueryError as e:
                if "duplicate keys" not in str(e) \
                        or exec_key.endswith("#multi"):
                    raise
                # the uniqueness heuristic was wrong at run time: re-plan
                # with the multi-match join everywhere, as the JAX session
                # does, cached under the plain key so repeats skip the
                # failing plan
                planned, consts, _outs, exec_key = self._cached_plan(
                    stmt, force_multi_join=True)
                info = dict(self._plan_cache_info)
                res = self.executor.run(planned, consts, cache_key=exec_key)
                replanned = True
        res.stats.update(plan_ms=plan_ms, multi_join_replan=replanned,
                         plan_cache=info)
        return res

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
        """CREATE / ALTER / DROP RESOURCE GROUP. The JAX session persists
        the definitions in its catalog; the port's catalog is in memory,
        so they last as long as this Database (persistence across a
        reopen waits for ROADMAP Queue 1 item 1a)."""
        allowed = {"concurrency", "memory_limit_mb", "cpu_weight"}
        bad = set(stmt.options) - allowed
        if bad:
            raise SqlError(f"unknown resource group option(s): "
                           f"{', '.join(sorted(bad))}")
        if stmt.action == "create":
            self.resgroups.create(stmt.name, **stmt.options)
            return "CREATE RESOURCE GROUP"
        if stmt.action == "drop":
            self.resgroups.drop(stmt.name)
            return "DROP RESOURCE GROUP"
        self.resgroups.alter(stmt.name, **stmt.options)
        return "ALTER RESOURCE GROUP"

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
        statements only, with batching on. The JAX session also keeps
        external-table loads (``aux`` tables), statements inside an open
        transaction, multihost and brownout serial; the port has none of
        these yet (ROADMAP Queue 1 items 1a, 1b, 8 and the server)."""
        if not bool(self.settings.batch_serving_enabled):
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
        skip the failing unique-join plan. LRU, bounded by
        plan_cache_size. -> (planned, consts, outs, exec key): the exec
        key names the statement's cap hints in the executor."""
        from greengage_tpu_torch.sql.paramize import paramize

        version = self.store.manifest.version
        norm, pv, sig = (paramize(stmt, self.catalog)
                         if self.settings.plan_cache_params
                         else (stmt, None, None))
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
        key = (key_sig, version)
        cache = self._select_cache
        if not force_multi_join:
            with self._cache_mu:
                hit = cache.get(key)
                if hit is None and sig is not None:
                    # this shape fell back to a value-pinned plan before:
                    # look it up under the full repr
                    fb = cache.get((repr(stmt), version))
                    if fb is not None and fb[4] is None:
                        key, hit = (repr(stmt), version), fb
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
        try:
            planned, consts, outs = self._plan(
                norm, force_multi_join=force_multi_join)
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
            key = (key_sig, version)
            planned, consts, outs = self._plan(
                stmt, force_multi_join=force_multi_join)
        ek = key_sig + ("#multi" if force_multi_join else "")
        with self._cache_mu:
            cache[key] = (planned, consts, outs, ek, ptypes)
            cache.move_to_end(key)
            self._trim_plan_cache()
        return planned, self._attach_params(consts, pv, ptypes, info), \
            outs, ek

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
        """Stop the batch server (its parked members go on on the classic
        path), then free the staged tables, the plan cache and this
        Database's own spill directory."""
        if self._batch_server is not None:
            self._batch_server.stop()
        with self._cache_mu:
            self._select_cache.clear()
        self.executor.close()

