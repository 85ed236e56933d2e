"""Database session — the port's counterpart of greengage_tpu/exec/session.py.

One object owns the catalog, the table store, the settings, the segment
layout on the device and the executor; ``sql()`` is exec_simple_query:

  parse -> bind -> plan -> compile -> stage -> run -> Gather -> rows

each statement through the same steps as the JAX session's ``_sql_inner``
-> ``_execute`` -> ``_plan`` -> ``_select``.

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

import time

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
    A.ResourceGroupStmt: "resource groups: ROADMAP Queue 1 item 7",
}


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
        # statements (by their parse tree) whose unique-key join plan met
        # duplicate build keys at run time: they plan multi-match joins
        self._multi_join: set[str] = set()

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
        Result (or a status string for DDL)."""
        t0 = time.perf_counter()
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
            return str(self._setting(self.settings.show, stmt.what))
        if isinstance(stmt, A.SetStmt):
            self._setting(self.settings.set, stmt.name, stmt.value)
            if stmt.name == "motion_pipeline_buckets":
                _cost.set_motion_overlap(self._motion_overlap_factor())
            return "SET"
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
        key = repr(stmt)
        multi = key in self._multi_join
        planned, consts, _outs = self._plan(stmt, force_multi_join=multi)
        plan_ms = (time.perf_counter() - t0) * 1e3
        replanned = False
        try:
            res = self.executor.run(planned, consts)
        except QueryError as e:
            if multi or "duplicate keys" not in str(e):
                raise
            # the uniqueness heuristic was wrong at run time: re-plan with
            # the multi-match join everywhere, as the JAX session does, and
            # remember it so a repeat skips the failing plan (the JAX
            # session keeps the re-plan in its plan cache)
            self._multi_join.add(key)
            planned, consts, _outs = self._plan(stmt, force_multi_join=True)
            res = self.executor.run(planned, consts)
            replanned = True
        res.stats.update(plan_ms=plan_ms, multi_join_replan=replanned)
        return res

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
        self.executor._stage_cache.clear()

