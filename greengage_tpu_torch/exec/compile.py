"""Physical compiler: planned tree -> one program over every segment.

The port's counterpart of greengage_tpu/exec/compile.py. The JAX package
traces the plan below the top Gather Motion into one function and runs it
under ``jax.jit(shard_map(...))``, one instance per segment. The port
lowers the same nodes into an eager torch closure over ``[nseg, cap]``
tensors (parallel/mesh.py): every operator handles all segments at once,
and Motions are tensor ops over the segment axis (parallel/motion.py).

The contract with the caller is the JAX package's: overflow flags
(motion bucket, gather compaction) and metrics (Filter row counts,
compaction totals) come back by name beside the output columns.

This slice lowers the nodes TPC-H Q1's plan uses: Scan, Filter, Project,
dense Aggregate (single, partial and final, with the fused-kernel gate),
PartialState, Motion (Redistribute, Broadcast) and Sort, plus the
pre-Gather compaction. Other nodes and the sort-based grouping path raise
NotImplementedError naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from greengage_tpu_torch import expr as E
from greengage_tpu_torch import types as T
from greengage_tpu_torch.config import Settings
from greengage_tpu_torch.ops import agg as agg_ops
from greengage_tpu_torch.ops import fused_agg
from greengage_tpu_torch.ops import hashing
from greengage_tpu_torch.ops import sort as sort_ops
from greengage_tpu_torch.ops.batch import Batch
from greengage_tpu_torch.ops.expr_eval import Evaluator, descale
from greengage_tpu_torch.parallel import motion as motion_ops
from greengage_tpu_torch.parallel.mesh import SegmentLayout
from greengage_tpu_torch.planner.logical import (
    Aggregate, Filter, Motion, MotionKind, PartialState, Plan, Project, Scan,
    Sort,
)

VALID_PREFIX = "@v:"


def _pow2(n: float) -> int:
    m = 1
    while m < n:
        m <<= 1
    return m


@dataclass
class TableData:
    """A table staged on the device in segment layout: what a Scan reads.
    ``cols`` maps storage column names (and "@v:<col>" NULL masks) to
    ``[nseg, cap]`` tensors; ``dicts`` holds each TEXT column's dictionary
    (code -> string)."""

    name: str
    cols: dict[str, torch.Tensor]
    present: torch.Tensor
    dicts: dict[str, list] = field(default_factory=dict)

    @property
    def capacity(self) -> int:
        return int(self.present.shape[-1])


@dataclass
class ProgramOutput:
    cols: dict[str, torch.Tensor]
    valids: dict[str, torch.Tensor]
    sel: torch.Tensor
    flags: dict[str, torch.Tensor]       # name -> bool scalar
    metrics: dict[str, torch.Tensor]     # name -> int64 [nseg]


@dataclass
class CompileResult:
    program: object                    # tables -> ProgramOutput
    out_cols: list                     # ColInfo list of gather output
    flag_names: list[str]
    metric_names: list[str]
    merge_keys: list | None


class Compiler:
    def __init__(self, layout: SegmentLayout, tables: dict[str, TableData],
                 settings: Settings | None = None, consts: dict | None = None):
        self.layout = layout
        self.nseg = layout.nseg
        self.device = layout.device
        self.tables = tables
        self.s = settings or Settings()
        self.consts = dict(consts or {})
        self.flags: list[str] = []
        self.metrics: list[str] = []
        self._luts: dict = {}

    # ------------------------------------------------------------------
    def compile(self, plan: Motion) -> CompileResult:
        assert isinstance(plan, Motion) and plan.kind is MotionKind.GATHER
        self.flags, self.metrics = [], []
        below = plan.child
        self._dict_refs: dict[str, tuple] = {}
        _collect_dict_refs(plan, self._dict_refs)
        compiled = self._compile_node(below)
        out_cols = below.out_cols()

        # device-side result compaction before the Gather (Gather Motion,
        # nodeMotion.c:171): when estimated live rows sit far below
        # capacity, stable-sort live-first and ship a small static slice;
        # the exact live count feeds the overflow retry
        compact_k = self._gather_compact_k(below)
        fid_cmp = mid_cmp = None
        if compact_k is not None:
            fid_cmp = f"gather_compact_overflow_{len(self.flags)}"
            self.flags.append(fid_cmp)
            mid_cmp = f"gather_compact_total_{len(self.metrics)}"
            self.metrics.append(mid_cmp)
        flag_names = list(self.flags)
        metric_names = list(self.metrics)

        def program(tables: dict[str, TableData]) -> ProgramOutput:
            ctx = {"tables": tables, "flags": [], "metrics": []}
            batch = compiled(ctx)
            sel = batch.selection()
            if compact_k is not None:
                dead = (~sel).to(torch.uint8)
                perm = sort_ops._lexsort([dead], sel.shape[-1])[:, :compact_k]
                total = sel.sum(dim=-1)
                ctx["flags"].append((fid_cmp, (total > compact_k).any()))
                ctx["metrics"].append((mid_cmp, total))
                cols, valids = sort_ops.apply_perm(
                    {c.id: batch.cols[c.id] for c in out_cols},
                    {c.id: batch.valids[c.id] for c in out_cols
                     if batch.valids.get(c.id) is not None}, perm)
                ar = torch.arange(compact_k, device=sel.device)
                batch = Batch(cols, valids, ar[None, :] < total[:, None])
                sel = batch.selection()
            # emit in REGISTRATION order; operators may append to ctx in a
            # different order than they registered
            fdict, mdict = dict(ctx["flags"]), dict(ctx["metrics"])
            assert len(fdict) == len(flag_names), (
                sorted(fdict), sorted(flag_names))
            return ProgramOutput(
                {c.id: batch.cols[c.id] for c in out_cols},
                {c.id: batch.valids[c.id] for c in out_cols
                 if batch.valids.get(c.id) is not None},
                sel,
                {n: fdict[n] for n in flag_names},
                {n: mdict[n].to(torch.int64) for n in metric_names})

        return CompileResult(
            program=program, out_cols=out_cols, flag_names=flag_names,
            metric_names=metric_names, merge_keys=plan.merge_keys)

    def _gather_compact_k(self, below) -> int | None:
        """Result-compaction slot count before the Gather, or None when the
        result ships uncompacted."""
        cap_below = self._capacity_of(below)
        if isinstance(below, (Sort, Aggregate, PartialState)) \
                or cap_below < (1 << 14):
            return None
        est = max(getattr(below, "est_rows", 0.0) or 0.0, 1.0)
        if below.locus is not None and below.locus.is_partitioned \
                and self.nseg > 1:
            est /= self.nseg
        k = _pow2(int(est * 1.5) + 64)
        if k * 2 <= cap_below:
            return min(k, cap_below)
        return None

    # ------------------------------------------------------------------
    # capacities
    # ------------------------------------------------------------------
    def _capacity_of(self, plan: Plan) -> int:
        """Static per-segment row capacity of a node's output batch."""
        if isinstance(plan, Scan):
            return self.tables[plan.table].capacity
        if isinstance(plan, (Filter, Project, Sort, PartialState)):
            return self._capacity_of(plan.child)
        if isinstance(plan, Aggregate):
            dense = self._dense_domains(plan)
            d = 1
            for dom in dense:
                d *= dom
            return d
        if isinstance(plan, Motion):
            child_cap = self._capacity_of(plan.child)
            if plan.kind is MotionKind.BROADCAST:
                return child_cap * self.nseg
            if plan.kind is MotionKind.REDISTRIBUTE:
                return self.nseg * self._motion_bucket(child_cap)
            return child_cap
        raise NotImplementedError(
            f"{type(plan).__name__}: ROADMAP Queue 1 items 3-4")

    def _motion_bucket(self, child_cap: int) -> int:
        c = int(child_cap * self.s.motion_capacity_slack / self.nseg) + 64
        return min(_pow2(c), child_cap)

    def dictionary(self, ref: tuple) -> list:
        table, col = ref
        return self.tables[table].dicts[col]

    def _dense_domains(self, plan: Aggregate) -> list[int]:
        """Per-key dense domains (|dict|+1 / bool 3). Grouping that has no
        such domain takes the sort-based path, which is not ported yet."""
        domains = []
        prod = 1
        for ci, e in plan.group_keys:
            if ci.type.kind is T.Kind.TEXT:
                d = ci.dict_ref
                if d is None and isinstance(e, E.ColRef):
                    d = self._dict_refs.get(e.name)
                if d is None:
                    domains = None
                    break
                domains.append(len(self.dictionary(d)) + 1)
            elif ci.type.kind is T.Kind.BOOL:
                domains.append(3)
            else:
                domains = None
                break
            prod *= domains[-1]
            if prod > self.s.dense_group_limit:
                domains = None
                break
        if not plan.group_keys or domains is None:
            raise NotImplementedError(
                "scalar and sort-based grouping: ROADMAP Queue 1 item 2")
        return domains

    # ------------------------------------------------------------------
    # node compilation (returns closures ctx -> Batch)
    # ------------------------------------------------------------------
    def _compile_node(self, plan: Plan):
        m = getattr(self, "_c_" + type(plan).__name__.lower(), None)
        if m is None:
            raise NotImplementedError(
                f"{type(plan).__name__}: ROADMAP Queue 1 items 3-4")
        fn = m(plan)
        if not isinstance(plan, Filter):
            return fn
        # always-on row counters on Filter outputs: selectivity is the
        # estimate the planner gets most wrong
        mid = f"nrows_{len(self.metrics)}"
        self.metrics.append(mid)

        def counted(ctx):
            b = fn(ctx)
            ctx["metrics"].append((mid, b.selection().sum(dim=-1)))
            return b

        return counted

    def _c_scan(self, plan: Scan):
        table = plan.table
        id_by_store = [(c.id, c.name) for c in plan.cols]

        def run(ctx):
            t = ctx["tables"][table]
            cols = {cid: t.cols[sname] for cid, sname in id_by_store}
            valids = {cid: t.cols[VALID_PREFIX + sname]
                      for cid, sname in id_by_store
                      if VALID_PREFIX + sname in t.cols}
            return Batch(cols, valids, t.present)

        return run

    def _c_filter(self, plan: Filter):
        child = self._compile_node(plan.child)
        pred = plan.predicate

        def run(ctx):
            b = child(ctx)
            mask = Evaluator(b, self.consts).predicate(pred)
            return b.with_sel(b.selection() & mask)

        return run

    def _c_project(self, plan: Project):
        child = self._compile_node(plan.child)
        exprs = plan.exprs

        def run(ctx):
            b = child(ctx)
            ev = Evaluator(b, self.consts)
            cols, valids = {}, {}
            for ci, e in exprs:
                v, valid = ev.column(e)
                cols[ci.id] = v
                if valid is not None:
                    valids[ci.id] = valid
            return Batch(cols, valids, b.sel)

        return run

    def _lut(self, kind: str, ref: tuple) -> torch.Tensor:
        """Per-dictionary device LUT, built once per compile: "hash" =
        distribution hashes (+ sentinel 0), "rank" = collation ranks of the
        codes (+ sentinel -1)."""
        key = (kind, tuple(ref))
        if key not in self._luts:
            values = self.dictionary(ref)
            if kind == "hash":
                lut = hashing.text_hash_lut(values, self.device)
            else:
                order = np.argsort(np.argsort(np.asarray(values, dtype=object),
                                              kind="stable"), kind="stable")
                lut = torch.tensor(np.concatenate(
                    [order.astype(np.int64), [-1]]), device=self.device)
            self._luts[key] = lut
        return self._luts[key]

    def _text_ref(self, e: E.Expr):
        if e.type.kind is not T.Kind.TEXT:
            return None
        d = getattr(e, "_dict_ref", None)
        if d is None and isinstance(e, E.ColRef):
            d = self._dict_refs.get(e.name)
        return d

    def _key_specs(self, batch: Batch, exprs):
        ev = Evaluator(batch, self.consts)
        specs = []
        for e in exprs:
            v, valid = ev.column(e)
            d = self._text_ref(e)
            lut = self._lut("hash", d) if d is not None else None
            specs.append(agg_ops.KeySpec(v, valid, e.type, hash_lut=lut))
        return specs

    # ---- aggregation ---------------------------------------------------
    def _c_aggregate(self, plan: Aggregate):
        child_fn = self._compile_node(plan.child)
        dense = self._dense_domains(plan)
        M = 1
        for dom in dense:
            M *= dom
        keys = plan.group_keys
        aggs = plan.aggs
        phase = plan.phase

        # the fused single-pass kernel, gated as in the JAX package so both
        # packages take it on the same plans: big enough batches, a small
        # domain, and the accumulator bound the TPU kernel's scratch needs
        n_acc_est = sum(2 if a.func == "avg" else 1 for _, a in aggs) + 1
        fused_ok = (self.s.fused_dense_agg
                    and M <= self.s.fused_dense_max_domain
                    and n_acc_est * M * 128 * 8
                    <= self.s.fused_dense_max_scratch_mb << 20
                    and (self._capacity_of(plan.child)
                         >= self.s.fused_dense_min_rows))

        def run(ctx):
            b = child_fn(ctx)
            sel = b.selection()
            S = sel.shape[0]
            kspecs = self._key_specs(b, [e for _, e in keys])
            gid, _ = agg_ops.dense_gid(kspecs, dense, sel)
            cols, valids = {}, {}
            for (ci, _), (code, valid) in zip(
                    keys, agg_ops.dense_decode_keys(kspecs, dense, M)):
                cols[ci.id] = code.expand(S, M)
                valids[ci.id] = valid.expand(S, M)
            ev = Evaluator(b, self.consts)
            meta = {}

            def do_agg(specs):
                # "@used" rides the same pass: per-group live-row presence
                specs2 = list(specs) + [
                    agg_ops.AggSpec("@used", "count_star", None, None)]
                if fused_ok and fused_agg.supported(specs2):
                    vals, avalids = fused_agg.fused_dense_aggregate(
                        gid, M, specs2, sel)
                else:
                    vals, avalids = agg_ops.dense_aggregate(
                        gid, M, specs2, sel)
                meta["used"] = vals.pop("@used") > 0
                avalids.pop("@used", None)
                return vals, avalids

            if phase in ("single", "partial"):
                specs = []
                for ci, a in aggs:
                    arg_v, arg_valid, scale = None, None, 0
                    if a.arg is not None:
                        arg_v, arg_valid = ev.column(a.arg)
                        if a.arg.type.kind is T.Kind.DECIMAL:
                            scale = a.arg.type.scale
                    if phase == "single":
                        specs.append(agg_ops.AggSpec(
                            ci.id, a.func, arg_v, arg_valid, scale))
                    elif a.func in ("count", "count_star"):
                        specs.append(agg_ops.AggSpec(
                            ci.id + "@c", a.func, arg_v, arg_valid))
                    elif a.func in ("sum", "avg"):
                        specs.append(agg_ops.AggSpec(
                            ci.id + "@s", "sum", arg_v, arg_valid))
                        if a.func == "avg":
                            specs.append(agg_ops.AggSpec(
                                ci.id + "@c", "count", arg_v, arg_valid))
                    elif a.func in ("min", "max"):
                        specs.append(agg_ops.AggSpec(
                            ci.id + "@m", a.func, arg_v, arg_valid))
                vals, avalids = do_agg(specs)
                for name, v in vals.items():
                    cols[name] = v
                    if avalids.get(name) is not None:
                        valids[name] = avalids[name]
            else:  # final: merge partial states arriving in b
                specs = []
                finals = []

                def state(name, func, col):
                    specs.append(agg_ops.AggSpec(
                        name, func, b.cols[col], b.valids.get(col)))

                for ci, a in aggs:
                    if a.func in ("count", "count_star"):
                        state(ci.id, "sum", ci.id + "@c")
                        finals.append((ci, "count"))
                    elif a.func == "sum":
                        state(ci.id, "sum", ci.id + "@s")
                        finals.append((ci, "sum"))
                    elif a.func == "avg":
                        state(ci.id + "@s", "sum", ci.id + "@s")
                        state(ci.id + "@c", "sum", ci.id + "@c")
                        scale = a.arg.type.scale if (
                            a.arg is not None
                            and a.arg.type.kind is T.Kind.DECIMAL) else 0
                        finals.append((ci, "avg", scale))
                    elif a.func in ("min", "max"):
                        state(ci.id, a.func, ci.id + "@m")
                        finals.append((ci, a.func))
                vals, avalids = do_agg(specs)
                for f in finals:
                    ci = f[0]
                    if f[1] == "avg":
                        s = vals[ci.id + "@s"].to(torch.float64)
                        c = vals[ci.id + "@c"].to(torch.float64)
                        res = s / torch.where(c == 0, torch.ones_like(c), c)
                        if f[2]:
                            res = descale(res, f[2])
                        cols[ci.id] = res
                        valids[ci.id] = vals[ci.id + "@c"] > 0
                    elif f[1] == "count":
                        cols[ci.id] = vals[ci.id].to(torch.int64)
                    else:
                        cols[ci.id] = vals[ci.id]
                        if avalids.get(ci.id) is not None:
                            valids[ci.id] = avalids[ci.id]
            return Batch(cols, valids, meta["used"])

        return run

    def _c_partialstate(self, plan: PartialState):
        return self._compile_node(plan.child)

    # ---- motion --------------------------------------------------------
    def _c_motion(self, plan: Motion):
        child_fn = self._compile_node(plan.child)
        if plan.kind is MotionKind.GATHER:
            raise AssertionError("nested gather")
        nseg = self.nseg

        def exchanged(recv, precv):
            cols = {k: v for k, v in recv.items()
                    if not k.startswith(VALID_PREFIX)}
            valids = {k[len(VALID_PREFIX):]: v for k, v in recv.items()
                      if k.startswith(VALID_PREFIX)}
            return Batch(cols, valids, precv)

        def arrays(b):
            arrs = dict(b.cols)
            for name, v in b.valids.items():
                arrs[VALID_PREFIX + name] = v
            return arrs

        if plan.kind is MotionKind.BROADCAST:
            def run_broadcast(ctx):
                b = child_fn(ctx)
                return exchanged(*motion_ops.broadcast(arrays(b),
                                                       b.selection()))

            return run_broadcast

        # REDISTRIBUTE
        C = self._motion_bucket(self._capacity_of(plan.child))
        nb = max(int(self.s.motion_pipeline_buckets), 1)
        hash_exprs = plan.hash_exprs
        fid = f"motion_overflow_{len(self.flags)}"
        self.flags.append(fid)

        def run(ctx):
            b = child_fn(ctx)
            specs = self._key_specs(b, hash_exprs)
            h = hashing.row_hash([
                hashing.column_hash(s.values, s.valid, s.type,
                                    text_lut=s.hash_lut)
                for s in specs])
            dest = hashing.segment_of(h, nseg)
            recv, precv, overflow = motion_ops.redistribute(
                arrays(b), b.selection(), dest, nseg, C, nbuckets=nb)
            ctx["flags"].append((fid, overflow))
            return exchanged(recv, precv)

        return run

    # ---- sort ----------------------------------------------------------
    def sort_keys(self, batch: Batch, keys):
        ev = Evaluator(batch, self.consts)
        out = []
        for e, desc, nf in keys:
            v, valid = ev.column(e)
            d = self._text_ref(e)
            lut = self._lut("rank", d) if d is not None else None
            out.append(sort_ops.SortKey(v, valid, e.type, desc, nf,
                                        rank_lut=lut))
        return out

    def _c_sort(self, plan: Sort):
        child_fn = self._compile_node(plan.child)
        keys = plan.keys
        cap = self._capacity_of(plan.child)

        def run(ctx):
            b = child_fn(ctx)
            perm, sel_sorted, _ = sort_ops.sort_batch(
                self.sort_keys(b, keys), b.selection(), cap)
            cols, valids = sort_ops.apply_perm(b.cols, b.valids, perm)
            return Batch(cols, valids, sel_sorted)

        return run


def _collect_dict_refs(plan: Plan, out: dict):
    for c in plan.out_cols():
        if c.dict_ref is not None:
            out[c.id] = c.dict_ref
    for ch in plan.children:
        _collect_dict_refs(ch, out)
