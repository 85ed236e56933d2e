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

Lowered here: Scan, Filter, Project, Join (inner, left, semi, anti,
null-aware anti and cross; unique, multi-match and direct-addressed),
Aggregate (dense, sort-based and scalar grouping, single/partial/final,
with the fused-kernel gate), PartialState, Motion (Redistribute,
Broadcast), Sort and Limit, plus the pre-Gather compaction. Window, Union
and ConstRel raise NotImplementedError naming the ROADMAP item that ports
them — at compile time, before anything runs.

Capacities follow the JAX compiler: a Redistribute's per-destination
bucket, a join's hash table and expansion and a sort-based Aggregate's
group table grow 4x per retry tier, and an overflow that reports its exact
need (the pre-Gather compaction, a join expansion, a group count) re-runs
at that size (``cap_overrides``, keyed by preorder plan-node ordinals so
they survive a recompile). A key-packing bounds violation (stale ANALYZE
stats) re-runs the same tier with that node unpacked (``pack_disabled``).
Scan capacities are the largest segment's row count: eager torch has no
compiled executable to reuse across pow2 buckets.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from greengage_tpu_torch import expr as E
from greengage_tpu_torch import to_device
from greengage_tpu_torch import types as T
from greengage_tpu_torch.config import Settings
from greengage_tpu_torch.ops import agg as agg_ops
from greengage_tpu_torch.ops import fused_agg
from greengage_tpu_torch.ops import hashing
from greengage_tpu_torch.ops import join as join_ops
from greengage_tpu_torch.ops import sort as sort_ops
from greengage_tpu_torch.ops.batch import Batch
from greengage_tpu_torch.ops.expr_eval import Evaluator, descale
from greengage_tpu_torch.parallel import motion as motion_ops
from greengage_tpu_torch.parallel.mesh import SegmentLayout
from greengage_tpu_torch.planner.locus import LocusKind
from greengage_tpu_torch.planner.logical import (
    Aggregate, Filter, Join, Limit, Motion, MotionKind, PartialState, Plan,
    Project, Scan, Sort,
)

VALID_PREFIX = "@v:"

# nodes of the JAX compiler this port does not lower yet -> the ROADMAP
# item that ports them
_UNPORTED = {
    "Window": "windows: ROADMAP Queue 1 item 4",
    "Union": "UNION: ROADMAP Queue 1 item 4",
    "ConstRel": "constant relations: ROADMAP Queue 1 item 4",
}


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
    # (limit, offset) of a Limit directly below the Gather, trimmed after
    # the merge; None when there is none
    host_limit: tuple | None = None
    # the gathered child's rows are one copy per segment (replicated):
    # the Gather reads segment 0 only
    replicated: bool = False
    # flag name -> (plan-node ordinal, metric name): an overflow that
    # reports its exact need (the retry sizes that node from it)
    flag_caps: dict = field(default_factory=dict)
    # an Aggregate passed the fused kernel's gate and runs through it
    uses_fused: bool = False
    # pack-overflow flag name -> plan-node ordinal: a bounds violation
    # re-runs the same tier with that node's key packing disabled
    flag_packs: dict = field(default_factory=dict)


class Compiler:
    """``tables``: the staged tables a Scan reads (their capacities and,
    when no ``dictionary`` resolver is given, their dictionaries).
    ``dictionary(ref)`` -> the code -> string list of a (table, column)
    or derived dictionary ref. ``consts``: the binder's constant pool;
    host arrays in it (LUTs) go to the device once, here.
    ``pack_disabled``: plan-node ordinals whose key packing is off (a
    bounds violation in an earlier attempt); ``no_direct`` turns off the
    direct-addressed join, so every join builds the hash table."""

    def __init__(self, layout: SegmentLayout, tables: dict[str, TableData],
                 settings: Settings | None = None, consts: dict | None = None,
                 dictionary=None, tier: int = 0,
                 cap_overrides: dict | None = None,
                 pack_disabled: set | None = None, no_direct: bool = False):
        self.layout = layout
        self.nseg = layout.nseg
        self.device = layout.device
        self.tables = tables
        self.s = settings or Settings()
        self.consts = {k: (to_device(v, self.device)
                           if isinstance(v, np.ndarray) else v)
                       for k, v in (consts or {}).items()}
        self._dictionary = dictionary
        self.tier = tier
        self.cap_overrides = dict(cap_overrides or {})
        self.pack_disabled = set(pack_disabled or ())
        self.no_direct = no_direct
        self.flags: list[str] = []
        self.metrics: list[str] = []
        self.flag_caps: dict = {}
        self.flag_packs: dict = {}
        self.uses_fused = False
        self._nids: dict[int, int] = {}
        self._luts: dict = {}

    # ------------------------------------------------------------------
    def compile(self, plan: Motion) -> CompileResult:
        assert isinstance(plan, Motion) and plan.kind is MotionKind.GATHER
        self.flags, self.metrics = [], []
        self.flag_caps, self.flag_packs, self.uses_fused = {}, {}, False
        # stable plan-node identity: preorder ordinals (cap_overrides cross
        # recompiles of the same plan in the executor's retry loop)
        self._nids = {}
        stack = [plan]
        while stack:
            p = stack.pop()
            self._nids[id(p)] = len(self._nids)
            stack.extend(reversed(p.children))
        below = plan.child
        self._dict_refs: dict[str, tuple] = {}
        _collect_dict_refs(plan, self._dict_refs)
        # only the Limit directly below the Gather has its OFFSET trimmed
        # after the merge; buried Limits drop theirs on the device
        host_limit = None
        self._host_limit_node = None
        if isinstance(below, Limit):
            host_limit = (below.limit, below.offset)
            self._host_limit_node = id(below)
        compiled = self._compile_node(below)
        out_cols = below.out_cols()

        # device-side result compaction before the Gather (Gather Motion,
        # nodeMotion.c:171): when estimated live rows sit far below
        # capacity, stable-sort live-first and ship a small static slice;
        # the exact live count feeds the overflow retry
        compact_k = self._gather_compact_k(plan, below)
        fid_cmp = mid_cmp = None
        if compact_k is not None:
            fid_cmp = f"gather_compact_overflow_{len(self.flags)}"
            self.flags.append(fid_cmp)
            mid_cmp = f"gather_compact_total_{len(self.metrics)}"
            self.metrics.append(mid_cmp)
            self.flag_caps[fid_cmp] = (self._nid(plan), mid_cmp)
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

        replicated = below.locus is not None and below.locus.kind in (
            LocusKind.SEGMENT_GENERAL, LocusKind.GENERAL)
        return CompileResult(
            program=program, out_cols=out_cols, flag_names=flag_names,
            metric_names=metric_names, merge_keys=plan.merge_keys,
            host_limit=host_limit, replicated=replicated,
            flag_caps=dict(self.flag_caps), uses_fused=self.uses_fused,
            flag_packs=dict(self.flag_packs))

    def _nid(self, plan) -> int:
        """Stable preorder ordinal of a plan node (see compile())."""
        return self._nids[id(plan)]

    def _gather_compact_k(self, plan, below) -> int | None:
        """Result-compaction slot count before the Gather, or None when the
        result ships uncompacted."""
        cap_below = self._capacity_of(below)
        if isinstance(below, (Sort, Limit, Aggregate, PartialState)) \
                or cap_below < (1 << 14):
            return None
        est = max(getattr(below, "est_rows", 0.0) or 0.0, 1.0)
        if below.locus is not None and below.locus.is_partitioned \
                and self.nseg > 1:
            est /= self.nseg
        k = _pow2(int(est * 1.5) + 64) * (4 ** self.tier)
        if self._nid(plan) in self.cap_overrides:
            k = _pow2(int(self.cap_overrides[self._nid(plan)]))
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
        if isinstance(plan, Limit):
            cap = self._capacity_of(plan.child)
            if plan.limit is not None:
                return min(cap, plan.limit + plan.offset)
            return cap
        if isinstance(plan, Join):
            probe_cap = self._capacity_of(plan.left)
            if plan.kind == "cross":
                return probe_cap * max(self._capacity_of(plan.right), 1)
            if plan.multi and plan.kind in ("inner", "left"):
                if self._nid(plan) in self.cap_overrides:
                    # exact cardinality reported by the overflowed run
                    return _pow2(max(int(self.cap_overrides[self._nid(plan)]),
                                     64))
                # CSR expansion output capacity from the cardinality
                # estimate; est_rows is CLUSTER-GLOBAL, the batch is per
                # segment — divide by width for partitioned loci (skew is
                # caught by the exact-count overflow retry)
                est = max(plan.est_rows, 64.0) * 1.5
                if plan.locus is not None and plan.locus.is_partitioned \
                        and self.nseg > 1:
                    est /= self.nseg
                base = max(int(est) + 64, probe_cap // 4)
                return _pow2(base) * (4 ** self.tier)
            return probe_cap
        if isinstance(plan, Aggregate):
            if not plan.group_keys:
                return 1
            dense = self._dense_domains(plan)
            if dense is not None:
                d = 1
                for dom in dense:
                    d *= dom
                return d
            # sort-based path: output capacity = estimated group count with
            # slack; never more than the child batch (groups <= rows), and
            # an exact-count retry tightens it after an overflow
            child_cap = self._capacity_of(plan.child)
            if self._nid(plan) in self.cap_overrides:
                return min(_pow2(max(int(self.cap_overrides[self._nid(plan)]),
                                     64)), child_cap)
            est = int(max(plan.est_rows, 16.0) * 1.3) + 64
            return min(_pow2(est) * (4 ** self.tier), child_cap)
        if isinstance(plan, Motion):
            child_cap = self._capacity_of(plan.child)
            if plan.kind is MotionKind.BROADCAST:
                return child_cap * self.nseg
            if plan.kind is MotionKind.REDISTRIBUTE:
                return self.nseg * self._motion_bucket(child_cap)
            return child_cap
        raise NotImplementedError(_unported(plan))

    def _motion_bucket(self, child_cap: int) -> int:
        c = int(child_cap * self.s.motion_capacity_slack / self.nseg) + 64
        return min(_pow2(c) * (4 ** self.tier), child_cap)

    def dictionary(self, ref: tuple) -> list:
        if self._dictionary is not None:
            return self._dictionary(tuple(ref))
        table, col = ref
        return self.tables[table].dicts[col]

    def _dense_domains(self, plan: Aggregate) -> list[int] | None:
        """Per-key dense domains (|dict|+1 / bool 3) when every group key has
        a known finite domain and the product fits the dense limit; None
        sends the grouping down the sort-based path."""
        if not plan.group_keys:
            return None
        domains = []
        prod = 1
        for ci, e in plan.group_keys:
            if ci.type.kind is T.Kind.TEXT:
                d = getattr(e, "_dict_ref", None) or ci.dict_ref
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
        return domains

    def _join_table_size(self, build_cap: int) -> int:
        # 3x headroom keeps the load factor under ~1/3: expected chain ~1.5
        # rounds, and the probe walk only pays what it walks
        m = _pow2(build_cap * 3) * (4 ** self.tier)
        return max(self.s.hash_table_min, min(m, self.s.hash_table_max))

    def _join_probes(self) -> int:
        return self.s.hash_num_probes * (2 ** min(self.tier, 2))

    def _pack_flag(self, plan, bounds, pack_bits):
        """-> (bounds, flag name) when ``plan`` packs its keys into one word
        from ANALYZE ``bounds`` (``pack_bits(bounds)`` not None and packing
        not disabled by an earlier violation), else (None, None). The flag
        reports a live key outside the bounds; the executor then re-runs
        the same tier with this node unpacked."""
        if (bounds is None or self._nid(plan) in self.pack_disabled
                or pack_bits(bounds) is None):
            return None, None
        fid = f"pack_overflow_{len(self.flags)}"
        self.flags.append(fid)
        self.flag_packs[fid] = self._nid(plan)
        return bounds, fid

    # ------------------------------------------------------------------
    # node compilation (returns closures ctx -> Batch)
    # ------------------------------------------------------------------
    def _compile_node(self, plan: Plan):
        m = getattr(self, "_c_" + type(plan).__name__.lower(), None)
        if m is None:
            raise NotImplementedError(_unported(plan))
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
        if plan.parts is not None:
            raise NotImplementedError(
                "partitioned tables: ROADMAP Queue 1 item 1a (durable "
                "storage)")
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
                lut = to_device(np.concatenate(
                    [order.astype(np.int64), [-1]]), self.device)
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

    # ---- joins ---------------------------------------------------------
    def _c_join(self, plan: Join):
        if plan.kind == "cross":
            return self._c_join_cross(plan)
        if plan.multi:
            return self._c_join_multi(plan)
        left_fn = self._compile_node(plan.left)
        right_fn = self._compile_node(plan.right)
        build_cap = self._capacity_of(plan.right)
        M = self._join_table_size(build_cap)
        probes = self._join_probes()
        lkeys, rkeys = plan.left_keys, plan.right_keys
        kind = plan.kind
        residual = plan.residual
        fid_ov = f"join_overflow_{len(self.flags)}"
        self.flags.append(fid_ov)
        fid_dup = None
        if kind in ("inner", "left"):
            # semi/anti only need existence: duplicate build keys are fine
            fid_dup = f"join_dup_{len(self.flags)}"
            self.flags.append(fid_dup)
        right_cols = plan.right.out_cols()
        null_aware = plan.null_aware
        # direct addressing at tier 0 only: a build-overflow retry (stale
        # stats: live keys outside the analyzed domain) takes the general
        # hash table at tier 1
        direct = (plan.direct_domain is not None and self.tier == 0
                  and len(rkeys) == 1 and not self.no_direct)
        direct_lo = plan.direct_lo or 0
        direct_domain = plan.direct_domain or 0
        jkb, fid_pack = (None, None) if direct else self._pack_flag(
            plan, getattr(plan, "key_bounds", None), join_ops.join_pack_bits)

        def run(ctx):
            lb = left_fn(ctx)
            rb = right_fn(ctx)
            rspecs = self._value_specs(rb, rkeys)
            lspecs = self._value_specs(lb, lkeys)
            if direct:
                table = join_ops.build_direct(
                    rspecs[0], rb.selection(), direct_lo, direct_domain)
                matched, brow = join_ops.probe_direct(
                    table, lspecs[0], lb.selection(), direct_lo)
                overflow = table.overflow
            else:
                table = join_ops.build(rspecs, rb.selection(), M, probes, jkb)
                matched, brow, walk_ov = join_ops.probe(
                    table, lspecs, lb.selection(), probes)
                if fid_pack is not None:
                    ctx["flags"].append((fid_pack, table.pack_viol))
                overflow = walk_ov
            ctx["flags"].append((fid_ov, overflow))
            if fid_dup is not None:
                ctx["flags"].append((fid_dup, table.dup))
            cols = dict(lb.cols)
            valids = dict(lb.valids)
            sel = lb.selection()
            if kind in ("inner", "semi"):
                sel = sel & matched
            elif kind == "anti" and null_aware:
                # NOT IN semantics: an empty subquery qualifies every row;
                # otherwise NULL probe keys and any NULL subquery key
                # disqualify (the result is NULL, so filtered). The
                # subquery's emptiness and NULLs are over every segment: a
                # reduction over the whole tensor, on the device
                rsel = rb.selection()
                s_nonempty = rsel.any()
                s_has_null = torch.zeros((), dtype=torch.bool,
                                         device=sel.device)
                x_null = torch.zeros_like(sel)
                for sp in rspecs:
                    if sp.valid is not None:
                        s_has_null = s_has_null | (rsel & ~sp.valid).any()
                for sp in lspecs:
                    if sp.valid is not None:
                        x_null = x_null | ~sp.valid
                sel = sel & torch.where(s_nonempty,
                                        ~x_null & ~matched & ~s_has_null,
                                        True)
            elif kind == "anti":
                sel = sel & ~matched
            if kind in ("inner", "left"):
                g_cols, g_valids = join_ops.gather_build_columns(
                    {c.id: rb.cols[c.id] for c in right_cols},
                    {c.id: rb.valids.get(c.id) for c in right_cols},
                    brow, matched)
                cols.update(g_cols)
                valids.update(g_valids)
            out = Batch(cols, valids, sel)
            if residual is not None:
                mask = Evaluator(out, self.consts).predicate(residual)
                if kind == "left":
                    # the residual only disqualifies the match, not the row
                    newm = matched & mask
                    for c in right_cols:
                        out.valids[c.id] = out.valids[c.id] & newm
                else:
                    out = out.with_sel(out.selection() & mask)
            return out

        return run

    def _value_specs(self, batch: Batch, exprs):
        """Keys as values and NULL masks only: joins and the sort-based
        grouping compare TEXT codes (the binder puts both sides of a join
        in one code space), so no dictionary hash LUT is needed."""
        ev = Evaluator(batch, self.consts)
        return [agg_ops.KeySpec(*ev.column(e), e.type) for e in exprs]

    def _c_join_cross(self, plan: Join):
        """Cartesian pairing by repeat/tile index expansion — practical for
        the small (usually broadcast) build sides the planner produces;
        capacity = |L| x |B|."""
        left_fn = self._compile_node(plan.left)
        right_fn = self._compile_node(plan.right)
        Lcap = self._capacity_of(plan.left)
        Bcap = max(self._capacity_of(plan.right), 1)

        def run(ctx):
            lb = left_fn(ctx)
            rb = right_fn(ctx)
            S = lb.selection().shape[0]
            dev = lb.device
            li = torch.arange(Lcap, device=dev).repeat_interleave(Bcap)
            ri = torch.arange(Bcap, device=dev).repeat(Lcap)
            li, ri = li.expand(S, -1), ri.expand(S, -1)
            cols = {cid: a.gather(1, li) for cid, a in lb.cols.items()}
            cols.update({cid: a.gather(1, ri) for cid, a in rb.cols.items()})
            valids = {cid: v.gather(1, li) for cid, v in lb.valids.items()}
            valids.update({cid: v.gather(1, ri)
                           for cid, v in rb.valids.items()})
            sel = lb.selection().gather(1, li) & rb.selection().gather(1, ri)
            return Batch(cols, valids, sel)

        return run

    def _join_multi_expand_cap(self, plan: Join) -> int:
        """Semi/anti multi-join pair-EXPANSION capacity: the output is
        probe-shaped (_capacity_of), but the matched-pair expansion needs
        its own slot count — the exact-total retry hint, else the
        planner's stats-driven pair estimate (|L||R|/NDV), else a blind
        multiple of the probe capacity."""
        probe_cap0 = self._capacity_of(plan.left)
        if self._nid(plan) in self.cap_overrides:
            out_cap = _pow2(max(int(self.cap_overrides[self._nid(plan)]), 64))
        else:
            est = getattr(plan, "expand_est", None)
            if est:
                if plan.locus is not None and plan.locus.is_partitioned \
                        and self.nseg > 1:
                    est /= self.nseg
                out_cap = _pow2(int(est * 1.5) + 64)
            else:
                out_cap = _pow2(probe_cap0 * 2 + 64)
        return int(out_cap * (4 ** self.tier))

    def _c_join_multi(self, plan: Join):
        """Duplicate-capable join via CSR expansion: inner/left emit the
        matched pairs; semi/anti reduce the pairs back to PROBE rows with
        an any-match scatter — the shape EXISTS correlation with residual
        predicates needs (a probe row qualifies iff ANY duplicate build
        row passes equality AND the residual)."""
        left_fn = self._compile_node(plan.left)
        right_fn = self._compile_node(plan.right)
        build_cap = self._capacity_of(plan.right)
        M = self._join_table_size(build_cap)
        if plan.kind in ("semi", "anti"):
            out_cap = self._join_multi_expand_cap(plan)
        else:
            out_cap = self._capacity_of(plan)
        probes = self._join_probes()
        lkeys, rkeys = plan.left_keys, plan.right_keys
        kind = plan.kind
        residual = plan.residual
        fid_ov = f"join_overflow_{len(self.flags)}"
        self.flags.append(fid_ov)
        fid_exp = f"join_expand_overflow_{len(self.flags)}"
        self.flags.append(fid_exp)
        mid_total = f"join_expand_total_{len(self.metrics)}"
        self.metrics.append(mid_total)
        # an overflow retry sizes itself from the exact reported cardinality
        self.flag_caps[fid_exp] = (self._nid(plan), mid_total)
        left_cols = plan.left.out_cols()
        right_cols = plan.right.out_cols()
        jkb, fid_pack = self._pack_flag(
            plan, getattr(plan, "key_bounds", None), join_ops.join_pack_bits)

        def pairs(lb, rb, prow, brow, matched):
            """Columns of the expanded pairs: probe side at prow, build side
            at brow (NULL where unmatched)."""
            cols, valids = {}, {}
            for c in left_cols:
                cols[c.id] = lb.cols[c.id].gather(1, prow)
                v = lb.valids.get(c.id)
                if v is not None:
                    valids[c.id] = v.gather(1, prow)
            g_cols, g_valids = join_ops.gather_build_columns(
                {c.id: rb.cols[c.id] for c in right_cols},
                {c.id: rb.valids.get(c.id) for c in right_cols},
                brow, matched)
            cols.update(g_cols)
            valids.update(g_valids)
            return cols, valids

        def any_per_probe(prow, keep, P):
            """bool [nseg, P]: whether any kept pair came from each probe
            row. Each kept pair stores True at its probe row and the rest
            go to the spare slot P: plain stores, which give the slots the
            JAX package's scatter-max of the 0/1 flags gives."""
            S = prow.shape[0]
            out = torch.zeros((S, P + 1), dtype=torch.bool,
                              device=prow.device)
            return out.scatter_(1, torch.where(keep, prow, P), True)[:, :P]

        def run(ctx):
            lb = left_fn(ctx)
            rb = right_fn(ctx)
            table = join_ops.build_multi(
                self._value_specs(rb, rkeys), rb.selection(), M, probes,
                jkb)
            (present, prow, brow, matched, expand_ov, walk_ov,
             total) = join_ops.probe_multi(
                table, self._value_specs(lb, lkeys), lb.selection(),
                probes, out_cap, left_outer=(kind == "left"))
            if fid_pack is not None:
                ctx["flags"].append((fid_pack, table.pack_viol))
            # walk overflow rides the table flag (the tier retry grows the
            # table and the hop bound); expand overflow rides its own flag,
            # whose retry hint sizes out_cap from `total`
            ctx["flags"].append((fid_ov, walk_ov))
            ctx["flags"].append((fid_exp, expand_ov))
            ctx["metrics"].append((mid_total, total))
            lsel = lb.selection()
            P = lsel.shape[1]
            if kind in ("semi", "anti"):
                # evaluate the residual on the PAIR batch, then reduce to
                # per-probe-row existence
                keep = present & matched
                if residual is not None:
                    pcols, pvalids = pairs(lb, rb, prow, brow, matched)
                    keep = keep & Evaluator(Batch(pcols, pvalids, keep),
                                            self.consts).predicate(residual)
                any_kept = any_per_probe(prow, keep, P)
                sel2 = lsel & any_kept if kind == "semi" \
                    else lsel & ~any_kept
                return Batch(dict(lb.cols), dict(lb.valids), sel2)
            cols, valids = pairs(lb, rb, prow, brow, matched)
            sel = present if kind == "left" else (present & matched)
            out = Batch(cols, valids, sel)
            if residual is not None:
                mask = Evaluator(out, self.consts).predicate(residual)
                if kind == "left":
                    # per-match disqualification over duplicate builds
                    # (TPC-H Q13 shape): a pair failing the residual drops
                    # its output row — UNLESS the probe row then has no
                    # surviving pair, in which case its FIRST expanded row
                    # becomes the single null-extended row
                    keep = matched & mask
                    any_kept = any_per_probe(prow, present & keep, P)
                    first = torch.ones_like(present)
                    first[:, 1:] = prow[:, 1:] != prow[:, :-1]
                    null_row = present & first & ~any_kept.gather(1, prow)
                    out = out.with_sel(present & (keep | null_row))
                    for c in right_cols:
                        out.valids[c.id] = out.valids[c.id] & keep
                else:
                    out = out.with_sel(out.selection() & mask)
            return out

        return run

    # ---- aggregation ---------------------------------------------------
    def _c_aggregate(self, plan: Aggregate):
        child_fn = self._compile_node(plan.child)
        keys = plan.group_keys
        # dense grouping over known finite key domains, the sort-based path
        # for every other GROUP BY, or the scalar aggregate (no keys: one
        # slot per segment)
        dense = self._dense_domains(plan)
        use_sort = bool(keys) and dense is None
        M = 1
        for dom in dense or ():
            M *= dom
        aggs = plan.aggs
        phase = plan.phase
        out_cap = self._capacity_of(plan) if use_sort else None
        fid = mid = None
        if use_sort and out_cap < self._capacity_of(plan.child):
            # output capacity below the theoretical max: the group count
            # can overflow it; the device reports the exact count for the
            # retry
            fid = f"agg_overflow_{len(self.flags)}"
            self.flags.append(fid)
            mid = f"agg_groups_{len(self.metrics)}"
            self.metrics.append(mid)
            self.flag_caps[fid] = (self._nid(plan), mid)
        # packed single-operand group sort from ANALYZE key bounds
        key_bounds, fid_pack = self._pack_flag(
            plan, getattr(plan, "key_bounds", None),
            agg_ops.pack_bits) if use_sort else (None, None)

        # the fused single-pass kernel, gated as in the JAX package so both
        # packages take it on the same plans: big enough batches, a small
        # domain, and the accumulator bound the TPU kernel's scratch needs.
        # Aggregates past one launch's job table take one launch per run
        # of jobs (fused_agg.split_jobs)
        n_acc_est = sum(2 if a.func == "avg" else 1 for _, a in aggs) + 1
        fused_ok = (dense is not None and self.s.fused_dense_agg
                    and M <= self.s.fused_dense_max_domain
                    and n_acc_est * M * 128 * 8
                    <= self.s.fused_dense_max_scratch_mb << 20
                    and (self._capacity_of(plan.child)
                         >= self.s.fused_dense_min_rows))
        if fused_ok:
            self.uses_fused = True

        def run(ctx):
            b = child_fn(ctx)
            sel = b.selection()
            S = sel.shape[0]
            cols, valids = {}, {}
            gid = perm = None
            if use_sort:
                # sort by keys, cumsum-span reduce into the group table;
                # slot g's keys gather from its first row
                kspecs = self._value_specs(b, [e for _, e in keys])
                perm, boundary, sel_sorted, pack_viol = agg_ops.group_sort(
                    kspecs, sel, key_bounds)
                if fid_pack is not None:
                    ctx["flags"].append((fid_pack, pack_viol))
            elif keys:
                kspecs = self._key_specs(b, [e for _, e in keys])
                gid, _ = agg_ops.dense_gid(kspecs, dense, sel)
                for (ci, _), (code, valid) in zip(
                        keys, agg_ops.dense_decode_keys(kspecs, dense, M)):
                    cols[ci.id] = code.expand(S, M)
                    valids[ci.id] = valid.expand(S, M)
            ev = Evaluator(b, self.consts)
            meta = {}

            def do_agg(specs):
                if perm is not None:
                    ps = [agg_ops.AggSpec(
                        sp.name, sp.func,
                        None if sp.values is None
                        else sp.values.gather(1, perm),
                        None if sp.valid is None else sp.valid.gather(1, perm),
                        sp.decimal_scale) for sp in specs]
                    vals, avalids, meta["srcpos"], meta["total"] = \
                        agg_ops.sorted_group_aggregate(
                            boundary, sel_sorted, ps, out_cap)
                    return vals, avalids
                if gid is None:
                    # scalar aggregate: every segment emits its one row,
                    # live even when the segment had no rows (a partial
                    # count of 0, a NULL sum)
                    meta["used"] = torch.ones((S, 1), dtype=torch.bool,
                                              device=sel.device)
                    return agg_ops.scalar_aggregate(specs, sel)
                # "@used" rides the same pass: per-group live-row presence
                specs2 = list(specs) + [
                    agg_ops.AggSpec("@used", "count_star", None, None)]
                if fused_ok and fused_agg.supported(specs2):
                    vals, avalids = fused_agg.fused_dense_aggregate(
                        gid, M, specs2, sel)
                else:
                    vals, avalids = agg_ops.dense_aggregate(gid, M, specs2,
                                                            sel)
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
            if perm is not None:
                # group g's key values gather from its first sorted row
                rep = perm.gather(1, meta["srcpos"])
                for (ci, _), sp in zip(keys, kspecs):
                    cols[ci.id] = sp.values.gather(1, rep)
                    if sp.valid is not None:
                        valids[ci.id] = sp.valid.gather(1, rep)
                total = meta["total"]
                meta["used"] = torch.arange(out_cap, device=sel.device) \
                    < total[:, None]
                if fid is not None:
                    # the overflow reports the exact group count so the
                    # retry sizes itself right
                    ctx["flags"].append((fid, (total > out_cap).any()))
                    ctx["metrics"].append((mid, total))
            return Batch(cols, valids, meta["used"])

        return run

    def _c_partialstate(self, plan: PartialState):
        return self._compile_node(plan.child)

    def _c_limit(self, plan: Limit):
        child_fn = self._compile_node(plan.child)
        cap = self._capacity_of(plan.child)
        # LIMIT 0 is a real limit
        k = min(cap, (cap if plan.limit is None else plan.limit)
                + plan.offset)
        compacted = isinstance(plan.child, Sort)
        # a buried Limit (not the one trimmed after the Gather's merge)
        # drops its OFFSET prefix itself: rows are compacted live-first,
        # so masking the first `offset` positions removes exactly those
        device_offset = plan.offset if id(plan) != self._host_limit_node \
            else 0

        def run(ctx):
            b = child_fn(ctx)
            if compacted:
                cols, valids, sel = sort_ops.limit(
                    b.cols, b.valids, b.selection(), k)
            else:
                # unsorted LIMIT: gather-compact live rows (order kept)
                # straight into the k-slot output
                cols, valids, sel = sort_ops.compact(
                    b.cols, b.valids, b.selection(), k)
            if device_offset:
                sel = sel & (torch.arange(k, device=sel.device)
                             >= device_offset)
            return Batch(cols, valids, sel)

        return run

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


def _unported(plan: Plan) -> str:
    name = type(plan).__name__
    return f"{name}: " + _UNPORTED.get(name, "not lowered by this compiler")


def _collect_dict_refs(plan: Plan, out: dict):
    for c in plan.out_cols():
        if c.dict_ref is not None:
            out[c.id] = c.dict_ref
    for ch in plan.children:
        _collect_dict_refs(ch, out)
