"""Physical compiler: planned tree -> one program over every segment.

The port's counterpart of greengage_tpu/exec/compile.py. The JAX package
traces the plan below the top Gather Motion into one function and runs it
under ``jax.jit(shard_map(...))``, one instance per segment. The port
lowers the same nodes into an eager torch closure over ``[nseg, cap]``
tensors (parallel/mesh.py): every operator handles all segments at once,
and Motions are tensor ops over the segment axis (parallel/motion.py).

The contract with the caller is the JAX package's: overflow flags
(motion bucket, gather compaction) and metrics (Filter row counts,
compaction totals) come back by name beside the output columns. Every
Filter counts its output rows on every run (the selectivity the planner
gets most wrong, fed back through planner/feedback.py); an ``instrument``
program (EXPLAIN ANALYZE) counts every node's. ``node_rows`` maps each
such metric to its plan node (``id``), and the counts ride the one host
copy that brings back the flags: no extra synchronisation.

Lowered here: Scan, Filter, Project, Join (inner, left, semi, anti,
null-aware anti and cross; unique, multi-match and direct-addressed),
Aggregate (dense, sort-based and scalar grouping, single/partial/final,
with the fused-kernel gate), PartialState, Motion (Redistribute by hash
or by sampled-splitter ranges, Broadcast), Window (segment-local, and the
global unordered, ordered and range modes), Union, ConstRel, Sort and
Limit, plus the pre-Gather compaction. The JAX compiler's collectives map
onto the leading segment axis: ``all_gather`` is the ``[nseg, ...]``
tensor itself, ``psum``/``pmin``/``pmax`` reduce over dim 1 and then dim
0, ``axis_index`` is ``arange(nseg)[:, None]`` and "the segments before
this one" an exclusive cumsum along dim 0.

Capacities follow the JAX compiler: a Redistribute's per-destination
bucket, a join's hash table and expansion and a sort-based Aggregate's
group table grow 4x per retry tier, and an overflow that reports its exact
need (the pre-Gather compaction, a join expansion, a group count) re-runs
at that size (``cap_overrides``, keyed by preorder plan-node ordinals so
they survive a recompile). A key-packing bounds violation (stale ANALYZE
stats) re-runs the same tier with that node unpacked (``pack_disabled``).
Staged scan capacities are the largest segment's row count: eager torch
has no compiled executable to reuse across pow2 buckets. Each table also
carries the capacity the JAX compiler gives the same scan (the power of
two of that count, an exact spill chunk, an aux table's even split):
``_capacity_of(plan, ref=True)`` reads those, and sizes the Redistribute
buckets and the per-segment byte estimate (``est_bytes``, the admission
check's input), so both equal the JAX package's without growing the
staged buffers.

A batched program (``batch_width`` W > 0, exec/batchserve.py) serves W
same-shape statements that differ only in their hoisted literals: the
same per-member body runs under ``torch.func.vmap`` over a ``[W, nparams]``
int64 parameter tensor, each member seeing the classic ``[nparams]``
"@params@rt" contract. Tables are closed over, not batched (every member
scans the same staged columns); outputs, flags and metrics gain a leading
member axis, and ``est_bytes`` counts W members. A batched program never
takes the fused kernel (it has no vmap batching rule, as the Pallas
kernel has none in the JAX package). The classic program (W = 0) is the
body itself.
"""

from __future__ import annotations

import copy
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
from greengage_tpu_torch.ops import window as win_ops
from greengage_tpu_torch.ops.batch import Batch
from greengage_tpu_torch.ops.expr_eval import Evaluator, descale
from greengage_tpu_torch.parallel import motion as motion_ops
from greengage_tpu_torch.parallel.mesh import SegmentLayout
from greengage_tpu_torch.planner.locus import LocusKind
from greengage_tpu_torch.planner.logical import (
    Aggregate, ConstRel, Filter, Join, Limit, Motion, MotionKind,
    PartialState, Plan, Project, Scan, Sort, Union, Window,
)

VALID_PREFIX = "@v:"
# signed images of the uint64 extremes: 0 and 0xFFFF_FFFF_FFFF_FFFF
ENC_MIN = -(1 << 63)
ENC_MAX = (1 << 63) - 1
# the positional window functions that read another row's value
VALUE_FUNCS = ("lag", "lead", "first_value", "last_value")


def _pow2(n: float) -> int:
    m = 1
    while m < n:
        m <<= 1
    return m


def _before(x):
    """Exclusive cumsum along the segment axis (dim 0): each segment's sum
    of the segments before it."""
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]]).cumsum(0)


def _lag_lead_lookup(fname, param, rn0, n_total, lookup, live):
    """lag/lead via a global position lookup -> (values, valid); the
    SQL-standard default argument replaces out-of-partition offsets.
    Shared by the ordered-global and range window lowerings."""
    k, default = param if isinstance(param, tuple) else (param, None)
    p = rn0 - k if fname == "lag" else rn0 + k
    ok = (p >= 0) & (p < n_total)
    val, vv = lookup(p)
    if default is not None:
        val = torch.where(ok, val, torch.full_like(val, default))
        return val, (ok & vv | ~ok) & live
    return val, ok & vv & live


@dataclass
class ScanSpec:
    """What a plan's scans of one table ask staging for: the JAX compiler's
    per-table scan state (``scan_cols``, ``scan_direct``, ``scan_count``,
    ``scan_prune``, ``scan_parts``, ``scan_dyn``) and the decisions its
    input spec ``(table, cols, cap, direct, prune, child_parts, dyn)``
    makes from it. ``directs`` holds every scan's direct-dispatch
    segment; ``direct`` is the pin every scan agrees on (None when any
    differs); ``prune`` applies only to a table scanned once (a second
    scan would need the pruned-away rows); ``parts`` is the UNION of the
    child tables the scans of a partitioned parent keep; ``dyn`` the
    join-driven partition selector's source, dropped when two scans name
    different ones."""

    cols: set = field(default_factory=set)
    directs: list = field(default_factory=list)
    count: int = 0
    prune: tuple = ()
    parts: tuple | None = None
    dyn: object = "unset"
    index_hits: tuple = ()

    @property
    def direct(self):
        d = self.directs
        return d[0] if d and all(x == d[0] for x in d) else None

    @property
    def staged_prune(self) -> tuple | None:
        return (self.prune or None) if self.count == 1 else None

    @property
    def staged_dyn(self):
        return self.dyn if isinstance(self.dyn, tuple) else None


def collect_scans(plan: Plan, out: dict | None = None) -> dict:
    """table -> ScanSpec of every Scan in ``plan`` (the JAX compiler's
    _collect_scans: two scans of one parent stage the union of their
    parts; the last scan's pushed predicates stand, used only when it is
    the one scan)."""
    out = {} if out is None else out
    if isinstance(plan, Scan):
        sp = out.setdefault(plan.table, ScanSpec())
        sp.cols.update(c.name for c in plan.cols)
        sp.directs.append(plan.direct_seg)
        sp.count += 1
        sp.prune = tuple(plan.prune_preds or ())
        if plan.parts is not None:
            sp.parts = (tuple(dict.fromkeys((sp.parts or ()) + plan.parts))
                        if sp.parts is not None else plan.parts)
        dyn = getattr(plan, "dyn_prune", None)
        sp.dyn = dyn if sp.dyn in ("unset", dyn) else None
        sp.index_hits = tuple(plan.index_hits or ())
    for c in plan.children:
        collect_scans(c, out)
    return out


@dataclass
class TableShape:
    """What compiling a Scan reads of its table: the staged row capacity
    and the JAX compiler's capacity for the same scan (``ref_capacity``,
    0 = the staged one). Dictionaries come from the compiler's resolver.
    Staging's decisions ride along (exec/executor.py table_shapes): the
    direct-dispatch segment read alone, the resolved zone-map predicates,
    the child tables of a partitioned parent after the join-driven
    selector, and the (kept, total) blocks and children they keep."""

    name: str
    capacity: int
    ref_capacity: int = 0
    direct: int | None = None
    prune: tuple | None = None
    parts: tuple | None = None
    zone: tuple | None = None
    dyn: tuple | None = None
    index: tuple = ()


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
    ref_capacity: int = 0

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
    # per-segment device bytes of the whole program, every node's batch
    # capacity times its column widths (the JAX compiler's _estimate_bytes,
    # on the same capacities): the admission check's input. node_est_bytes
    # holds each node's slice by id(node)
    est_bytes: int = 0
    node_est_bytes: dict = field(default_factory=dict)
    # row-count metric name -> id(plan node) it counts (every Filter; every
    # node of an instrumented program)
    node_rows: dict = field(default_factory=dict)
    # members of a batched program (its outputs' leading axis); 0 = classic
    batch_width: int = 0
    # a batched program's feedback key, f"{cache key}@w{bucket}", and its
    # measurement holder (exec/executor.py prepare_batch): each width
    # bucket is measured and admitted by its own bytes
    fb_key: str | None = None
    batch_prog: object = None
    # a batched program's stacked parameters on the device
    batch_params: object = None


class Compiler:
    """``tables``: the staged tables a Scan reads (their capacities and,
    when no ``dictionary`` resolver is given, their dictionaries).
    ``dictionary(ref)`` -> the code -> string list of a (table, column)
    or derived dictionary ref. ``consts``: the binder's constant pool;
    host arrays in it (LUTs) go to the device once, here.
    ``pack_disabled``: plan-node ordinals whose key packing is off (a
    bounds violation in an earlier attempt); ``no_direct`` turns off the
    direct-addressed join, so every join builds the hash table. Compiling
    reads only the tables' shapes (``TableShape`` or ``TableData``): the
    program takes the staged tables when it runs. ``batch_width`` W > 0
    builds the batched program over a ``[W, nparams]`` "@params@rt", with
    every Aggregate off the fused kernel (module docstring).
    ``instrument`` puts a row counter on every node (EXPLAIN ANALYZE); the
    fused gate stays as it is, so an instrumented Q1 launches the kernel
    as the plain run does."""

    def __init__(self, layout: SegmentLayout, tables: dict,
                 settings: Settings | None = None, consts: dict | None = None,
                 dictionary=None, tier: int = 0,
                 cap_overrides: dict | None = None,
                 pack_disabled: set | None = None, no_direct: bool = False,
                 batch_width: int = 0, instrument: bool = False):
        self.layout = layout
        self.nseg = layout.nseg
        self.device = layout.device
        self.tables = tables
        self.s = settings or Settings()
        self._host_consts = {k: v for k, v in (consts or {}).items()
                             if not isinstance(v, torch.Tensor)}
        self.consts = {k: (to_device(v, self.device)
                           if isinstance(v, np.ndarray) else v)
                       for k, v in (consts or {}).items()}
        self._dictionary = dictionary
        self.tier = tier
        self.cap_overrides = dict(cap_overrides or {})
        self.pack_disabled = set(pack_disabled or ())
        self.no_direct = no_direct
        self.batch_width = int(batch_width)
        self.instrument = bool(instrument)
        self.flags: list[str] = []
        self.metrics: list[str] = []
        self.node_rows: dict[str, int] = {}
        self.flag_caps: dict = {}
        self.flag_packs: dict = {}
        self.uses_fused = False
        self._nids: dict[int, int] = {}
        self._luts: dict = {}

    # ------------------------------------------------------------------
    def compile(self, plan: Motion) -> CompileResult:
        assert isinstance(plan, Motion) and plan.kind is MotionKind.GATHER
        self.flags, self.metrics, self.node_rows = [], [], {}
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

        if self.batch_width:
            program = self._batched(program)
        replicated = below.locus is not None and below.locus.kind in (
            LocusKind.SEGMENT_GENERAL, LocusKind.GENERAL)
        est_bytes = self._estimate_bytes(below) * max(self.batch_width, 1)
        return CompileResult(
            program=program, out_cols=out_cols, flag_names=flag_names,
            metric_names=metric_names, merge_keys=plan.merge_keys,
            host_limit=host_limit, replicated=replicated,
            flag_caps=dict(self.flag_caps), uses_fused=self.uses_fused,
            flag_packs=dict(self.flag_packs), est_bytes=est_bytes,
            node_est_bytes=dict(self.node_est_bytes),
            node_rows=dict(self.node_rows), batch_width=self.batch_width)

    def _batched(self, program):
        """The classic program's body vmapped over the members' parameter
        rows: "@params@rt" holds ``[W, nparams]`` when the program runs,
        and each member's body reads its own row under the same key. The
        tables are closed over, so every member reads the same staged
        columns; every output gains a leading ``[W]`` axis."""

        def batched(tables: dict[str, TableData]) -> ProgramOutput:
            pstack = self.consts["@params@rt"]
            assert pstack.dim() == 2 and pstack.shape[0] == \
                self.batch_width, "a batched program needs [W, nparams]"

            def one_member(prow):
                self.consts["@params@rt"] = prow
                o = program(tables)
                return o.cols, o.valids, o.sel, o.flags, o.metrics

            try:
                out = torch.func.vmap(one_member)(pstack)
            finally:
                self.consts["@params@rt"] = pstack
            return ProgramOutput(*out)

        return batched

    def host_copy(self, params=None) -> "Compiler":
        """This compiler's key and dictionary state on the CPU, with
        ``params`` (a member's int64 parameter row) as "@params@rt": the
        batch demux finishes each member's Gather over the member's host
        copy (exec/executor.demux_batch). Built from the host constants,
        so it reads nothing back from the card."""
        hc = copy.copy(self)
        hc.layout = SegmentLayout(self.nseg, torch.device("cpu"))
        hc.device = hc.layout.device
        hc.consts = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                         else v) for k, v in self._host_consts.items()}
        if params is not None:
            hc.consts["@params@rt"] = torch.from_numpy(np.asarray(params))
        hc._luts = {}
        return hc

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
    def _capacity_of(self, plan: Plan, ref: bool = False) -> int:
        """Static per-segment row capacity of a node's output batch; with
        ``ref``, the JAX compiler's capacity for it (scans at their
        reference capacities). Redistribute buckets are sized from the
        reference capacity either way, so a Motion's output is the JAX
        package's in both."""
        if isinstance(plan, ConstRel):
            return 1
        if isinstance(plan, Scan):
            t = self.tables[plan.table]
            return (t.ref_capacity or t.capacity) if ref else t.capacity
        if isinstance(plan, (Filter, Project, Sort, PartialState, Window)):
            return self._capacity_of(plan.child, ref)
        if isinstance(plan, Limit):
            cap = self._capacity_of(plan.child, ref)
            if plan.limit is not None:
                return min(cap, plan.limit + plan.offset)
            return cap
        if isinstance(plan, Join):
            probe_cap = self._capacity_of(plan.left, ref)
            if plan.kind == "cross":
                return probe_cap * max(self._capacity_of(plan.right, ref), 1)
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
            child_cap = self._capacity_of(plan.child, ref)
            if self._nid(plan) in self.cap_overrides:
                return min(_pow2(max(int(self.cap_overrides[self._nid(plan)]),
                                     64)), child_cap)
            est = int(max(plan.est_rows, 16.0) * 1.3) + 64
            return min(_pow2(est) * (4 ** self.tier), child_cap)
        if isinstance(plan, Union):
            return sum(self._capacity_of(c, ref) for c in plan.inputs)
        if isinstance(plan, Motion):
            child_cap = self._capacity_of(plan.child, ref)
            if plan.kind is MotionKind.BROADCAST:
                return child_cap * self.nseg
            if plan.kind is MotionKind.REDISTRIBUTE:
                return self.nseg * self._motion_bucket(
                    self._capacity_of(plan.child, ref=True))
            return child_cap
        raise NotImplementedError(_unported(plan))

    def _motion_bucket(self, child_cap: int) -> int:
        """Rows per destination of a Redistribute, from the child's
        reference capacity as the JAX compiler sizes it. It may exceed the
        staged child's rows: the bucket holds at most that many."""
        c = int(child_cap * self.s.motion_capacity_slack / self.nseg) + 64
        return min(_pow2(c) * (4 ** self.tier), child_cap)

    def _estimate_bytes(self, plan: Plan) -> int:
        """Per-segment device bytes of the program below the Gather (the
        JAX compiler's _estimate_bytes on its capacities): every node's
        batch capacity times its column widths, plus an ordered or range
        window's gathered key runs and a join's build table, summed over
        the tree. Each node's slice lands in ``node_est_bytes``."""
        total = 0
        self.node_est_bytes: dict[int, int] = {}
        stack = [plan]
        while stack:
            p = stack.pop()
            try:
                cap = self._capacity_of(p, ref=True)
            except NotImplementedError:
                cap = 0
            width = sum(max(c.type.np_dtype.itemsize, 1) + 1
                        for c in p.out_cols())
            node_bytes = cap * width
            if isinstance(p, Window) \
                    and getattr(p, "global_mode", False) in ("ordered",
                                                             "range"):
                # the sorted key runs of every segment [nseg, cap] (8 B
                # keys) plus one (value, valid) run per positional
                # function argument
                extra = cap * self.nseg * 9
                for _ci, fname, arg, _o, _pp in p.wfuncs:
                    if fname in VALUE_FUNCS and arg is not None:
                        extra += cap * self.nseg * (
                            max(arg.type.np_dtype.itemsize, 1) + 1)
                node_bytes += extra
            if isinstance(p, Join):
                if getattr(p, "direct_domain", None) is not None \
                        and self.tier == 0 and not self.no_direct:
                    # dense build table: slot rows and counts
                    node_bytes += int(p.direct_domain) * 16
                else:
                    try:
                        node_bytes += self._join_table_size(
                            self._capacity_of(p.right, ref=True)) * 16
                    except NotImplementedError:
                        pass
            self.node_est_bytes[id(p)] = node_bytes
            total += node_bytes
            stack.extend(p.children)
        return total

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
        if not self.instrument and not isinstance(plan, Filter):
            return fn
        # always-on row counters on Filter outputs (selectivity is the
        # estimate the planner gets most wrong, and one reduction per
        # Filter is cheap enough for every run), and on every node of an
        # instrumented program (the explain_gp.c per-operator
        # Instrumentation analog)
        mid = f"nrows_{len(self.metrics)}"
        self.metrics.append(mid)
        self.node_rows[mid] = id(plan)

        def counted(ctx):
            b = fn(ctx)
            ctx["metrics"].append((mid, b.selection().sum(dim=-1)))
            return b

        return counted

    def _c_constrel(self, plan: ConstRel):
        """The one constant row, live on segment 0 only."""
        nseg, dev = self.nseg, self.device

        def run(ctx):
            sel = torch.arange(nseg, device=dev)[:, None] == 0
            return Batch({}, {}, sel)

        return run

    def _c_scan(self, plan: Scan):
        # a partitioned parent is staged as one table: its kept children's
        # rows, segment by segment (exec/executor.py)
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
            return out.scatter(1, torch.where(keep, prow, P), True)[:, :P]

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
                    first = torch.cat([torch.ones_like(present[:, :1]),
                                       prow[:, 1:] != prow[:, :-1]], dim=1)
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
                    and not self.batch_width
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
        C = self._motion_bucket(self._capacity_of(plan.child, ref=True))
        nb = max(int(self.s.motion_pipeline_buckets), 1)
        hash_exprs = plan.hash_exprs
        fid = f"motion_overflow_{len(self.flags)}"
        self.flags.append(fid)
        if plan.range_spec is not None:
            return self._c_motion_range(plan, child_fn, C, nb, fid,
                                        exchanged, arrays)

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

    def _c_motion_range(self, plan: Motion, child_fn, C: int, nb: int,
                        fid: str, exchanged, arrays):
        """Range repartition by sampled splitters (the distributed
        sample-sort routing step): each segment samples S evenly spaced
        values of its locally sorted leading key, the gathered sample
        sorts, and nseg-1 splitters route every row, so equal keys
        co-locate and segments own contiguous ranges. Rows go through the
        same bucketed exchange as a hash Redistribute, with its overflow
        flag: a skewed key retries at the next tier."""
        spec = plan.range_spec
        nseg = self.nseg
        S = max(int(self.s.window_range_sample), 8)

        def run(ctx):
            b = child_fn(ctx)
            sel = b.selection()
            dev = sel.device
            v, valid = Evaluator(b, self.consts).column(spec["expr"])
            enc = sort_ops.encode_key64(v, spec["desc"], spec["kind"])
            if valid is not None:
                # live NULL keys are all peers on the leading key: route
                # them together to the end their placement puts them at
                enc = torch.where(valid, enc, ENC_MIN if spec["nulls_first"]
                                  else ENC_MAX)
            n = sel.shape[1]
            enc_sorted = torch.where(sel, enc, ENC_MAX).sort(dim=1).values
            live = sel.sum(dim=1)
            take = torch.clamp(
                (torch.arange(S, device=dev)[None, :] * live[:, None]) // S,
                0, n - 1)
            samp = torch.where(live[:, None] > 0, enc_sorted.gather(1, take),
                               ENC_MAX)
            g = samp.reshape(-1).sort().values
            # splitter i sits at (i + 1) * (nseg * S) // nseg - 1 of the
            # sorted gathered sample: every S-th entry
            splitters = g[S - 1:(nseg - 1) * S:S].contiguous()
            # count of splitters strictly below enc: equal keys land on
            # the same destination segment, always
            dest = torch.searchsorted(splitters, enc.contiguous())
            recv, precv, overflow = motion_ops.redistribute(
                arrays(b), sel, dest, nseg, C, nbuckets=nb)
            ctx["flags"].append((fid, overflow))
            return exchanged(recv, precv)

        return run

    # ---- windows -------------------------------------------------------
    def _eq_prev(self, ev: Evaluator, exprs, shape, dev):
        """bool [nseg, cap]: row i has the same values of ``exprs`` as row
        i-1 (two NULLs are equal); False at row 0."""
        rest = torch.ones((shape[0], shape[1] - 1), dtype=torch.bool,
                          device=dev)
        for e in exprs:
            v, valid = ev.column(e)
            same = v[:, 1:] == v[:, :-1]
            if valid is not None:
                same = (same & valid[:, 1:] & valid[:, :-1]) | (
                    ~valid[:, 1:] & ~valid[:, :-1])
            rest = rest & same
        return torch.cat([torch.zeros((shape[0], 1), dtype=torch.bool,
                                      device=dev), rest], dim=1)

    @staticmethod
    def _live_pair(sel_sorted):
        """Row i and row i-1 both live: dead rows, which the sort parks at
        the end, always break a partition and a peer group (padded values
        can compare equal to the last live row)."""
        pair = sel_sorted.clone()
        pair[:, 0] = False
        pair[:, 1:] &= sel_sorted[:, :-1]
        return pair

    def _win_args(self, ev: Evaluator, arg):
        """-> (values, valid, decimal scale) of a window argument."""
        if arg is None:
            return None, None, 0
        vals, valid = ev.column(arg)
        scale = arg.type.scale if arg.type.kind is T.Kind.DECIMAL else 0
        return vals, valid, scale

    def _c_window(self, plan: Window):
        if getattr(plan, "global_mode", False):
            return self._c_window_global(plan)
        child_fn = self._compile_node(plan.child)
        cap = self._capacity_of(plan.child)
        pkeys = plan.partition_keys
        okeys = plan.order_keys
        wfuncs = plan.wfuncs

        def run(ctx):
            b = child_fn(ctx)
            # sort by (partition, order); dead rows go to the end
            skeys = self.sort_keys(
                b, [(e, False, None) for e in pkeys] + list(okeys))
            perm, sel_sorted, _ = sort_ops.sort_batch(skeys, b.selection(),
                                                      cap)
            cols, valids = sort_ops.apply_perm(b.cols, b.valids, perm)
            sb = Batch(cols, valids, sel_sorted)
            ev = Evaluator(sb, self.consts)
            shape, dev = sel_sorted.shape, sel_sorted.device
            if pkeys:
                part_eq = self._eq_prev(ev, pkeys, shape, dev)
            else:
                part_eq = torch.ones(shape, dtype=torch.bool, device=dev)
                part_eq[:, 0] = False
            part_eq = part_eq & self._live_pair(sel_sorted)
            peer_eq = part_eq
            if okeys:
                peer_eq = part_eq & self._eq_prev(
                    ev, [e for e, _, _ in okeys], shape, dev)
            funcs = []
            for ci, fname, arg, ordered, param in wfuncs:
                vals, valid, scale = self._win_args(ev, arg)
                funcs.append(win_ops.WinFunc(ci.id, fname, vals, valid,
                                             scale, ordered, param))
            wvals, wvalids = win_ops.compute(part_eq, peer_eq, sel_sorted,
                                             funcs, frame=plan.frame)
            out_c = dict(sb.cols)
            out_v = dict(sb.valids)
            for ci, *_ in wfuncs:
                out_c[ci.id] = wvals[ci.id]
                out_v.pop(ci.id, None)
                if wvalids.get(ci.id) is not None:
                    out_v[ci.id] = wvalids[ci.id]
            return Batch(out_c, out_v, sel_sorted)

        return run

    def _c_window_global(self, plan: Window):
        """Distributed GLOBAL window (no PARTITION BY, no ORDER BY): the
        whole table is one partition, so every function is a reduction
        over every segment, broadcast back — rows never move. row_number()
        is the local live-row prefix count plus the live rows of the
        segments before; sum/count/avg/min/max reduce over dim 1, then
        over dim 0."""
        child_fn = self._compile_node(plan.child)
        cap = self._capacity_of(plan.child)
        wfuncs = plan.wfuncs
        nseg = self.nseg
        if plan.global_mode == "ordered":
            return self._c_window_global_ordered(plan, child_fn, cap)
        if plan.global_mode == "range":
            return self._c_window_global_range(plan, child_fn, cap)

        def run(ctx):
            b = child_fn(ctx)
            sel = b.selection()
            shape = sel.shape
            ev = Evaluator(b, self.consts)
            out_c = dict(b.cols)
            out_v = dict(b.valids)
            for ci, fname, arg, _ordered, _param in wfuncs:
                vals, valid, scale = self._win_args(ev, arg)
                lv = sel if valid is None else (sel & valid)
                if fname in ("first_value", "last_value"):
                    # whole-frame semantics (legal without ORDER BY, PG):
                    # the first/last live ROW of the one global partition
                    # in (segment, row) order — its value even when NULL
                    va = valid if valid is not None else torch.ones_like(sel)
                    s8 = sel.to(torch.uint8)
                    if fname == "first_value":
                        li = s8.argmax(dim=1)
                    else:
                        li = cap - 1 - s8.flip(1).argmax(dim=1)
                    g_has = sel.any(dim=1)
                    g_val = vals.gather(1, li[:, None])[:, 0]
                    g_ok = va.gather(1, li[:, None])[:, 0]
                    h8 = g_has.to(torch.uint8)
                    if fname == "first_value":
                        pick = h8.argmax()
                    else:
                        pick = nseg - 1 - h8.flip(0).argmax()
                    # gathers, not indexing by a 0-dim tensor (which reads
                    # it on the host)
                    pick = pick.reshape(1)
                    out_c[ci.id] = g_val.gather(0, pick).expand(shape)
                    out_v[ci.id] = (g_ok.gather(0, pick)
                                    & g_has.any()).expand(shape)
                    continue
                if fname == "row_number":
                    local = sort_ops.cumsum_rows(sel.to(torch.int64))
                    out_c[ci.id] = local + _before(sel.sum(dim=1))[:, None]
                    out_v.pop(ci.id, None)
                    continue
                c = lv.sum(dim=1).sum()
                if fname == "count":
                    out_c[ci.id] = c.expand(shape)
                    out_v.pop(ci.id, None)
                    continue
                if fname in ("sum", "avg"):
                    acc = torch.float64 if vals.dtype.is_floating_point \
                        else torch.int64
                    s = torch.where(lv, vals.to(acc), torch.zeros(
                        (), dtype=acc, device=sel.device)).sum(dim=1).sum()
                    if fname == "sum":
                        out_c[ci.id] = s.expand(shape)
                    else:
                        a = s.to(torch.float64) / torch.where(
                            c == 0, 1, c).to(torch.float64)
                        if scale:
                            a = a / (10.0 ** scale)
                        out_c[ci.id] = a.expand(shape)
                    out_v[ci.id] = (c > 0).expand(shape)
                    continue
                # min / max (the identity fill of ops/window.py)
                filled = torch.where(lv, vals, torch.full_like(
                    vals, win_ops.minmax_identity(vals.dtype, fname)))
                red = (filled.amin(dim=1).amin() if fname == "min"
                       else filled.amax(dim=1).amax())
                out_c[ci.id] = red.expand(shape)
                out_v[ci.id] = (c > 0).expand(shape)
            return Batch(out_c, out_v, sel)

        return run

    def _ordered_encoding(self, spec, ev: Evaluator, sel):
        """-> (enc, isnull_cls, nulls_first, dead): each row's ORDER BY
        keys as the signed image of one order-preserving uint64
        (planner._ordered_global_spec).

        packed — every key maps to (null_bit, value - lo) fields using
          exact zone-map bounds; DESC complements within the field, NULLS
          FIRST/LAST picks the null bit polarity. NULLs are ordinary key
          values here.
        full64 — one key, no bounds: sign-flip encoding over the full
          64-bit domain; NULL keys form a separate runtime class (all
          NULLs tie, placed per nulls_first)."""
        if spec["mode"] != "packed":
            v, valid = ev.column(spec["expr"])
            enc = sort_ops.encode_key64(v, spec["desc"],
                                        spec.get("kind", "int"))
            isnull = (sel & ~valid) if valid is not None \
                else torch.zeros_like(sel)
            return enc, isnull, spec["nulls_first"], ~sel | isnull
        shift = 64
        enc = torch.zeros(sel.shape, dtype=torch.int64, device=sel.device)
        for f in spec["fields"]:
            v, valid = ev.column(f["expr"])
            v64 = v.to(torch.int64)
            ve = (int(f["hi"]) - v64) if f["desc"] else (v64 - int(f["lo"]))
            # the clamp defends against out-of-zone filler values at dead
            # rows; live values are inside by soundness
            ve = torch.clamp(ve, 0, (1 << f["bits"]) - 1)
            # the null flag: 1 marks the later of NULL / non-NULL
            nn_bit, nl_bit = (1, 0) if f["nulls_first"] else (0, 1)
            if valid is None:
                fe = ve | (nn_bit << f["bits"])
            else:
                fe = torch.where(valid, ve | (nn_bit << f["bits"]),
                                 nl_bit << f["bits"])
            shift -= f["bits"] + 1
            enc = enc | (fe << shift)
        return (enc ^ sort_ops.BIT63, torch.zeros_like(sel), False, ~sel)

    def _c_window_global_ordered(self, plan: Window, child_fn, cap: int):
        """Distributed GLOBAL ranking family (row_number/rank/dense_rank/
        ntile/lag/lead/first_value/last_value) over bounded or single
        ORDER BY keys: each row's GLOBAL position and the global row count
        are computed in place — per segment, encode the keys
        order-preservingly into one word and sort them locally; per row,
        one searchsorted against every segment's sorted run (the
        ``[nseg, cap]`` tensor the JAX package all-gathers) counts the
        keys below and equal. ntile is then arithmetic on (position,
        count); lag/lead/first/last resolve position +- offset via a
        lookup into the globally sorted runs. row_number() breaks ties by
        (segment, local sorted position); dense_rank counts distinct keys
        via one sort of the flattened runs and a boundary cumsum."""
        wfuncs = plan.wfuncs
        nseg = self.nseg
        spec = plan.gkey_spec
        need_dense = any(f[1] == "dense_rank" for f in wfuncs)
        need_values = any(f[1] in VALUE_FUNCS for f in wfuncs)
        full64 = spec["mode"] != "packed"

        def run(ctx):
            b = child_fn(ctx)
            sel = b.selection()
            dev = sel.device
            ev = Evaluator(b, self.consts)
            enc, isnull_cls, nulls_first, dead = self._ordered_encoding(
                spec, ev, sel)
            # dead rows park at the top of the sorted run (the dead flag is
            # the leading sort key) and their counted contributions are
            # clamped away by the live counts below
            enc_d = torch.where(dead, ENC_MAX, enc)
            rid = torch.arange(cap, device=dev).expand(nseg, cap)
            sorted_rid = sort_ops._lexsort([dead.to(torch.uint8), enc_d], cap)
            sorted_enc = enc_d.gather(1, sorted_rid)
            live_n = (~dead).sum(dim=1)                       # [nseg]
            # every row against every segment's sorted run:
            # [runs, nseg * cap] -> [runs, nseg, cap]
            queries = enc_d.reshape(1, -1).expand(nseg, -1).contiguous()
            lim = live_n[:, None, None]
            left = torch.minimum(torch.searchsorted(
                sorted_enc, queries).reshape(nseg, nseg, cap), lim)
            right = torch.minimum(torch.searchsorted(
                sorted_enc, queries, right=True).reshape(nseg, nseg, cap),
                lim)
            eq = right - left
            less_g = left.sum(dim=0)
            seg = torch.arange(nseg, device=dev)
            prior = (seg[:, None] < seg[None, :])[:, :, None]   # [run, seg]
            eq_prior = torch.where(prior, eq, 0).sum(dim=0)
            del left, right
            # local tie position (stable by original row order)
            pos = torch.empty_like(sorted_rid).scatter(1, sorted_rid, rid)
            first_eq = torch.minimum(
                torch.searchsorted(sorted_enc, enc_d), live_n[:, None])
            local_eq_before = pos - first_eq

            # the NULL class (full64 only): all NULL-key rows tie, placed
            # before or after every valued row per nulls_first
            g_null = isnull_cls.sum(dim=1)                    # [nseg]
            n_null_total = g_null.sum()
            total_valued = live_n.sum()
            local_null_idx = sort_ops.cumsum_rows(
                isnull_cls.to(torch.int64)) - 1
            zero = torch.zeros((), dtype=torch.int64, device=dev)
            valued_base = n_null_total if nulls_first else zero
            null_base = zero if nulls_first else total_valued

            # global 0-based position of every row and the GLOBAL row count
            rn0 = torch.where(
                isnull_cls,
                null_base + _before(g_null)[:, None] + local_null_idx,
                valued_base + less_g + eq_prior + local_eq_before)
            n_total = total_valued + n_null_total

            flat = flive = fperm = None
            if need_dense or need_values:
                # the runs flattened segment-major, sorted by (enc,
                # live-first): live entries occupy [0, total_valued) in
                # rank order. Dead entries carry the max word, so a LIVE
                # max-value row sorts before them (the secondary key)
                flat = sorted_enc.reshape(1, -1)
                flive = (torch.arange(cap, device=dev)[None, :]
                         < live_n[:, None]).reshape(1, -1)
                fperm = sort_ops._lexsort(
                    [flat, (~flive).to(torch.uint8)], nseg * cap)[0]

            dense_b = total_distinct = None
            if need_dense:
                s_enc = flat[0, fperm]
                s_live = flive[0, fperm]
                first = torch.ones_like(s_live)
                first[1:] = s_enc[1:] != s_enc[:-1]
                d = (s_live & first).to(torch.int64)
                cum_excl = d.cumsum(0) - d
                at = torch.searchsorted(s_enc, enc_d.reshape(-1))
                dense_b = cum_excl[torch.clamp(at, 0, nseg * cap - 1)] \
                    .reshape(nseg, cap)
                total_distinct = d.sum()

            cum_null = g_null.cumsum(0)

            def make_lookup(arg):
                """-> lookup(p): the window argument's (value, valid) at
                GLOBAL position p. Valued positions read the globally
                sorted value run; full64 NULL-class positions read a
                (segment, row)-ordered run of the null-key rows."""
                vals, valid = ev.column(arg)
                va = valid if valid is not None else torch.ones_like(sel)
                s_vals = vals.gather(1, sorted_rid).reshape(-1)[fperm]
                s_valid = va.gather(1, sorted_rid).reshape(-1)[fperm]
                g_nv = g_nvv = None
                if full64:
                    # null-key rows compacted to the front of each
                    # segment; every other row stores to the spare slot
                    npos = torch.where(isnull_cls, local_null_idx, cap)
                    g_nv = torch.zeros((nseg, cap + 1), dtype=vals.dtype,
                                       device=dev).scatter(
                        1, npos, vals)[:, :cap].reshape(-1)
                    g_nvv = torch.zeros((nseg, cap + 1), dtype=torch.bool,
                                        device=dev).scatter(
                        1, npos, va)[:, :cap].reshape(-1)

                def lookup(p):
                    q = torch.clamp(p - n_null_total if nulls_first else p,
                                    0, nseg * cap - 1)
                    val, ok = s_vals[q], s_valid[q]
                    if g_nv is not None:
                        in_null = (p < n_null_total) if nulls_first \
                            else (p >= total_valued)
                        j = p if nulls_first else p - total_valued
                        sg = torch.clamp(torch.searchsorted(
                            cum_null, j, right=True), 0, nseg - 1)
                        loc = torch.clamp(j - (cum_null[sg] - g_null[sg]),
                                          0, cap - 1)
                        val = torch.where(in_null, g_nv[sg * cap + loc], val)
                        ok = torch.where(in_null, g_nvv[sg * cap + loc], ok)
                    return val, ok

                return lookup

            out_c = dict(b.cols)
            out_v = dict(b.valids)
            for ci, fname, arg, _ordered, param in wfuncs:
                out_v.pop(ci.id, None)
                if fname == "row_number":
                    out_c[ci.id] = rn0 + 1
                elif fname == "rank":
                    out_c[ci.id] = torch.where(
                        isnull_cls, null_base, valued_base + less_g) + 1
                elif fname == "dense_rank":
                    valued = dense_b + ((n_null_total > 0) & nulls_first)
                    nullv = zero if nulls_first else total_distinct
                    out_c[ci.id] = torch.where(isnull_cls, nullv, valued) + 1
                elif fname == "ntile":
                    out_c[ci.id] = win_ops.ntile_bucket(rn0, n_total, param)
                elif fname in ("lag", "lead"):
                    out_c[ci.id], out_v[ci.id] = _lag_lead_lookup(
                        fname, param, rn0, n_total, make_lookup(arg), sel)
                else:
                    # first_value / last_value, default frame (RANGE
                    # UNBOUNDED PRECEDING..CURRENT ROW): the frame starts
                    # at the global partition start and ends at the row's
                    # last PEER
                    if fname == "first_value":
                        p = torch.zeros((nseg, cap), dtype=torch.int64,
                                        device=dev)
                    else:
                        p = torch.where(isnull_cls,
                                        null_base + n_null_total - 1,
                                        valued_base + less_g + eq.sum(dim=0)
                                        - 1)
                    val, vv = make_lookup(arg)(p)
                    out_c[ci.id] = val
                    out_v[ci.id] = vv & sel
            return Batch(out_c, out_v, sel)

        return run

    def _c_window_global_range(self, plan: Window, child_fn, cap: int):
        """Global window over RANGE-repartitioned rows (the child is the
        sampled-splitter Redistribute, _c_motion_range): each segment owns
        a contiguous range of the leading ORDER BY key with equal keys
        co-located, so after a segment-local sort by the full key list
        the global order is the concatenation of the per-segment runs —
        peer groups never straddle a boundary. The rank family and
        dense_rank stitch with the live and distinct counts of the
        segments before, ntile is arithmetic on (global position, global
        count), running sum/count/avg/min/max add the segments before's
        totals, and lag/lead/first_value resolve cross-segment positions
        via a lookup into the runs."""
        wfuncs = plan.wfuncs
        nseg = self.nseg
        okeys = plan.order_keys

        def run(ctx):
            b = child_fn(ctx)
            perm, sel_sorted, _ = sort_ops.sort_batch(
                self.sort_keys(b, okeys), b.selection(), cap)
            cols, valids = sort_ops.apply_perm(b.cols, b.valids, perm)
            sb = Batch(cols, valids, sel_sorted)
            ev = Evaluator(sb, self.consts)
            shape, dev = sel_sorted.shape, sel_sorted.device
            idx = torch.arange(cap, device=dev).expand(shape)
            # peer boundaries among LIVE rows
            eq = self._eq_prev(ev, [e for e, _, _ in okeys], shape, dev) \
                & self._live_pair(sel_sorted)
            peer_bound = ~eq
            peer_start, peer_end = win_ops._spans(peer_bound)
            peer_end = torch.clamp(peer_end, 0, cap - 1)

            g_n = sel_sorted.sum(dim=1)                       # [nseg]
            prior = _before(g_n)[:, None]
            n_total = g_n.sum()
            cum_n = g_n.cumsum(0)
            # live rows occupy the local prefix, so the local index is the
            # local rank and the global 0-based position one offset away
            rn0 = idx + prior

            def make_lookup(vals, va):
                flat_v, flat_ok = vals.reshape(-1), va.reshape(-1)

                def lookup(p):
                    sg = torch.clamp(torch.searchsorted(cum_n, p, right=True),
                                     0, nseg - 1)
                    loc = torch.clamp(p - (cum_n[sg] - g_n[sg]), 0, cap - 1)
                    return flat_v[sg * cap + loc], flat_ok[sg * cap + loc]

                return lookup

            out_c = dict(sb.cols)
            out_v = dict(sb.valids)
            db_loc = sort_ops.cumsum_rows((peer_bound & sel_sorted)
                                          .to(torch.int64))
            for ci, fname, arg, _ordered, param in wfuncs:
                vals, valid, scale = self._win_args(ev, arg)
                out_v.pop(ci.id, None)
                va = valid if valid is not None \
                    else torch.ones_like(sel_sorted)
                if fname == "row_number":
                    out_c[ci.id] = rn0 + 1
                    continue
                if fname == "rank":
                    out_c[ci.id] = peer_start + prior + 1
                    continue
                if fname == "dense_rank":
                    out_c[ci.id] = db_loc + _before(db_loc[:, -1])[:, None]
                    continue
                if fname == "ntile":
                    out_c[ci.id] = win_ops.ntile_bucket(rn0, n_total, param)
                    continue
                if fname in ("lag", "lead"):
                    out_c[ci.id], out_v[ci.id] = _lag_lead_lookup(
                        fname, param, rn0, n_total, make_lookup(vals, va),
                        sel_sorted)
                    continue
                if fname in ("first_value", "last_value"):
                    if fname == "first_value":
                        # the global partition start lives on the first
                        # non-empty segment
                        val, vv = make_lookup(vals, va)(torch.zeros_like(rn0))
                    else:
                        # the last PEER is local: peers are whole per
                        # segment
                        val, vv = vals.gather(1, peer_end), \
                            va.gather(1, peer_end)
                    out_c[ci.id] = val
                    out_v[ci.id] = vv & sel_sorted
                    continue
                # running aggregates to the last peer (default RANGE
                # UNBOUNDED PRECEDING..CURRENT ROW): the local prefix value
                # plus the totals of the segments before
                lv = sel_sorted & va
                cnt = sort_ops.cumsum_rows(lv.to(torch.int64))
                c = cnt.gather(1, peer_end) + _before(lv.sum(dim=1))[:, None]
                if fname in ("sum", "count", "avg"):
                    if fname == "count" and vals is None:
                        vals = torch.ones(shape, dtype=torch.int64,
                                          device=dev)
                    acc = torch.float64 if vals.dtype.is_floating_point \
                        else torch.int64
                    contrib = torch.where(lv, vals.to(acc), torch.zeros(
                        (), dtype=acc, device=dev))
                    s = win_ops.prefix_sum(contrib).gather(1, peer_end) \
                        + _before(contrib.sum(dim=1))[:, None]
                    if fname == "count":
                        out_c[ci.id] = c
                    elif fname == "sum":
                        out_c[ci.id] = s
                        out_v[ci.id] = c > 0
                    else:
                        a = s.to(torch.float64) / torch.where(
                            c == 0, 1, c).to(torch.float64)
                        if scale:
                            a = a / (10.0 ** scale)
                        out_c[ci.id] = a
                        out_v[ci.id] = c > 0
                    continue
                # min / max (the identity fill of ops/window.py)
                ident = win_ops.minmax_identity(vals.dtype, fname)
                filled = torch.where(lv, vals, torch.full_like(vals, ident))
                run_ = sort_ops.prefix_minmax_rows(filled, fname, ident)
                if fname == "min":
                    tot, op = filled.amin(dim=1), torch.minimum
                    before = tot.cummin(0).values
                else:
                    tot, op = filled.amax(dim=1), torch.maximum
                    before = tot.cummax(0).values
                before = torch.cat([torch.full_like(before[:1], ident),
                                    before[:-1]])
                out_c[ci.id] = op(run_.gather(1, peer_end), before[:, None])
                out_v[ci.id] = c > 0
            return Batch(out_c, out_v, sel_sorted)

        return run

    # ---- union ---------------------------------------------------------
    def _c_union(self, plan: Union):
        """The branches side by side along the row axis (capacity = the
        sum of theirs); a replicated branch keeps segment 0's copy."""
        fns = [self._compile_node(c) for c in plan.inputs]
        branch_ids = plan.branch_ids
        replicated = [c.locus is not None and c.locus.kind in (
            LocusKind.SEGMENT_GENERAL, LocusKind.GENERAL)
            for c in plan.inputs]
        nseg = self.nseg

        def run(ctx):
            parts_c = {uc.id: [] for uc in plan.cols}
            parts_v = {uc.id: [] for uc in plan.cols}
            parts_sel = []
            for fn, ids, rep in zip(fns, branch_ids, replicated):
                b = fn(ctx)
                sel = b.selection()
                if rep:
                    sel = sel & (torch.arange(nseg, device=sel.device)
                                 [:, None] == 0)
                parts_sel.append(sel)
                for uc, bid in zip(plan.cols, ids):
                    parts_c[uc.id].append(b.cols[bid].expand(sel.shape))
                    v = b.valids.get(bid)
                    parts_v[uc.id].append(v.expand(sel.shape) if v is not None
                                          else torch.ones_like(sel))
            cols = {k: torch.cat(v, dim=1) for k, v in parts_c.items()}
            valids = {k: torch.cat(v, dim=1) for k, v in parts_v.items()}
            return Batch(cols, valids, torch.cat(parts_sel, dim=1))

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
    return f"{type(plan).__name__}: not lowered by this compiler"


def _collect_dict_refs(plan: Plan, out: dict):
    for c in plan.out_cols():
        if c.dict_ref is not None:
            out[c.id] = c.dict_ref
    for ch in plan.children:
        _collect_dict_refs(ch, out)
