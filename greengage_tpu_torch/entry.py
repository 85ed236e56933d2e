"""Entry points of the port — the counterpart of the repository's
``__graft_entry__.py``, plus TPC-H Q1 run as its physical plan.

entry()            -> (fn, example_args): the single-segment Q1 step
                      (filter -> dense group-by -> 7 aggregates) over a
                      columnar lineitem batch on the device.
dryrun_step(nseg)  -> the distributed step over ``nseg`` segments: partial
                      dense agg -> Redistribute Motion -> final merge, with
                      the exact-sum check of ``dryrun_multichip``.
load_lineitem()    -> the generator's lineitem columns staged on the device
                      in segment layout, placed as the storage layer places
                      them (hash of l_orderkey % nseg, load order kept).
q1_plan(nseg)      -> TPC-H Q1's planned tree, node for node as the JAX
                      planner builds it (tests/test_plan_goldens.py).
run_q1(data)       -> Q1's result rows, in ``Result.rows()`` form.

Every entry point runs on the GPU unless the caller passes a device.
"""

from __future__ import annotations

import numpy as np
import torch

from greengage_tpu_torch import expr as E
from greengage_tpu_torch import resolve_device
from greengage_tpu_torch import types as T
from greengage_tpu_torch.config import Settings
from greengage_tpu_torch.exec import executor
from greengage_tpu_torch.exec.compile import Compiler, TableData
from greengage_tpu_torch.ops import agg as agg_ops
from greengage_tpu_torch.ops import hashing
from greengage_tpu_torch.parallel import motion
from greengage_tpu_torch.parallel.mesh import make_layout
from greengage_tpu_torch.planner.locus import Locus
from greengage_tpu_torch.planner.logical import (
    Aggregate, ColInfo, Filter, Motion, MotionKind, Project, Scan, Sort,
)
from greengage_tpu_torch.types import Coded
from greengage_tpu_torch.utils import tpch

# l_shipdate <= date '1998-12-01' - interval '90' day, as days since 1970
Q1_CUTOFF = T.date_to_days("1998-09-02")


# ---------------------------------------------------------------------------
# the single-segment step and the distributed dry run
# ---------------------------------------------------------------------------

def _q1_args(n, seed=0) -> dict:
    """The same rng draws as ``__graft_entry__._q1_args``, as numpy."""
    rng = np.random.default_rng(seed)
    return dict(
        returnflag=rng.integers(0, 3, n).astype(np.int32),
        linestatus=rng.integers(0, 2, n).astype(np.int32),
        quantity=rng.integers(100, 5000, n).astype(np.int64),
        extendedprice=rng.integers(90000, 10**7, n).astype(np.int64),
        discount=rng.integers(0, 11, n).astype(np.int64),
        tax=rng.integers(0, 9, n).astype(np.int64),
        shipdate=rng.integers(8035, 10470, n).astype(np.int32),
    )


_ARG_ORDER = ("returnflag", "linestatus", "quantity", "extendedprice",
              "discount", "tax", "shipdate")


def _q1_step(returnflag, linestatus, quantity, extendedprice, discount, tax,
             shipdate):
    sel = shipdate <= 10471 - 90
    keys = [agg_ops.KeySpec(returnflag, None, None),
            agg_ops.KeySpec(linestatus, None, None)]
    gid, D = agg_ops.dense_gid(keys, [4, 3], sel)
    disc_price = extendedprice * (100 - discount)
    charge = disc_price * (100 + tax)
    vals, _ = agg_ops.dense_aggregate(
        gid, D,
        [
            agg_ops.AggSpec("sum_qty", "sum", quantity, None),
            agg_ops.AggSpec("sum_base", "sum", extendedprice, None),
            agg_ops.AggSpec("sum_disc", "sum", disc_price, None),
            agg_ops.AggSpec("sum_charge", "sum", charge, None),
            agg_ops.AggSpec("avg_qty", "avg", quantity, None, 2),
            agg_ops.AggSpec("avg_disc", "avg", discount, None, 2),
            agg_ops.AggSpec("cnt", "count_star", None, None),
        ],
        sel,
    )
    return vals


def entry(device=None):
    """-> (fn, example_args tuple): the Q1 step on one segment, its
    arguments ``[1, 8192]`` tensors on the device."""
    dev = resolve_device(device)
    args = _q1_args(8192)
    return _q1_step, tuple(torch.from_numpy(args[k]).to(dev).reshape(1, -1)
                           for k in _ARG_ORDER)


def dryrun_step(nseg: int, device=None, per_seg: int = 128) -> int:
    """The distributed query step over ``nseg`` segments on one device:
    per-segment filter -> partial dense agg -> Redistribute Motion by
    group-key hash -> final merge, checked exactly against a host
    reference. -> rows aggregated."""
    dev = resolve_device(device)
    D = 12  # dense domain of the 2 group keys
    args = _q1_args(nseg * per_seg, seed=7)
    rf, ls, qty, price, disc, tax, ship = (
        torch.from_numpy(args[k]).to(dev).reshape(nseg, per_seg)
        for k in _ARG_ORDER)
    sel = ship <= 10471 - 90
    keys = [agg_ops.KeySpec(rf, None, None), agg_ops.KeySpec(ls, None, None)]
    gid, _ = agg_ops.dense_gid(keys, [4, 3], sel)
    disc_price = price * (100 - disc)
    # phase 1: per-segment partial aggregation
    pvals, _ = agg_ops.dense_aggregate(
        gid, D, [agg_ops.AggSpec("s", "sum", disc_price, None),
                 agg_ops.AggSpec("c", "count_star", None, None)], sel)
    decoded = agg_ops.dense_decode_keys(keys, [4, 3], D)
    k_rf = decoded[0][0].expand(nseg, D)
    k_ls = decoded[1][0].expand(nseg, D)
    used = pvals["c"] > 0
    # Redistribute Motion: partial groups -> owner segment by key hash
    h = hashing.row_hash([hashing.hash_i64(k_rf), hashing.hash_i64(k_ls)])
    dest = hashing.segment_of(h, nseg)
    recv, precv, overflow = motion.redistribute(
        {"rf": k_rf, "ls": k_ls, "s": pvals["s"], "c": pvals["c"]},
        used, dest, nseg, D)
    # phase 2: final merge on the owner segment
    keys2 = [agg_ops.KeySpec(recv["rf"], None, None),
             agg_ops.KeySpec(recv["ls"], None, None)]
    gid2, _ = agg_ops.dense_gid(keys2, [4, 3], precv)
    fvals, _ = agg_ops.dense_aggregate(
        gid2, D, [agg_ops.AggSpec("s", "sum", recv["s"], None),
                  agg_ops.AggSpec("c", "sum", recv["c"], None)], precv)
    if bool(overflow):
        raise AssertionError("motion overflow in dryrun")
    # correctness: global sums match a host-side reference
    hsel = args["shipdate"] <= 10471 - 90
    dp = args["extendedprice"] * (100 - args["discount"])
    got_total = int(fvals["s"].sum())
    want_total = int(dp[hsel].sum())
    if got_total != want_total:
        raise AssertionError((got_total, want_total))
    got_rows = int(fvals["c"].sum())
    if got_rows != int(hsel.sum()):
        raise AssertionError((got_rows, int(hsel.sum())))
    return got_rows


# ---------------------------------------------------------------------------
# TPC-H Q1 through its physical plan
# ---------------------------------------------------------------------------

def load_lineitem(cols: dict, nseg: int = 8, device=None) -> TableData:
    """Stage the generator's lineitem columns (numpy arrays and ``Coded``
    TEXT columns) on the device as ``[nseg, cap]`` segments.

    Rows are placed as the storage layer places a table distributed by
    l_orderkey: segment = hash(l_orderkey) % nseg, load order kept within a
    segment; ``cap`` is the largest segment's row count and ``present``
    marks the live slots. Columns are copied from pinned host memory with
    ``non_blocking=True``; TEXT columns keep their vocabulary as the
    dictionary (code -> string), as the storage layer encodes a fresh
    table."""
    dev = resolve_device(device)
    host, dicts = {}, {}
    for name, t in tpch.LINEITEM_TYPES.items():
        v = cols[name]
        if isinstance(v, Coded):
            dicts[name] = list(v.vocab)
            v = v.codes
        host[name] = np.ascontiguousarray(v, dtype=t.np_dtype)

    def stage(arr):
        t = torch.from_numpy(arr)
        if dev.type == "cuda":
            t = t.pin_memory()
        return t.to(dev, non_blocking=True)

    key = stage(host[tpch.LINEITEM_DISTKEY])
    n = key.shape[0]
    seg = hashing.segment_of(hashing.hash_i64(key), nseg).to(torch.int64)
    counts = torch.bincount(seg, minlength=nseg)
    cap = max(int(counts.max()) if n else 0, 1)
    order = torch.argsort(seg, stable=True)
    sseg = seg[order]
    start = torch.cumsum(counts, 0) - counts
    pos = sseg * cap + torch.arange(n, device=dev) - start[sseg]
    del seg, sseg, start

    def place(col, dtype):
        out = torch.zeros(nseg * cap, dtype=dtype, device=dev)
        out[pos] = col[order]
        return out.reshape(nseg, cap)

    staged = {}
    for name, arr in host.items():
        col = key if name == tpch.LINEITEM_DISTKEY else stage(arr)
        staged[name] = place(col, col.dtype)
    present = place(torch.ones(n, dtype=torch.bool, device=dev), torch.bool)
    return TableData("lineitem", staged, present, dicts)


def q1_plan(nseg: int = 8, cutoff: int = Q1_CUTOFF) -> Motion:
    """TPC-H Q1's planned tree with the binder's column types:

      Motion Gather  [Entry]
        Sort  [Hashed(l_returnflag, l_linestatus)]
          Project
            Aggregate final keys=(l_returnflag, l_linestatus)
              Motion Redistribute by (g, g)
                Aggregate partial keys=(l_returnflag, l_linestatus)  [Strewn]
                  Project
                    Filter (l_shipdate <= cutoff)
                      Scan lineitem
    """
    dec2, dec4, dec6 = T.decimal(2), T.decimal(4), T.decimal(6)
    strewn = Locus.strewn(nseg)

    def col(cid, t, name, dict_col=None):
        return ColInfo(cid, t, name,
                       ("lineitem", dict_col) if dict_col else None)

    scan_cols = [
        col("l_quantity#4", dec2, "l_quantity"),
        col("l_extendedprice#5", dec2, "l_extendedprice"),
        col("l_discount#6", dec2, "l_discount"),
        col("l_tax#7", dec2, "l_tax"),
        col("l_returnflag#8", T.TEXT, "l_returnflag", "l_returnflag"),
        col("l_linestatus#9", T.TEXT, "l_linestatus", "l_linestatus"),
        col("l_shipdate#10", T.DATE, "l_shipdate"),
    ]
    ref = {c.name: E.ColRef(c.id, c.type) for c in scan_cols}
    scan = Scan("lineitem", scan_cols)
    filt = Filter(scan, E.Cmp("<=", ref["l_shipdate"],
                              E.Literal(cutoff, T.DATE)))
    one = E.Literal(1, T.INT32)
    disc_price = E.BinOp(
        "*", ref["l_extendedprice"],
        E.BinOp("-", one, ref["l_discount"], dec2), dec4)
    charge = E.BinOp("*", disc_price,
                     E.BinOp("+", one, ref["l_tax"], dec2), dec6)
    g_rf = col("g#16", T.TEXT, "l_returnflag", "l_returnflag")
    g_ls = col("g#17", T.TEXT, "l_linestatus", "l_linestatus")
    args = [("a_in#18", dec2, ref["l_quantity"]),
            ("a_in#20", dec2, ref["l_extendedprice"]),
            ("a_in#22", dec4, disc_price),
            ("a_in#24", dec6, charge),
            ("a_in#26", dec2, ref["l_quantity"]),
            ("a_in#28", dec2, ref["l_extendedprice"]),
            ("a_in#30", dec2, ref["l_discount"])]
    proj = Project(filt, [(g_rf, ref["l_returnflag"]),
                          (g_ls, ref["l_linestatus"])]
                   + [(col(cid, t, "arg"), e) for cid, t, e in args])
    arg = {cid: E.ColRef(cid, t) for cid, t, _ in args}
    aggs = []
    for i, (func, cid) in enumerate(
            [("sum", "a_in#18"), ("sum", "a_in#20"), ("sum", "a_in#22"),
             ("sum", "a_in#24"), ("avg", "a_in#26"), ("avg", "a_in#28"),
             ("avg", "a_in#30")]):
        a = arg[cid]
        rt = E.agg_result_type(func, a.type)
        aggs.append((col(f"{func}#{19 + 2 * i}", rt, func),
                     E.Agg(func, a, False, rt)))
    aggs.append((col("count_star#32", T.INT64, "count_star"),
                 E.Agg("count_star", None, False, T.INT64)))
    gkeys = [(g_rf, E.ColRef(g_rf.id, T.TEXT)),
             (g_ls, E.ColRef(g_ls.id, T.TEXT))]
    partial = Aggregate(proj, gkeys, aggs, phase="partial")
    redist = Motion(MotionKind.REDISTRIBUTE, partial,
                    hash_exprs=[e for _, e in gkeys])
    final = Aggregate(redist, gkeys, aggs, phase="final")
    names = ["sum_qty", "sum_base_price", "sum_disc_price", "sum_charge",
             "avg_qty", "avg_price", "avg_disc", "count_order"]
    o_rf = col("l_returnflag#33", T.TEXT, "l_returnflag", "l_returnflag")
    o_ls = col("l_linestatus#34", T.TEXT, "l_linestatus", "l_linestatus")
    outs = [(o_rf, gkeys[0][1]), (o_ls, gkeys[1][1])] + [
        (col(f"{name}#{35 + i}", ci.type, name), E.ColRef(ci.id, ci.type))
        for i, (name, (ci, _)) in enumerate(zip(names, aggs))]
    top = Project(final, outs)
    order = [(E.ColRef(o_rf.id, T.TEXT), False, None),
             (E.ColRef(o_ls.id, T.TEXT), False, None)]
    sort = Sort(top, order)
    gather = Motion(MotionKind.GATHER, sort, merge_keys=order)
    for node in (scan, filt, proj, partial):
        node.locus = strewn
    for node in (redist, final):
        node.locus = Locus.hashed((g_rf.id, g_ls.id), nseg)
    for node in (top, sort):
        node.locus = Locus.hashed((o_rf.id, o_ls.id), nseg)
    gather.locus = Locus.entry()
    return gather


def q1_result(table: TableData, settings: Settings | None = None):
    """Compile Q1's plan over a staged lineitem and run it ->
    executor.Result (presentation columns plus the storage-representation
    ``raw`` values, flags and metrics)."""
    nseg = int(table.present.shape[0])
    layout = make_layout(nseg, table.present.device)
    compiler = Compiler(layout, {"lineitem": table}, settings)
    comp = compiler.compile(q1_plan(nseg))
    return executor.execute(comp, {"lineitem": table}, compiler)


def run_q1(data, nseg: int = 8, device=None,
           settings: Settings | None = None) -> list[tuple]:
    """TPC-H Q1 -> result rows with TEXT decoded (``Result.rows()`` form).
    ``data`` is the generator's output (or its lineitem dict), staged here
    over ``nseg`` segments, or a lineitem already staged by
    ``load_lineitem`` (whose segments and device it keeps)."""
    if not isinstance(data, TableData):
        data = load_lineitem(data.get("lineitem", data), nseg,
                             resolve_device(device))
    return q1_result(data, settings).rows()
