"""Windows, UNION, grouping sets and constant relations in the port against
the JAX package on the same inputs.

(a) ``ops/window.compute``, its group spans and segmented min/max scan
    against ``greengage_tpu.ops.window`` per segment, on seeded numpy
    inputs with dead rows at the end of every segment.
(b) Rows of ``db.sql`` equal to the JAX package's at 1 and 8 segments
    (each width against a JAX database of the same width, since a
    tie-break by segment or a first row in storage order depends on it):
    every window and union entry of the TPC-H plan corpus, the TPC-DS
    corpus's window and ROLLUP entries, TPC-DS Q12, Q98 and Q89 as
    tests/test_tpcds_full.py writes them, and the statements of
    tests/test_window.py, test_window_global.py, test_winagg.py,
    test_groupingsets.py, test_orderedset.py and test_constrel.py,
    replayed on their data loaded into both packages.
(c) A skewed leading key overflows the range repartition at tier 0: both
    packages retry and agree on rows and ``tiers_used``. The windows
    phase's statements that retry at SF10 (win_local, the distinct UNION)
    against the JAX package's ``tiers_used`` at CPU sizes that overflow.
(d) Plans and binder constants of the TPC-DS corpus equal the JAX
    package's.
(e) On the card, the window, ROLLUP and UNION statements equal the CPU's.

Left out of (b), each for the ROADMAP item it waits for: the raw-TEXT
statements of test_window_global.py (``test_ntile_raw_text_plan_golden``,
``test_ntile_lag_raw_text_oracle``, ``test_raw_text_partition_key``: raw
TEXT, Queue 1 item 1e), the EXPLAIN ANALYZE statements
(``test_explain_analyze_per_node_rows``,
``test_explain_analyze_ordered_global``,
``test_explain_analyze_range_mode``: item 1c) and
``test_recursive_cte_constant_base`` (recursion over worktables, which
waits for DML: item 1b). The fixtures' INSERTs and test_orderedset.py's
``update ... set x = null`` become bulk loads of the same values.

Tolerances: integer and DECIMAL results are exact. A float64 result may
differ from the JAX package's by 64 ulps of the larger magnitude (at least
1.0): window sums and avgs are differences of running sums, whose rounding
is bounded by the partition's prefix magnitude, not by the result's; the
JAX side also divides by a reciprocal where the port divides truly. In
(a) a float sum is held to 16 ulps of its segment's sum of absolute
values; the float64 running sums of ``WIN_RUNNING`` to 64 ulps of the
table's sum of absolute values (their prefixes reach far past their
results).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import greengage_tpu
import greengage_tpu_torch
from greengage_tpu.analysis.plancorpus import TPCDS_QUERIES, TPCH_QUERIES
from greengage_tpu.ops import window as jwin
from greengage_tpu.planner.logical import describe as jdescribe
from greengage_tpu.sql.parser import parse as jparse
from greengage_tpu.types import Coded as JCoded
from greengage_tpu.utils import tpcds as jtpcds
from greengage_tpu.utils import tpch as jtpch
from greengage_tpu_torch.ops import fused_agg
from greengage_tpu_torch.ops import window as twin
from greengage_tpu_torch.planner.logical import Motion, MotionKind, Window
from greengage_tpu_torch.planner.logical import describe as tdescribe
from greengage_tpu_torch.sql.parser import SqlError
from greengage_tpu_torch.sql.parser import parse as tparse
from greengage_tpu_torch.types import Coded as TCoded
from greengage_tpu_torch.utils import tpcds as ttpcds
from greengage_tpu_torch.utils import tpch as ttpch

SF = 0.002
DS_SCALE = 0.1
WIDTHS = (1, 8)
EPS = np.finfo(np.float64).eps


# ---- (a) ops/window.compute -------------------------------------------------

def _window_inputs(rng, S, n, p_part, p_peer):
    """Sorted-batch inputs per segment: a live prefix (at least one row
    when n > 0), random partition and peer boundaries among live rows,
    dead rows at the end (both eq arrays False there)."""
    live = rng.integers(max(n // 2, 1), n + 1, S)
    live[0] = n
    sel = np.arange(n)[None, :] < live[:, None]
    part_eq = rng.random((S, n)) >= p_part
    peer_eq = part_eq & (rng.random((S, n)) >= p_peer)
    part_eq[:, 0] = peer_eq[:, 0] = False
    part_eq &= sel
    peer_eq &= sel
    return sel, part_eq, peer_eq


def _values(rng, S, n, kind):
    """-> (values, valid, decimal scale) of one argument kind."""
    if kind == "int64":
        return (rng.integers(-10 ** 6, 10 ** 6, (S, n)),
                rng.random((S, n)) < 0.85, 0)
    if kind == "int32":
        return rng.integers(-1000, 1000, (S, n)).astype(np.int32), None, 0
    if kind == "decimal":
        return (rng.integers(-10 ** 9, 10 ** 9, (S, n)),
                rng.random((S, n)) < 0.9, 2)
    v = rng.normal(0, 1e4, (S, n))
    v[rng.random((S, n)) < 0.05] = np.nan
    return v, rng.random((S, n)) < 0.9, 0


FUNCS = [("row_number", None), ("rank", None), ("dense_rank", None),
         ("ntile", 3), ("ntile", 50), ("lag", 1), ("lag", (2, -7)),
         ("lead", 1), ("lead", (3, 11)), ("first_value", None),
         ("last_value", None), ("sum", None), ("count", None),
         ("count_star", None), ("avg", None), ("min", None), ("max", None)]
NEEDS_ARG = {"lag", "lead", "first_value", "last_value", "sum", "count",
             "avg", "min", "max"}
CASES = {
    "mixed": (3, 32, 0.2, 0.4),
    "n1": (2, 1, 0.5, 0.5),
    "every_row_a_boundary": (2, 32, 1.0, 1.0),
    "one_partition": (2, 32, 0.0, 0.3),
}
FRAMES = [None, (None, 0), (None, None), (2, 0), (1, 1)]


def _funcs(pkg, vals, valid, scale, ordered):
    out = []
    for i, (fname, param) in enumerate(FUNCS):
        func = "count" if fname == "count_star" else fname
        arg = fname in NEEDS_ARG
        out.append(pkg.WinFunc(f"f{i}", func, vals if arg else None,
                               valid if arg else None,
                               scale if arg else 0, ordered, param))
    return out


def _magnitude(vals, valid, sel):
    """Per segment: the sum of |value| over live valid rows, which bounds
    every running sum of the segment — what a difference of two running
    sums is exact to."""
    a = np.where(sel & (True if valid is None else valid),
                 np.abs(np.nan_to_num(vals.astype(np.float64))), 0.0)
    return a.sum(axis=1)


@pytest.mark.parametrize("frame", FRAMES, ids=str)
@pytest.mark.parametrize("case", sorted(CASES))
def test_compute_equals_jax(case, frame):
    S, n, p_part, p_peer = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case) * 10
                                + FRAMES.index(frame))
    sel, part_eq, peer_eq = _window_inputs(rng, S, n, p_part, p_peer)
    for kind in ("int64", "int32", "decimal", "float64"):
        vals, valid, scale = _values(rng, S, n, kind)
        for ordered in (False, True):
            tv = torch.as_tensor(vals)
            tval = None if valid is None else torch.as_tensor(valid)
            got_v, got_ok = twin.compute(
                torch.as_tensor(part_eq), torch.as_tensor(peer_eq),
                torch.as_tensor(sel),
                _funcs(twin, tv, tval, scale, ordered), frame=frame)
            mag = _magnitude(vals, valid, sel)
            for s in range(S):
                want_v, want_ok = jwin.compute(
                    jnp.asarray(part_eq[s]), jnp.asarray(peer_eq[s]),
                    jnp.asarray(sel[s]),
                    _funcs(jwin, jnp.asarray(vals[s]),
                           None if valid is None else jnp.asarray(valid[s]),
                           scale, ordered), frame=frame)
                for i, (fname, _) in enumerate(FUNCS):
                    name = f"f{i}"
                    where = (kind, ordered, s, fname)
                    wok = want_ok[name]
                    gok = got_ok[name]
                    live = sel[s]
                    if wok is None:
                        assert gok is None, where
                        ok = live
                    else:
                        wok = np.asarray(wok)
                        assert np.array_equal(gok[s].numpy(), wok), where
                        ok = live & wok
                    w = np.asarray(want_v[name])[ok]
                    g = got_v[name][s].numpy()[ok]
                    assert g.dtype == w.dtype, (where, g.dtype, w.dtype)
                    if g.dtype.kind != "f":
                        assert np.array_equal(g, w), where
                        continue
                    assert np.array_equal(np.isnan(g), np.isnan(w)), where
                    fin = ~np.isnan(w)
                    tol = 16 * EPS * mag[s]
                    if fname == "avg":
                        tol = tol + 4 * EPS * np.abs(w[fin])
                    assert np.all(np.abs(g[fin] - w[fin]) <= tol), where


def test_spans_and_segmented_scan_equal_jax():
    rng = np.random.default_rng(5)
    S, n = 4, 32
    bound = rng.random((S, n)) < 0.25
    bound[1] = False                       # no boundary at all
    bound[2] = True                        # every row a boundary
    idx = np.arange(n, dtype=np.int32)
    starts, ends = twin._spans(torch.as_tensor(bound))
    vals = rng.normal(size=(S, n))
    vals[0, 7] = np.nan
    ivals = rng.integers(-50, 50, (S, n))
    for s in range(S):
        want = jwin._starts(jnp.asarray(bound[s]), jnp.asarray(idx))
        assert np.array_equal(starts[s].numpy(), np.asarray(want))
        assert np.array_equal(ends[s].numpy(),
                              np.asarray(jwin._ends(want, n)))
    for top, jop in ((torch.minimum, jnp.minimum),
                     (torch.maximum, jnp.maximum)):
        for v in (vals, ivals):
            got = twin._seg_scan_minmax(torch.as_tensor(v),
                                        torch.as_tensor(bound), top)
            for s in range(S):
                want = jwin._seg_scan_minmax(jnp.asarray(v[s]),
                                             jnp.asarray(bound[s]), jop)
                assert np.array_equal(got[s].numpy(), np.asarray(want),
                                      equal_nan=True)


def test_ntile_bucket_equals_jax():
    rn = np.arange(40)
    for cnt in (1, 3, 7, 40):
        for k in (1, 4, 9, 100):
            got = twin.ntile_bucket(torch.as_tensor(rn), torch.tensor(cnt), k)
            want = jwin.ntile_bucket(jnp.asarray(rn), jnp.int64(cnt), k)
            assert np.array_equal(got.numpy(), np.asarray(want)), (cnt, k)


# ---- (b) rows of db.sql ------------------------------------------------------

def _small_tables(coded):
    """The JAX window tests' tables (their fixtures' rows and seeded
    draws) -> {name: (ddl, columns, valids)}. ``coded`` is the package's
    Coded class for bulk-coded TEXT."""
    out = {}
    out["w"] = ("create table w (g text, k int, v int) distributed by (k)",
                {"g": list("aaaabbbcc"),
                 "k": np.arange(1, 10, dtype=np.int32),
                 "v": np.array([10, 20, 20, 5, 7, 7, 1, 0, 3], np.int32)},
                {"v": np.arange(9) != 7})
    rng = np.random.default_rng(9)
    g, t, v = [], [], []
    for gg in range(3):
        for tt in range(10):
            g.append(gg)
            t.append(tt)
            v.append(int(rng.integers(0, 100)))
    out["serie"] = ("create table serie (g int, t int, v int) "
                    "distributed by (g)",
                    {"g": np.array(g, np.int32), "t": np.array(t, np.int32),
                     "v": np.array(v, np.int32)}, None)
    out["ng"] = ("create table ng (k int, g int, v int) distributed by (k)",
                 {"k": np.arange(1, 6, dtype=np.int32),
                  "g": np.array([1, 1, 0, 0, 0], np.int32),
                  "v": np.array([10, 20, 5, 5, 7], np.int32)},
                 {"g": np.array([True, True, False, False, False])})
    out["mmf"] = ("create table mmf (k int, g int, v int) distributed by (k)",
                  {"k": np.array([1, 2, 3], np.int32),
                   "g": np.zeros(3, np.int32),
                   "v": np.array([5, 3, 9], np.int32)}, None)
    out["fwords"] = ("create table fwords (id int, range int, current int) "
                     "distributed by (id)",
                     {"id": np.array([1], np.int32),
                      "range": np.array([10], np.int32),
                      "current": np.array([20], np.int32)}, None)
    out["lg3"] = ("create table lg3 (k int, g int, v int) distributed by (k)",
                  {"k": np.array([1, 2, 3], np.int32),
                   "g": np.zeros(3, np.int32),
                   "v": np.array([10, 20, 30], np.int32)}, None)
    out["dim5"] = ("create table dim5 (pk int, w int) distributed by (pk)",
                   {"pk": np.array([0, 1], np.int32),
                    "w": np.array([100, 101], np.int32)}, None)
    out["nk"] = ("create table nk (k int, v int) distributed by (k)",
                 {"k": np.arange(1, 6, dtype=np.int32),
                  "v": np.array([10, 0, 7, 0, 42], np.int32)},
                 {"v": np.array([True, False, True, False, True])})
    out["wt"] = ("create table wt (s text, v int, k int) distributed by (k)",
                 {"s": ["zebra", "apple", "mango", "apple", "zebra"],
                  "v": np.array([5, 3, 9, 7, 1], np.int32),
                  "k": np.arange(5, dtype=np.int32)}, None)
    rng = np.random.default_rng(21)
    n = 400
    nv = rng.integers(0, 90, n).astype(np.float64)
    nv[rng.random(n) < 0.15] = np.nan
    cols = {"k": np.arange(n, dtype=np.int32),
            "d": rng.integers(0, 40, n).astype(np.int32),
            "v": rng.integers(0, 1000, n).astype(np.int32),
            "f": np.round(rng.random(n), 6)}
    cols["nv"] = np.where(np.isnan(nv), 0, nv).astype(np.int32)
    out["s"] = ("create table s (k int, d int, v int, f double precision, "
                "nv int) distributed by (k)", cols,
                {"nv": ~np.isnan(nv)})
    out["dec"] = ("create table dec (k int, p decimal(12,2)) "
                  "distributed by (k)",
                  {"k": np.arange(5, dtype=np.int32),
                   "p": np.array([1025, 350, 9999, 349, 5000], np.int64)},
                  None)
    rng = np.random.default_rng(3)
    n = 300
    out["wa"] = ("create table wa (g int, h int, v int, k int) "
                 "distributed by (k)",
                 {"g": rng.integers(0, 6, n).astype(np.int32),
                  "h": rng.integers(0, 2, n).astype(np.int32),
                  "v": rng.integers(0, 100, n).astype(np.int32),
                  "k": np.arange(n, dtype=np.int32)}, None)
    rng = np.random.default_rng(5)
    out["gs"] = ("create table gs (cat text, brand text, region int, "
                 "qty int, price double precision, k bigint) "
                 "distributed by (k)",
                 {"cat": coded(["books", "food", "toys"],
                               rng.integers(0, 3, n).astype(np.int32)),
                  "brand": coded([f"b{i}" for i in range(5)],
                                 rng.integers(0, 5, n).astype(np.int32)),
                  "region": rng.integers(0, 4, n).astype(np.int32),
                  "qty": rng.integers(1, 50, n).astype(np.int32),
                  "price": rng.uniform(1, 100, n),
                  "k": np.arange(n, dtype=np.int64)}, None)
    rng = np.random.default_rng(21)
    n = 400
    g = rng.integers(0, 4, n).astype(np.int32)
    x = rng.normal(100, 25, n)
    w = rng.integers(0, 9, n).astype(np.int32)
    nulls = rng.random(n) < 0.1
    out["ps"] = ("create table ps (g int, x double precision, w int, k int) "
                 "distributed by (k)",
                 {"g": g, "x": x, "w": w, "k": np.arange(n, dtype=np.int32)},
                 {"x": ~nulls})
    out["ct"] = ("create table ct (a int, b int) distributed by (a)",
                 {"a": np.array([5, 6, 7], np.int32),
                  "b": np.array([1, 2, 3], np.int32)}, None)
    return out


# test name (of the JAX test file it replays) -> statement
SMALL = {
    # tests/test_window.py
    "row_number_and_rank":
        "select g, v, row_number() over (partition by g order by v) rn, "
        "rank() over (partition by g order by v) rk, "
        "dense_rank() over (partition by g order by v) dr "
        "from w order by g, v nulls last",
    "partition_aggregate_no_order":
        "select g, v, sum(v) over (partition by g) s, "
        "count(v) over (partition by g) c, max(v) over (partition by g) m "
        "from w order by g, k",
    "running_sum_with_peers":
        "select g, v, sum(v) over (partition by g order by v) rs "
        "from w where g = 'b' order by v",
    "global_window_no_partition":
        "select k, row_number() over (order by k desc) rn from w order by k",
    "window_count_star":
        "select g, count(*) over (partition by g) c from w order by g, k",
    "lag_lead":
        "select g, t, v, lag(v) over (partition by g order by t), "
        "lead(v, 2) over (partition by g order by t) "
        "from serie order by g, t",
    "first_last_value":
        "select g, t, first_value(v) over (partition by g order by t), "
        "last_value(v) over (partition by g order by t rows between "
        "unbounded preceding and unbounded following) "
        "from serie order by g, t",
    "ntile": "select g, t, ntile(3) over (partition by g order by t) "
             "from serie order by g, t",
    "rows_frame_moving_sum":
        "select g, t, sum(v) over (partition by g order by t "
        "rows between 2 preceding and current row) from serie order by g, t",
    "rows_frame_with_following":
        "select g, t, count(*) over (partition by g order by t "
        "rows between 1 preceding and 1 following) from serie order by g, t",
    "mixed_distinct_and_plain_aggregates":
        "select g, count(distinct v), count(*), sum(v) from serie "
        "group by g order by g",
    "mixed_distinct_plain_scalar":
        "select count(distinct v), count(*), max(v) from serie",
    "mixed_distinct_null_group_key":
        "select g, count(distinct v), count(*), sum(v) from ng "
        "group by g order by g",
    "minmax_whole_partition_frame":
        "select v, min(v) over (partition by g order by v desc rows between "
        "unbounded preceding and unbounded following), max(v) over "
        "(partition by g order by v desc rows between unbounded preceding "
        "and current row) from mmf order by v desc",
    "frame_words_remain_identifiers": "select range, current from fwords",
    "lag_with_default":
        "select v, lag(v, 1, -1) over (order by v) from lg3 order by v",
    "global_unordered_window_stays_distributed":
        "select t, sum(v) over () as tot, count(*) over () as n, "
        "avg(v) over () as a, min(v) over () as lo, max(v) over () as hi "
        "from serie order by t limit 3",
    "global_row_number_distributed_and_dense":
        "select t, row_number() over () as rn from serie",
    "global_ordered_window_still_exact":
        "select g, t, row_number() over (order by g, t) as rn "
        "from serie order by g, t",
    "global_ordered_row_number_distributed":
        "select g, t, v, row_number() over (order by v) as rn, "
        "rank() over (order by v) as rk from serie",
    "global_ordered_row_number_desc":
        "select v, row_number() over (order by v desc) as rn from serie",
    "global_ordered_rank_matches_funnel:dist":
        "select t, rank() over (order by v) as rk from serie",
    "global_ordered_rank_matches_funnel:funnel":
        "select t, rank() over (order by v + 0) as rk from serie",
    "left_join_null_extended_key_distributed":
        "select serie.t, dim5.w, rank() over (order by dim5.w) as rk "
        "from serie left join dim5 on serie.g = dim5.pk",
    "global_ordered_multikey_distributed":
        "select g, t, v, row_number() over (order by v, t desc) rn, "
        "rank() over (order by v, t desc) rk, "
        "dense_rank() over (order by v, t desc) dr from serie",
    "global_ordered_dense_rank_single_key":
        "select v, dense_rank() over (order by v) dr from serie",
    "global_ordered_nullable_key_classes:asc":
        "select k, rank() over (order by v) rk from nk",
    "global_ordered_nullable_key_classes:desc":
        "select k, rank() over (order by v desc) rk from nk",
    "global_ordered_nullable_key_classes:nulls_first":
        "select k, rank() over (order by v nulls first) rk from nk",
    "global_ordered_dense_rank_with_nulls":
        "select k, dense_rank() over (order by v) dr from nk",
    "global_ordered_text_keys_distributed:one":
        "select s, row_number() over (order by s) rn from wt",
    "global_ordered_text_keys_distributed:two":
        "select s, v, rank() over (order by s, v desc) rk from wt",
    # tests/test_window_global.py
    "ntile_global_unique_key":
        "select k, ntile(7) over (order by k) nt from s",
    "ntile_global_desc_and_more_buckets_than_rows":
        "select k, ntile(1000) over (order by k desc) nt from s",
    "ntile_global_ties_bucket_sizes":
        "select d, ntile(6) over (order by d) nt from s",
    "lag_lead_global_unique_key":
        "select k, lag(v) over (order by k) lg, "
        "lead(v, 3) over (order by k) ld, "
        "lag(v, 2, -5) over (order by k) lgd from s",
    "lag_global_ties_multiset":
        "select d, lag(d) over (order by d) lg from s",
    "lag_lead_global_nullable_keys":
        "select k, nv, row_number() over (order by nv) rn, "
        "lead(k) over (order by nv) ld from s",
    "lag_global_nulls_first_desc":
        "select k, nv, row_number() over (order by nv desc) rn, "
        "lag(k) over (order by nv desc) lg from s",
    "first_last_value_ordered_global":
        "select k, first_value(v) over (order by k) f, "
        "last_value(v) over (order by k) l from s",
    "last_value_ordered_global_peers":
        "select d, last_value(d) over (order by d) l, "
        "first_value(d) over (order by d) f from s",
    "multikey_packed_ntile_lag":
        "select k, ntile(5) over (order by d, k) nt, "
        "lag(v) over (order by d, k) lg from s",
    "decimal_order_key_gather_free":
        "select k, rank() over (order by p desc) rk, "
        "ntile(2) over (order by p desc) nt from dec",
    "float_order_key_full64":
        "select k, row_number() over (order by f) rn, "
        "lag(k) over (order by f) lg from s",
    "range_mode_running_sum_oracle":
        "select k, sum(v) over (order by d, f, k) rs, "
        "row_number() over (order by d, f, k) rn, "
        "rank() over (order by d, f, k) rk, "
        "dense_rank() over (order by d, f, k) dr from s",
    "range_mode_ntile_lag_minmax":
        "select k, ntile(9) over (order by d, f) nt, "
        "lag(v, 2) over (order by d, f) lg, min(v) over (order by d, f) mn, "
        "max(v) over (order by d, f) mx, count(*) over (order by d, f) c, "
        "avg(v) over (order by d, f) av from s",
    "range_mode_first_last_value":
        "select k, first_value(v) over (order by f, k) fv, "
        "last_value(v) over (order by f, k) lv from s",
    "range_mode_desc_and_nulls":
        "select k, nv, row_number() over (order by nv desc, f, k) rn from s",
    "range_vs_funnel_equivalence:range":
        "select k, sum(v) over (order by d, f) rs from s",
    "range_vs_funnel_equivalence:funnel":
        "select k, sum(v) over (order by (d < 10000), d, f) rs from s",
    "first_last_value_no_order_global":
        "select k, first_value(v) over () f, last_value(v) over () l from s",
    "first_last_value_no_order_partitioned":
        "select d, first_value(v) over (partition by d) f, "
        "last_value(v) over (partition by d) l from s",
    # tests/test_winagg.py
    "rank_over_sum":
        "select g, sum(v) s, rank() over (order by sum(v) desc) rnk "
        "from wa group by g order by rnk, g",
    "percent_of_total":
        "select g, sum(v) s, sum(v) * 100.0 / sum(sum(v)) over () p "
        "from wa group by g order by g",
    "partitioned_window_over_agg":
        "select g, h, sum(v) s, rank() over (partition by h "
        "order by sum(v) desc) rnk from wa group by g, h order by h, rnk, g",
    "window_over_count_star_with_having":
        "select g, count(*) c, row_number() over (order by count(*) desc, g) "
        "rn from wa group by g having count(*) > 10 order by rn",
    "window_over_stat_agg":
        "select g, rank() over (order by stddev(v) desc) rnk "
        "from wa group by g",
    "rank_within_rollup_levels":
        "select g, h, sum(v) rev, grouping(g, h) lvl, "
        "rank() over (partition by grouping(g, h) order by sum(v) desc) rnk "
        "from wa group by rollup(g, h) order by lvl, rnk",
    # tests/test_groupingsets.py
    "rollup_totals":
        "select cat, brand, sum(qty) q from gs "
        "group by rollup(cat, brand) order by cat, brand",
    "cube_counts":
        "select cat, region, count(*) c from gs group by cube(cat, region)",
    "grouping_sets_explicit":
        "select cat, region, sum(qty) q from gs "
        "group by grouping sets ((cat), (region), ())",
    "grouping_function_bitmask":
        "select grouping(cat, brand) g, count(*) c from gs "
        "group by rollup(cat, brand) order by g",
    "mixed_plain_and_rollup":
        "select region, cat, sum(qty) q from gs "
        "group by region, rollup(cat)",
    "having_on_grouping":
        "select cat, sum(qty) q from gs group by rollup(cat) "
        "having grouping(cat) = 1",
    "rollup_no_aggregates": "select cat from gs group by rollup(cat)",
    "rollup_with_stat_aggs":
        "select cat, stddev(price) s from gs group by rollup(cat) "
        "order by cat nulls last",
    "order_by_agg_expr_over_rollup":
        "select cat, sum(qty) from gs group by rollup(cat) "
        "order by grouping(cat), sum(qty) desc",
    "grouping_in_order_by_plain_group":
        "select cat from gs group by cat order by grouping(cat), cat",
    "ds_q22_shape":
        "select cat, brand, avg(qty) aq from gs where region < 3 "
        "group by rollup(cat, brand) order by aq desc, cat, brand limit 10",
    # tests/test_orderedset.py
    "percentile_cont_grouped":
        "select g, percentile_cont(0.5) within group (order by x) m, "
        "percentile_cont(0.9) within group (order by x) p90 "
        "from ps group by g order by g",
    "percentile_disc_and_median":
        "select g, percentile_disc(0.25) within group (order by x) d, "
        "median(x) med from ps group by g order by g",
    "scalar_percentile_with_other_aggs":
        "select count(*), percentile_cont(0.5) within group (order by x), "
        "sum(w) from ps",
    "percentile_edge_fractions":
        "select percentile_cont(0) within group (order by x) lo, "
        "percentile_cont(1) within group (order by x) hi, "
        "percentile_disc(0) within group (order by x) dlo from ps",
    "percentile_in_expression_and_filter":
        "select g from ps group by g having percentile_cont(0.5) within "
        "group (order by x) > 95 order by g",
    "group_by_ordinal_and_qualified_names:ordinal":
        "select g, percentile_cont(0.5) within group (order by x) "
        "from ps group by 1 order by 1",
    "group_by_ordinal_and_qualified_names:qualified":
        "select ps.g, percentile_cont(0.5) within group (order by ps.x) "
        "from ps group by ps.g order by ps.g",
    "percentile_under_rollup":
        "select g, percentile_cont(0.5) within group (order by x) m "
        "from ps group by rollup(g) order by g nulls last",
    "percentile_of_grouping_key_under_rollup":
        "select g, percentile_cont(0.5) within group (order by g) m "
        "from ps group by rollup(g) order by g nulls last",
    "order_by_percentile_under_rollup":
        "select g, percentile_cont(0.5) within group (order by x) m "
        "from ps group by rollup(g) "
        "order by percentile_cont(0.5) within group (order by x)",
    # tests/test_constrel.py
    "constant_subquery:one": "select q.x from (select 1 as x) q",
    "constant_subquery:two": "select x + y from (select 2 as x, 3 as y) q",
    "cross_join_constants_onto_table":
        "select a, s.x from ct, (select 41 as x) s order by a",
    "plain_cte_constant_body":
        "with c as (select 7 as v) select a + c.v from ct, c order by 1",
    "union_in_derived_table":
        "select x from (select 1 as x union all select 2) u order by x",
    "small_cartesian_product":
        "select a, u.y from ct, (select 1 as y union all select 2) u "
        "order by a, y",
    "cartesian_with_aggregate":
        "select count(*), sum(a + u.y) from ct, "
        "(select 10 as y union all select 20) u",
    # SELECT without FROM on the host path and through ConstRel
    "select_without_from":
        "select 1 + 2, date '1998-12-01' - interval '90' day",
    "select_without_from_typed":
        "select cast(1.5 as decimal(10,2)) as d, null as n, 'abc' as t, "
        "2.5 as f, true as b, upper('x') u",
    "select_without_from_where_false": "select 1 where false",
    "select_without_from_limit_0": "select 1 limit 0",
}

# the statements of the JAX tests that must raise: the port raises the
# same SqlError
SMALL_ERRORS = {
    "first_value_still_needs_args:args":
        ("select first_value() over () from s", "requires an argument"),
    "first_value_still_needs_args:order":
        ("select ntile(4) over () from s", "ORDER BY"),
    "errors:within_group":
        ("select percentile_cont(0.5) from ps", "WITHIN GROUP"),
    "errors:fraction":
        ("select percentile_cont(1.5) within group (order by x) from ps",
         "fraction"),
    "errors:desc":
        ("select percentile_cont(0.5) within group (order by x desc) "
         "from ps", "DESC"),
    "within_group_rejected_for_plain_aggs":
        ("select sum(x) within group (order by x) from ps",
         "not supported for sum"),
}

# the SF10 statements of chip_smoke.py's windows phase, at SF 0.002
CHIP = {
    "win_local":
        "select rn, count(*), sum(l_extendedprice), sum(run_qty) "
        "from (select l_extendedprice, row_number() over (partition by "
        "l_orderkey order by l_extendedprice desc, l_linenumber) rn, "
        "sum(l_quantity) over (partition by l_orderkey order by "
        "l_linenumber) run_qty from lineitem) t group by rn order by rn",
    "win_partition":
        "select count(*), sum(cust_total), max(cust_total), sum(cust_rank) "
        "from (select sum(o_totalprice) over (partition by o_custkey) "
        "cust_total, rank() over (partition by o_custkey order by "
        "o_orderdate) cust_rank from orders) t",
    "win_global_unordered":
        "select count(*), min(tot), max(tot), max(rn), sum(rn) "
        "from (select sum(o_totalprice) over () tot, row_number() over () rn "
        "from orders) t",
    "win_global_ordered":
        "select nt, count(*), min(o_orderkey), max(o_orderkey), sum(dr), "
        "sum(rk) from (select o_orderkey, ntile(100) over (order by "
        "o_orderkey) nt, dense_rank() over (order by o_orderdate) dr, "
        "rank() over (order by o_totalprice desc) rk from orders) t "
        "group by nt order by nt",
    "win_global_range":
        "select o_orderkey, rs, rc, rmax from (select o_orderkey, "
        "sum(o_totalprice) over (order by o_totalprice, o_orderkey) rs, "
        "count(*) over (order by o_totalprice, o_orderkey) rc, "
        "max(o_orderdate) over (order by o_totalprice, o_orderkey) rmax "
        "from orders) t where o_orderkey % 64 = 1 order by o_orderkey",
    "rollup":
        "select l_returnflag, l_linestatus, sum(l_quantity), "
        "sum(l_extendedprice), count(*) from lineitem "
        "where l_shipdate <= date '1998-09-02' "
        "group by rollup (l_returnflag, l_linestatus) "
        "order by l_returnflag, l_linestatus",
    "union_distinct_count":
        "select count(*) from (select o_custkey as k from orders "
        "where o_orderkey < 2000 union select c_custkey from customer "
        "where c_nationkey < 5) u",
    "constrel_cross":
        "select count(*), sum(l_quantity * k) from lineitem, "
        "(select 2 as k) c",
}
# the windows phase's running max and float64 running sum (segment-local
# over a Redistribute by o_custkey), sampled; its float sums are held to
# their prefix magnitude, not to 64 ulps of the result (test below)
WIN_RUNNING = (
    "select o_orderkey, run_max, run_fsum from (select o_orderkey, "
    "max(o_totalprice) over (partition by o_custkey order by "
    "o_orderdate) run_max, sum(cast(o_totalprice as double precision)) "
    "over (partition by o_custkey order by o_orderdate) run_fsum "
    "from orders) t where o_orderkey % 64 = 1 order by o_orderkey")
TPCH = dict({k: v for k, v in TPCH_QUERIES.items()
             if any(w in k for w in ("window", "union", "ordered_global",
                                     "range_window", "whole_frame"))},
            **CHIP)

_DS_SHARE = """
  select i_item_id, i_item_desc, i_category, i_class, i_current_price,
         sum({v}_ext_sales_price) as itemrevenue,
         sum({v}_ext_sales_price) * 100 /
           sum(sum({v}_ext_sales_price)) over (partition by i_class)
           as revenueratio
  from {t}, item, date_dim
  where {v}_item_sk = i_item_sk
    and i_category in ('Sports', 'Books', 'Home')
    and {v}_sold_date_sk = d_date_sk
    and d_date between cast('{d0}' as date) and (cast('{d0}' as date) + 30 days)
  group by i_item_id, i_item_desc, i_category, i_class, i_current_price
  order by i_category, i_class, i_item_id, i_item_desc, revenueratio"""
TPCDS = {
    **{k: TPCDS_QUERIES[k] for k in ("ds_q27_rollup_grouping",
                                     "ds_q70_grouped_rank",
                                     "ds_q86_share_of_total")},
    "q12_web_revenue_share": _DS_SHARE.format(t="web_sales", v="ws",
                                              d0="1999-02-22"),
    "q98_store_revenue_share": _DS_SHARE.format(t="store_sales", v="ss",
                                                d0="2001-01-12"),
    "q89_monthly_vs_average": """
      select i_category, i_class, i_brand, s_store_name, s_company_name,
             d_moy, sum_sales, avg_monthly_sales
      from (select i_category, i_class, i_brand, s_store_name,
                   s_company_name, d_moy, sum(ss_sales_price) sum_sales,
                   avg(sum(ss_sales_price)) over
                     (partition by i_category, i_brand, s_store_name,
                      s_company_name) avg_monthly_sales
            from item, store_sales, date_dim, store
            where ss_item_sk = i_item_sk and ss_sold_date_sk = d_date_sk
              and ss_store_sk = s_store_sk and d_year = 1999
              and ((i_category in ('Books', 'Electronics', 'Sports')
                    and i_class in ('class 1', 'class 2', 'class 3'))
                or (i_category in ('Men', 'Jewelry', 'Women')
                    and i_class in ('class 4', 'class 5', 'class 6')))
            group by i_category, i_class, i_brand, s_store_name,
                     s_company_name, d_moy) tmp1
      where case when avg_monthly_sales <> 0
                 then abs(sum_sales - avg_monthly_sales) / avg_monthly_sales
                 else null end > 0.1
      order by sum_sales - avg_monthly_sales, s_store_name, i_brand,
               i_class, d_moy limit 100""",
}


def _assert_rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for i, (a, b) in enumerate(zip(g, w)):
            assert type(a) is type(b), (i, a, b)
            if isinstance(b, (float, np.floating)) and a != b:
                assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= 64 * \
                    EPS * max(abs(a), abs(b), 1.0), (i, a, b)
            else:
                assert a == b, (i, a, b)


def _assert_running_rows(got, want, total):
    """WIN_RUNNING's rows: keys and DECIMAL maxes exact, float64 running
    sums within 64 ulps of ``total`` (the sum of |o_totalprice| over the
    table, which bounds every segment's prefix: the sum is a difference of
    two running sums)."""
    assert len(got) == len(want)
    for (gk, gm, gs), (wk, wm, ws) in zip(got, want):
        assert (gk, gm) == (wk, wm)
        assert abs(gs - ws) <= 64 * EPS * total, (gk, gs, ws)


def _load_small(db, coded):
    for name, (ddl, cols, valids) in _small_tables(coded).items():
        db.sql(ddl)
        db.load_table(name, cols, valids)
    db.sql("analyze")


@pytest.fixture(scope="module")
def dbs(devices8):
    """{(package, width, suite): Database}: suite "h" holds TPC-H (SF
    0.002) and the JAX window tests' tables, suite "ds" the TPC-DS schema
    (scale 0.1; its customer table is not TPC-H's), each analyzed."""
    out = {}
    for width in WIDTHS:
        for pkg, kw, tpch, tpcds, coded in (
                ("jax", {}, jtpch, jtpcds, JCoded),
                ("torch", {"device": "cpu"}, ttpch, ttpcds, TCoded)):
            mod = greengage_tpu if pkg == "jax" else greengage_tpu_torch
            h = mod.connect(numsegments=width, **kw)
            ds = mod.connect(numsegments=width, **kw)
            if pkg == "jax":
                h.sql("set cost_feedback = off")
                ds.sql("set cost_feedback = off")
            tpch.load(h, sf=SF)
            _load_small(h, coded)
            tpcds.load(ds, DS_SCALE)
            ds.sql("analyze")
            out[pkg, width, "h"] = h
            out[pkg, width, "ds"] = ds
    return out


ALL = {**{f"small:{k}": v for k, v in SMALL.items()},
       **{f"tpch:{k}": v for k, v in TPCH.items()},
       **{f"tpcds:{k}": v for k, v in TPCDS.items()}}


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("name", sorted(ALL))
def test_rows_equal_jax(dbs, name, width):
    text = ALL[name]
    suite = "ds" if name.startswith("tpcds:") else "h"
    want = dbs["jax", width, suite].sql(text).rows()
    got = dbs["torch", width, suite].sql(text)
    _assert_rows_equal(got.rows(), want)


@pytest.mark.parametrize("width", WIDTHS)
def test_running_max_and_float_sum_equal_jax(dbs, width):
    """A segment-local running max (the doubling min/max scan) and a
    float64 running sum (the two-level float scan) over orders."""
    want = dbs["jax", width, "h"].sql(WIN_RUNNING).rows()
    got = dbs["torch", width, "h"].sql(WIN_RUNNING).rows()
    total = float(dbs["torch", width, "h"].sql(
        "select sum(abs(cast(o_totalprice as double precision))) "
        "from orders").rows()[0][0])
    assert len(got) > 30
    _assert_running_rows(got, want, total)


@pytest.mark.parametrize("name", sorted(SMALL_ERRORS))
def test_rejected_statements_raise_as_in_jax(dbs, name):
    text, match = SMALL_ERRORS[name]
    with pytest.raises(SqlError, match=match):
        dbs["torch", 8, "h"].sql(text)


def _window(plan):
    while not isinstance(plan, Window):
        plan = plan.children[0]
    return plan


@pytest.mark.parametrize("name, mode", [
    ("win_local", None), ("win_partition", None), ("win_running", None),
    ("win_global_unordered", True), ("win_global_ordered", "ordered"),
    ("win_global_range", "range")])
def test_chip_statements_plan_their_window_mode(dbs, name, mode):
    """The windows phase's statements take the mode it names, none through
    the one-segment funnel (chip_smoke.py asserts the same at SF10)."""
    text = WIN_RUNNING if name == "win_running" else CHIP[name]
    planned, _, _ = dbs["torch", 8, "h"]._plan(tparse(text)[0])
    w = _window(planned)
    assert getattr(w, "global_mode", None) == mode
    assert "SingleQE" not in tdescribe(planned)
    child = w.child
    if mode == "range":
        assert isinstance(child, Motion) and child.range_spec is not None
    if name == "win_local":
        # lineitem is distributed by l_orderkey: no Motion below
        assert not isinstance(child, Motion)
    if name == "win_running":
        # one window node over a Redistribute by the partition key
        assert isinstance(child, Motion) \
            and child.kind is MotionKind.REDISTRIBUTE
    if name == "win_partition":
        # two windows over one Redistribute by the partition key
        assert isinstance(child, Window)
        assert isinstance(child.child, Motion) \
            and child.child.kind is MotionKind.REDISTRIBUTE


def test_rollup_launches_the_fused_kernel_per_keyed_branch(monkeypatch):
    """ROLLUP over lineitem's dense keys: each branch with keys aggregates
    through the fused kernel (here its plain version), the grand total
    through the scalar aggregate — two launches per statement."""
    calls = []
    plain = fused_agg._segment_reduce_plain

    def spy(table):
        calls.append(table.D)
        return plain(table)

    monkeypatch.setattr(fused_agg, "_segment_reduce_plain", spy)
    db = greengage_tpu_torch.connect(numsegments=8, device="cpu")
    ttpch.load(db, sf=0.01, tables=["lineitem"])
    db.sql("analyze")
    db.settings.fused_dense_min_rows = 1000
    r = db.sql(CHIP["rollup"])
    assert r.stats["fused_gate"]
    assert sorted(calls) == [4, 12]
    assert len(r) == 10


# ---- (c) the range repartition's overflow retry ------------------------------

def test_skewed_range_key_retries_at_the_next_tier(devices8):
    """90% of the rows share one leading key: the range repartition sends
    them all to one destination, past tier 0's bucket; both packages
    retry at tier 1 and return the same rows. 512 rows per segment (a
    power of two) give both packages the same scan capacity: the JAX
    compiler rounds a scan's capacity up to one, the port does not."""
    rng = np.random.default_rng(17)
    n = 4096
    d = np.where(rng.random(n) < 0.9, 7, rng.integers(0, 1000, n))
    cols = {"k": np.arange(n, dtype=np.int32), "d": d.astype(np.int32),
            "f": rng.random(n), "v": rng.integers(0, 100, n).astype(np.int32)}
    ddl = ("create table sk (k int, d int, f double precision, v int) "
           "distributed randomly")
    q = ("select k, rs, rn from (select k, sum(v) over (order by d, f) rs, "
         "row_number() over (order by d, f) rn from sk) t "
         "where k % 97 = 0 order by k")
    res = {}
    for pkg, kw in ((greengage_tpu, {}),
                    (greengage_tpu_torch, {"device": "cpu"})):
        db = pkg.connect(numsegments=8, **kw)
        db.sql(ddl)
        db.load_table("sk", cols)
        db.sql("analyze")
        res[pkg.__name__] = db.sql(q)
    want, got = res["greengage_tpu"], res["greengage_tpu_torch"]
    planned, _, _ = db._plan(tparse(q)[0])
    assert _window(planned).global_mode == "range"
    assert got.stats["tiers_used"] == want.stats["tiers_used"] == 2
    _assert_rows_equal(got.rows(), want.rows())


# The windows phase's statements that retry at SF10, at CPU sizes where
# they overflow tier 0: (statement, TPC-H scale, tables, tiers_used of a
# cold and a warm run in the JAX package, the same in the port). ROADMAP
# Queue 3 item 3 reads them:
# - win_local's one-phase GROUP BY rn redistributes raw rows by a key of
#   7 values; two of them meet at one destination past tier 0's bucket
#   in both packages once their buckets agree (SF 0.0015). At SF 0.001
#   the port's bucket is half the JAX package's, because the port's scan
#   capacity is the largest segment's row count and the JAX package's is
#   its power of two: only the port retries (the open fault).
# - The distinct UNION's group table overflows its estimate; a warm JAX
#   run reuses the exact count its plan cache kept (ROADMAP 1d), a warm
#   port run retries again.
RETRIES = {
    "win_local_sf0.0015": ("win_local", 0.0015, ["lineitem"],
                           (2, 2), (2, 2)),
    "win_local_sf0.001": ("win_local", 0.001, ["lineitem"], (1, 1), (2, 2)),
    "union_sf0.2": ("union_chip", 0.2, ["orders", "customer"],
                    (2, 1), (2, 2)),
}
UNION_CHIP = (
    "select count(*) from (select o_custkey from orders "
    "where o_totalprice > 499000 union select c_custkey from customer "
    "where c_nationkey < 3) u")


@pytest.mark.parametrize("name", sorted(RETRIES))
def test_windows_phase_retries_against_jax(devices8, name):
    stmt, sf, tables, want_tiers, got_tiers = RETRIES[name]
    text = UNION_CHIP if stmt == "union_chip" else CHIP[stmt]
    res = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            db = greengage_tpu.connect(numsegments=8)
            db.sql("set cost_feedback = off")
            jtpch.load(db, sf=sf, tables=tables)
        else:
            db = greengage_tpu_torch.connect(numsegments=8, device="cpu")
            db.sql(ttpch.DDL)
            for t, cols in ttpch.generate(sf).items():
                if t not in tables:
                    continue
                if t == "customer":
                    # unique per row: bulk-coded (raw TEXT waits for 1e)
                    names = cols["c_name"]
                    cols = dict(cols, c_name=TCoded(
                        list(names), np.arange(len(names), dtype=np.int32)))
                db.load_table(t, cols)
        db.sql("analyze")
        res[pkg] = [db.sql(text) for _ in range(2)]
    assert tuple(r.stats["tiers_used"] for r in res["jax"]) == want_tiers
    assert tuple(r.stats["tiers_used"] for r in res["torch"]) == got_tiers
    for j, t in zip(res["jax"], res["torch"]):
        _assert_rows_equal(t.rows(), j.rows())


# ---- (d) plans of the TPC-DS corpus ------------------------------------------

@pytest.mark.parametrize("name", sorted(TPCDS_QUERIES))
def test_tpcds_plan_equals_jax(dbs, name):
    text = TPCDS_QUERIES[name]
    jplanned, jconsts, _ = dbs["jax", 8, "ds"]._plan(jparse(text)[0])
    tplanned, tconsts, _ = dbs["torch", 8, "ds"]._plan(tparse(text)[0])
    assert tdescribe(tplanned) == jdescribe(jplanned)
    jconsts = {k: v for k, v in jconsts.items() if k != "@consts_digest@"}
    assert sorted(tconsts) == sorted(jconsts)
    for k, v in jconsts.items():
        if isinstance(v, np.ndarray):
            assert np.array_equal(np.asarray(tconsts[k]), v), k
        else:
            assert tconsts[k] == v, k


# ---- (e) on the card ----------------------------------------------------------

@pytest.mark.cuda
def test_windows_rollup_and_union_on_the_card_equal_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dbs = {}
    for dev in ("cpu", "cuda"):
        db = greengage_tpu_torch.connect(numsegments=8, device=dev)
        db.settings.fused_dense_min_rows = 1000
        ttpch.load(db, sf=0.01)
        db.sql("analyze")
        dbs[dev] = db
    for name in sorted(TPCH):
        text = TPCH[name]
        _assert_rows_equal(dbs["cuda"].sql(text).rows(),
                           dbs["cpu"].sql(text).rows())
    total = float(dbs["cpu"].sql(
        "select sum(abs(cast(o_totalprice as double precision))) "
        "from orders").rows()[0][0])
    _assert_running_rows(dbs["cuda"].sql(WIN_RUNNING).rows(),
                         dbs["cpu"].sql(WIN_RUNNING).rows(), total)
    before = fused_agg.LAUNCHES
    dbs["cuda"].sql(CHIP["rollup"])
    assert fused_agg.LAUNCHES == before + 2
