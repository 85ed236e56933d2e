"""The port's SQL front end and Database (greengage_tpu_torch.connect)
against the JAX package's on the same TPC-H data (SF 0.002, both analyzed):
equal ASTs, equal ANALYZE statistics, equal plans and binder constants for
the TPC-H plan corpus, and equal rows for Q1, Q6, the basics of
tests/test_sql.py, and the joins, subqueries and high-cardinality GROUP BYs
of the corpus, Q13, Q19 and tests/test_sql.py's join shapes, at 1 and 8
segments.

Tolerances: keys, sums (DECIMAL as scaled int64), counts and every other
value must be equal; avg may differ by one ulp, because XLA compiles the
JAX side's division into a multiplication by the reciprocal and the port
divides truly.

The JAX side plans with its feedback store off (``cost_feedback``): the
port's planner has none yet, and the store would re-estimate a plan after
each execution."""

import dataclasses
import enum
import re

import numpy as np
import pytest
import torch

import greengage_tpu
import greengage_tpu_torch
from greengage_tpu.analysis.plancorpus import TPCH_QUERIES
from greengage_tpu.planner.logical import describe as jdescribe
from greengage_tpu.sql.parser import parse as jparse
from greengage_tpu.utils import tpch as jtpch
from greengage_tpu_torch import entry
from greengage_tpu_torch.config import Settings
from greengage_tpu_torch.ops import fused_agg
from greengage_tpu_torch.planner.logical import describe as tdescribe
from greengage_tpu_torch.sql.parser import SqlError
from greengage_tpu_torch.sql.parser import parse as tparse
from greengage_tpu_torch.utils import tpch as ttpch

SF = 0.002

Q1 = """
  select l_returnflag, l_linestatus,
         sum(l_quantity) as sum_qty,
         sum(l_extendedprice) as sum_base_price,
         sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
         sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
         avg(l_quantity) as avg_qty,
         avg(l_extendedprice) as avg_price,
         avg(l_discount) as avg_disc,
         count(*) as count_order
  from lineitem
  where l_shipdate <= date '1998-12-01' - interval '90' day
  group by l_returnflag, l_linestatus
  order by l_returnflag, l_linestatus
"""

# query -> (text, the result columns that hold an avg)
QUERIES = {
    "q1": (Q1, (6, 7, 8)),
    "q6": (TPCH_QUERIES["q6_forecast_revenue"], ()),
    "select_where": ("select l_orderkey, l_quantity from lineitem "
                     "where l_quantity > 45 order by l_orderkey, l_quantity",
                     ()),
    "projection_arithmetic": (
        "select l_orderkey, l_extendedprice * (1 - l_discount) as rev "
        "from lineitem where l_orderkey <= 20 order by 1, 2", ()),
    "limit_offset": ("select o_orderkey from orders order by o_orderkey "
                     "limit 5 offset 3", ()),
    "distinct": ("select distinct l_returnflag from lineitem "
                 "order by l_returnflag", ()),
    "in": ("select count(*) from lineitem "
           "where l_shipmode in ('AIR', 'RAIL')", ()),
    "like": ("select count(*) from orders where o_orderpriority like '1%'",
             ()),
    "between": ("select count(*) from lineitem "
                "where l_quantity between 10 and 20", ()),
    "case_sum": ("select sum(case when l_returnflag = 'A' then 1 else 0 end) "
                 "from lineitem", ()),
    "group_by_avg": ("select l_shipmode, count(*), avg(l_tax), "
                     "min(l_discount), max(l_quantity) from lineitem "
                     "group by l_shipmode order by l_shipmode", (2,)),
    # the evaluator's Func, Lut and InList nodes as the binder emits them
    "extract_filter": ("select count(*) from orders "
                       "where extract(year from o_orderdate) = 1995", ()),
    "string_function": ("select count(*), sum(l_quantity) from lineitem "
                        "where lower(l_shipmode) in ('air', 'rail') "
                        "and substring(l_shipinstruct, 1, 4) = 'DELI'", ()),
    "decimal_round_coalesce": (
        "select l_linestatus, sum(round(l_extendedprice * l_discount, 1)), "
        "max(coalesce(nullif(l_tax, 0.0), l_discount)) from lineitem "
        "group by l_linestatus order by l_linestatus", ()),
    "add_months_column": ("select min(o_orderdate + interval '1' month), "
                          "max(date_trunc('quarter', o_orderdate)) "
                          "from orders", ()),
}


@pytest.fixture(scope="module")
def jdb(devices8):
    db = greengage_tpu.connect(numsegments=8)
    db.sql("set cost_feedback = off")
    jtpch.load(db, sf=SF)
    db.sql("analyze")
    return db


@pytest.fixture(scope="module")
def tdbs():
    out = {}
    for nseg in (1, 8):
        db = greengage_tpu_torch.connect(numsegments=nseg, device="cpu")
        ttpch.load(db, sf=SF)
        db.sql("analyze")
        out[nseg] = db
    return out


@pytest.fixture(scope="module")
def jrows(jdb):
    return {name: jdb.sql(text).rows() for name, (text, _) in QUERIES.items()}


def _tree(x):
    """A parse tree as plain tuples, so the two packages' (distinct)
    dataclasses compare by class name and field values."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, _tree(getattr(x, f.name)))
            for f in dataclasses.fields(x))
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name)
    if isinstance(x, (list, tuple)):
        return tuple(_tree(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _tree(v)) for k, v in x.items()))
    return x


def _norm(text: str) -> str:
    """tests/test_plan_goldens.py's normalisation."""
    text = re.sub(r" rows=\d+", "", text)
    text = re.sub(r"^(\s*(?:Filter|Project))[^\n]*?((?:  \[[^\]]*\])?)$",
                  r"\1\2", text, flags=re.M)
    text = re.sub(r"#\d+", "#N", text)
    text = re.sub(r" \(direct dispatch: seg \d+\)", " (direct)", text)
    return text


def _assert_rows_equal(got, want, avg_cols=()):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for i, (a, b) in enumerate(zip(g, w)):
            if i in avg_cols:
                assert abs(a - b) <= np.spacing(max(abs(a), abs(b))), (i, a, b)
            else:
                assert a == b, (i, a, b)
                assert type(a) is type(b), (i, type(a), type(b))


# ---- (a) parser ---------------------------------------------------------

PARSED = dict(TPCH_QUERIES, **{k: v for k, (v, _) in QUERIES.items()})


@pytest.mark.parametrize("name", sorted(PARSED))
def test_parse_equals_jax(name):
    text = PARSED[name]
    assert _tree(tparse(text)) == _tree(jparse(text))


# ---- (b) ANALYZE ----------------------------------------------------------

@pytest.mark.parametrize("table", ["lineitem", "orders", "nation"])
def test_analyze_stats_equal_jax(jdb, tdbs, table):
    want = jdb.catalog.get(table).stats
    got = tdbs[8].catalog.get(table).stats
    assert want is not None and want.rows > 0
    # every statistic; the fingerprint hashes the store's own manifest
    # entry, whose form differs between the two stores
    assert got.rows == want.rows
    assert _tree(got.columns) == _tree(want.columns)


# ---- (c) plans --------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(TPCH_QUERIES))
def test_plan_equals_jax(jdb, tdbs, name):
    text = TPCH_QUERIES[name]
    jplanned, jconsts, _ = jdb._plan(jparse(text)[0])
    tplanned, tconsts, _ = tdbs[8]._plan(tparse(text)[0])
    assert _norm(tdescribe(tplanned)) == _norm(jdescribe(jplanned))
    # estimates too (the compiler sizes capacities from them)
    assert tdescribe(tplanned) == jdescribe(jplanned)
    # the JAX session adds a digest of the pool for its plan cache
    jconsts = {k: v for k, v in jconsts.items() if k != "@consts_digest@"}
    assert sorted(tconsts) == sorted(jconsts)
    for k, v in jconsts.items():
        if isinstance(v, np.ndarray):
            assert np.array_equal(np.asarray(tconsts[k]), v), k
        else:
            assert tconsts[k] == v, k


# ---- (d) results ----------------------------------------------------------

@pytest.mark.parametrize("nseg", [1, 8])
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_rows_equal_jax(jrows, tdbs, name, nseg):
    text, avg_cols = QUERIES[name]
    r = tdbs[nseg].sql(text)
    _assert_rows_equal(r.rows(), jrows[name], avg_cols)
    assert r.stats["tiers_used"] == 1 and r.stats["wall_ms"] > 0


def test_result_to_pandas(tdbs):
    df = tdbs[8].sql("select l_returnflag, count(*) from lineitem "
                     "group by l_returnflag order by l_returnflag").to_pandas()
    assert list(df.columns) == ["l_returnflag", "count"]
    assert list(df.l_returnflag) == ["A", "N", "R"]
    assert int(df["count"].sum()) == 11935


# ---- (e) Q1's plan is the hand-built one ---------------------------------

def test_sql_q1_plan_is_entry_q1_plan(tdbs):
    planned, _, _ = tdbs[8]._plan(tparse(Q1)[0])
    assert _norm(tdescribe(planned)) == _norm(tdescribe(entry.q1_plan(8)))


def test_sql_q1_fused_path_matches_jax(jrows, tdbs, monkeypatch):
    calls = []
    plain = fused_agg._segment_reduce_plain

    def spy(table):
        calls.append((table.D, len(table.slots), len(table.jobs),
                      table.bytes_per_row))
        return plain(table)

    monkeypatch.setattr(fused_agg, "_segment_reduce_plain", spy)
    db = tdbs[8]
    db.settings.fused_dense_min_rows = 1
    try:
        r = db.sql(Q1)
    finally:
        db.settings.fused_dense_min_rows = Settings().fused_dense_min_rows
    _assert_rows_equal(r.rows(), jrows["q1"], QUERIES["q1"][1])
    # the partial and the final Aggregate both take the kernel; the partial
    # holds Q1's job table: 8 recorded / 6 distinct jobs over gid, the
    # selection and 5 base columns (45 B per row)
    assert len(calls) == 2
    assert calls[0] == (12, 8, 6, 45)
    assert r.stats["fused_gate"]


# ---- (f) joins and sort-based grouping ------------------------------------

# the corpus queries with joins, subqueries (semi, anti and null-aware anti
# joins) and GROUP BYs without a dense key domain; tests/test_tpch_more.py's
# Q13 and Q19; tests/test_sql.py's join shapes -> (text, avg columns)
JOIN_QUERIES = dict(
    {name: (TPCH_QUERIES[name], ()) for name in (
        "q3_shipping_priority", "q10_returned_items", "q12_shipmode",
        "q14_promo_effect", "q18_large_volume", "semi_exists", "anti_not_in",
        "cross_join_scalar", "two_phase_strewn_group")},
    q13=("""select c_count, count(*) as custdist from (
              select c_custkey, count(o_orderkey) as c_count
              from customer left join orders
                on c_custkey = o_custkey and o_comment not like '%comment 1%'
              group by c_custkey) c_orders
            group by c_count order by custdist desc, c_count desc""", ()),
    q19=("""select sum(l_extendedprice * (1 - l_discount)) as revenue
            from lineitem, part
            where p_partkey = l_partkey
              and ((p_brand = 'Brand#11' and l_quantity between 1 and 11
                    and p_size between 1 and 5)
                or (p_brand = 'Brand#22' and l_quantity between 10 and 20
                    and p_size between 1 and 10)
                or (p_brand = 'Brand#33' and l_quantity between 20 and 30
                    and p_size between 1 and 15))
              and l_shipmode in ('AIR', 'REG AIR')""", ()),
    explicit_join=("select o_orderkey, c_name from orders join customer "
                   "on c_custkey = o_custkey where o_orderkey <= 5 "
                   "order by o_orderkey", ()),
    left_join_nulls=("select a.k, w from lj_a a left join lj_b b "
                     "on a.k = b.k order by a.k", ()),
    duplicate_build_keys=("select a.v av, b.v bv from dup_b a join dup_b b "
                          "on a.k = b.k order by av, bv", ()),
    fk_fk_multi=("select count(*) from customer, supplier "
                 "where c_nationkey = s_nationkey", ()),
    left_join_duplicate_build=("select a.k, w from ml_a a left join ml_b b "
                               "on a.k = b.k order by a.k, w nulls last",
                               ()),
    avg_over_join=("select o_orderpriority, count(*), avg(l_quantity) "
                   "from orders join lineitem on o_orderkey = l_orderkey "
                   "where l_shipmode = 'AIR' group by o_orderpriority "
                   "order by o_orderpriority", (2,)),
)

# tests/test_sql.py's small join tables
SMALL_TABLES = {
    "lj_a": ("create table lj_a (k int, v int) distributed by (k)",
             {"k": [1, 2, 3], "v": [10, 20, 30]}),
    "lj_b": ("create table lj_b (k int, w int) distributed by (k)",
             {"k": [1, 3], "w": [100, 300]}),
    "dup_b": ("create table dup_b (k int, v int) distributed by (k)",
              {"k": [1, 1, 2, 3, 4, 5, 6, 7], "v": [1, 2, 3, 4, 5, 6, 7, 8]}),
    "ml_a": ("create table ml_a (k int, v int) distributed by (k)",
             {"k": [1, 2, 3], "v": [10, 20, 30]}),
    "ml_b": ("create table ml_b (k int, w int) distributed by (k)",
             {"k": [1, 1, 3], "w": [100, 101, 300]}),
}


@pytest.fixture(scope="module")
def join_rows(jdb, tdbs):
    for db in [jdb] + list(tdbs.values()):
        for ddl, cols in SMALL_TABLES.values():
            db.sql(ddl)
            db.load_table(ddl.split()[2], {k: np.asarray(v)
                                           for k, v in cols.items()})
    return {name: jdb.sql(text).rows()
            for name, (text, _) in JOIN_QUERIES.items()}


@pytest.mark.parametrize("nseg", [1, 8])
@pytest.mark.parametrize("name", sorted(JOIN_QUERIES))
def test_join_rows_equal_jax(join_rows, tdbs, name, nseg):
    text, avg_cols = JOIN_QUERIES[name]
    r = tdbs[nseg].sql(text)
    _assert_rows_equal(r.rows(), join_rows[name], avg_cols)
    assert r.stats["wall_ms"] > 0


def test_q3_direct_and_hash_joins_agree(tdbs):
    """Q3 through the direct-addressed joins and through the sort-built
    hash tables (``no_direct``): the same rows."""
    db = tdbs[8]
    planned, consts, _ = db._plan(tparse(TPCH_QUERIES[
        "q3_shipping_priority"])[0])
    direct = db.executor.run(planned, consts)
    hashed = db.executor.run(planned, consts, no_direct=True)
    assert len(direct) == 10
    assert hashed.rows() == direct.rows()


def test_sql_q12_fused_launches(tdbs, monkeypatch):
    """Q12's partial Aggregate over the join output takes the fused kernel
    (here its plain version) once per run of its plan; the first run of
    the statement also runs the unique-key plan that met duplicate build
    keys, so it counts one more."""
    calls = []
    plain = fused_agg._segment_reduce_plain

    def spy(table):
        calls.append(table.D)
        return plain(table)

    monkeypatch.setattr(fused_agg, "_segment_reduce_plain", spy)
    db = greengage_tpu_torch.connect(numsegments=8, device="cpu")
    ttpch.load(db, sf=0.01, tables=["orders", "lineitem"])
    db.sql("analyze")
    # between the final aggregate's input (64 rows: 8 segments x its
    # 8-row buckets) and the 256 rows the warm runs' cap hint gives the
    # join expansion (the partial aggregate's input): the partial takes
    # the fused gate on every run, the final never
    db.settings.fused_dense_min_rows = 128
    q = TPCH_QUERIES["q12_shipmode"]
    first = db.sql(q)
    assert first.stats["fused_gate"]
    assert len(calls) == 1 + first.stats["multi_join_replan"]
    for _ in range(2):
        before = len(calls)
        again = db.sql(q)
        assert len(calls) == before + 1
        assert again.rows() == first.rows()


def test_warm_q12_fused_gate_decides_as_in_jax(devices8):
    """The gate reads the join output's capacity, which a warm Q12's cap
    hint sizes to what the last run measured: with fused_dense_min_rows
    above that capacity and below the cold run's, the first run takes the
    kernel and the warm runs do not, in both packages alike (chip_smoke.py
    --sf 1 meets this at the default 65,536 rows per segment)."""
    q = TPCH_QUERIES["q12_shipmode"]
    jd = greengage_tpu.connect(numsegments=8)
    jd.settings.cost_feedback = False
    jtpch.load(jd, 0.01, tables=["orders", "lineitem"])
    jd.sql("analyze")
    td = greengage_tpu_torch.connect(numsegments=8, device="cpu")
    ttpch.load(td, sf=0.01, tables=["orders", "lineitem"])
    td.sql("analyze")
    try:
        for min_rows, want in ((1024, [True, False, False]),
                               (128, [True, True, True])):
            jd.settings.fused_dense_min_rows = min_rows
            td.settings.fused_dense_min_rows = min_rows
            jgate = [jd.sql(q).stats["fused_kernel"] for _ in range(3)]
            tgate = [td.sql(q).stats["fused_gate"] for _ in range(3)]
            assert tgate == jgate == want
    finally:
        jd.close()
        td.close()


def test_recursive_cte_raises_naming_its_roadmap_item(tdbs):
    # windows, UNION and SELECT without FROM run (tests/test_torch_window.py);
    # the recursive CTE's fixpoint writes its worktables, so it waits for DML
    with pytest.raises(SqlError, match="ROADMAP Queue 1 item 1b"):
        tdbs[8].sql("with recursive r(n) as (select 1 union all "
                    "select n + 1 from r where n < 6) select sum(n) from r")


@pytest.mark.parametrize("stmt", [
    "insert into nation values (99, 'X', 0, 'c')",
    "explain select count(*) from nation",
    "begin",
    "set no_such_setting = 1",
])
def test_unported_statement_raises_sql_error(tdbs, stmt):
    with pytest.raises(SqlError, match="ROADMAP"):
        tdbs[8].sql(stmt)


# ---- (g) capacity-tier retry ------------------------------------------------

def test_overflowing_redistribute_retries_at_a_larger_tier():
    # 500 keys: the planner redistributes the raw rows (one-phase
    # aggregate), ~94 per (source, destination) pair against tier 0's
    # 64-slot buckets at this slack
    keys = [f"k{i:04d}" for i in range(500)]
    rng = np.random.default_rng(7)
    k = [keys[i] for i in rng.integers(0, 500, 6000)]
    v = rng.integers(-1000, 1000, 6000)
    want = {}
    for kk, vv in zip(k, v):
        want[kk] = want.get(kk, 0) + int(vv)
    db = greengage_tpu_torch.connect(numsegments=8, device="cpu")
    db.sql("create table tt (id bigint, k text, v bigint) distributed by (id)")
    db.load_table("tt", {"id": np.arange(6000), "k": k, "v": v})
    db.sql("analyze tt")
    db.sql("set motion_capacity_slack = 0.001")
    r = db.sql("select k, sum(v) from tt group by k order by k")
    assert r.rows() == sorted(want.items())
    assert r.stats["tiers_used"] > 1


# ---- staging from the store -------------------------------------------------

def test_warm_statement_stages_from_the_cache_until_a_write():
    db = greengage_tpu_torch.connect(numsegments=4, device="cpu")
    db.sql("create table ts (id bigint, v bigint) distributed by (id)")
    db.load_table("ts", {"id": np.arange(1000), "v": np.arange(1000)})
    reads = []
    read_segment = db.store.read_segment

    def spy(table, seg, *a, **k):
        reads.append((table, seg))
        return read_segment(table, seg, *a, **k)

    db.store.read_segment = spy
    q = "select count(*), sum(v) from ts where v >= 10"
    assert db.sql(q).rows() == [(990, sum(range(10, 1000)))]
    assert len(reads) == 4                  # one read per segment
    assert db.sql(q).rows() == [(990, sum(range(10, 1000)))]
    assert len(reads) == 4                  # warm: the stage cache
    db.load_table("ts", {"id": np.arange(1000, 1010), "v": np.full(10, 7)})
    assert db.sql(q).rows() == [(990, sum(range(10, 1000)))]
    assert len(reads) == 8                  # a new version is staged anew
    assert db.sql("select count(*) from ts").rows() == [(1010,)]


def test_nulls_match_jax(devices8):
    n = 5000
    rng = np.random.default_rng(11)
    cols = {"id": np.arange(n), "k": [f"g{i}" for i in rng.integers(0, 4, n)],
            "v": rng.integers(-10 ** 6, 10 ** 6, n),
            "d": rng.integers(0, 10 ** 4, n)}
    valids = {"k": rng.random(n) < 0.9, "v": rng.random(n) < 0.7}
    ddl = ("create table tn (id bigint, k text, v bigint, d decimal(12,2)) "
           "distributed by (id)")
    queries = [
        "select k, count(v), sum(v), min(v), max(v), count(*), avg(d) "
        "from tn group by k order by k",
        "select count(*), count(v), sum(v), max(d) from tn where v is null "
        "or d > 50",
        "select coalesce(v, -1) from tn where id < 40 order by id",
    ]
    jdb = greengage_tpu.connect(numsegments=8)
    tdb = greengage_tpu_torch.connect(numsegments=8, device="cpu")
    for db in (jdb, tdb):
        db.sql(ddl)
        db.load_table("tn", cols, valids)
        db.sql("analyze tn")
    for q, avg_cols in zip(queries, [(6,), (), ()]):
        _assert_rows_equal(tdb.sql(q).rows(), jdb.sql(q).rows(), avg_cols)


# ---- the fused gate's job-table limits --------------------------------------

def test_group_by_past_the_kernel_job_table_splits_its_launches(
        devices8, monkeypatch):
    """40 distinct summed columns exceed one launch's 32 (fused_agg.MAX_COLS):
    the plan passes the fused gate and runs through the kernel (here its
    plain version) in one pass per run of jobs, each within the table."""
    tables = []
    plain = fused_agg._segment_reduce_plain

    def spy(table):
        tables.append(table)
        return plain(table)

    monkeypatch.setattr(fused_agg, "_segment_reduce_plain", spy)
    n, ncol = 70_000, 40
    rng = np.random.default_rng(3)
    cols = {"k": [f"g{i}" for i in rng.integers(0, 5, n)]}
    for j in range(1, ncol + 1):
        cols[f"c{j}"] = rng.integers(-10 ** 6, 10 ** 6, n)
    ddl = ("create table wide (k text, "
           + ", ".join(f"c{j} bigint" for j in range(1, ncol + 1))
           + ") distributed randomly")
    q = ("select k, " + ", ".join(f"sum(c{j})" for j in range(1, ncol + 1))
         + " from wide group by k order by k")
    jdb = greengage_tpu.connect(numsegments=1)
    tdb = greengage_tpu_torch.connect(numsegments=1, device="cpu")
    for db in (jdb, tdb):
        db.sql(ddl)
        db.load_table("wide", cols)
    got = tdb.sql(q)
    assert got.stats["fused_gate"]
    assert [len(t.cols) for t in tables] == [fused_agg.MAX_COLS,
                                            ncol - fused_agg.MAX_COLS]
    assert got.rows() == jdb.sql(q).rows()


# ---- (h) on the card ---------------------------------------------------------

@pytest.mark.cuda
def test_sql_q1_on_the_card_equals_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dbs = {}
    for dev in ("cpu", "cuda"):
        db = greengage_tpu_torch.connect(numsegments=8, device=dev)
        # 7.5k rows per segment sit below the fused gate's default; the
        # final Aggregate's 96 rows stay below this one
        db.settings.fused_dense_min_rows = 1000
        ttpch.load(db, sf=0.01, tables=["lineitem"])
        db.sql("analyze lineitem")
        dbs[dev] = db
    want = dbs["cpu"].sql(Q1).rows()
    before = fused_agg.LAUNCHES
    got = dbs["cuda"].sql(Q1).rows()
    assert fused_agg.LAUNCHES == before + 1
    _assert_rows_equal(got, want, QUERIES["q1"][1])


@pytest.mark.cuda
def test_sql_q3_and_q12_on_the_card_equal_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dbs = {}
    for dev in ("cpu", "cuda"):
        db = greengage_tpu_torch.connect(numsegments=8, device=dev)
        # as in test_sql_q12_fused_launches: below the 256 rows a warm
        # Q12's cap hint gives its partial aggregate, above the final's 64
        db.settings.fused_dense_min_rows = 128
        ttpch.load(db, sf=0.01, tables=["customer", "orders", "lineitem"])
        db.sql("analyze")
        dbs[dev] = db
    for name in ("q3_shipping_priority", "q12_shipmode"):
        text = TPCH_QUERIES[name]
        want = dbs["cpu"].sql(text).rows()
        assert dbs["cuda"].sql(text).rows() == want
        before = fused_agg.LAUNCHES
        assert dbs["cuda"].sql(text).rows() == want
        assert fused_agg.LAUNCHES == before + (name == "q12_shipmode")
    planned, consts, _ = dbs["cuda"]._plan(
        tparse(TPCH_QUERIES["q3_shipping_priority"])[0])
    hashed = dbs["cuda"].executor.run(planned, consts, no_direct=True)
    assert hashed.rows() == dbs["cpu"].sql(
        TPCH_QUERIES["q3_shipping_priority"]).rows()
