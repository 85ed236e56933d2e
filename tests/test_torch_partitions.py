"""Partitioned tables in the port against the JAX package:
tests/test_partitions.py replayed.

Every case runs the same statements through ``greengage_tpu.connect(...)``
and ``greengage_tpu_torch.connect(..., device="cpu")`` and holds each
command tag, each SELECT's rows (``assert_rows_match``: integers and
DECIMAL exactly), each child table's row counts, the pruned partition
counts of EXPLAIN and of ``stats["partitions"]`` equal. The cases that
touch storage (routing, DML that moves rows, ADD/DROP PARTITION, expand,
reopen) run in memory and in a database directory; the rest in one of the
two. What differs from the JAX file:

  * its two transaction cases (``begin`` ... ``rollback``/``commit``) pin
    the port's raise naming ROADMAP Queue 1 item 1a-iii; the not-null
    half of the failed routed insert runs without a transaction;
  * ``checkcat`` (the CLI, item 11) runs the JAX package's checker over
    the directory the port wrote.
"""

import numpy as np
import pytest

import greengage_tpu
import greengage_tpu_torch
from greengage_tpu.sql.parser import SqlError as JSqlError
from greengage_tpu_torch.sql.parser import SqlError
from torch_breadth import assert_rows_match

MODES = ("memory", "directory")

SALES = ("""
    create table sales (id int, day int, amount bigint, region text)
    distributed by (id)
    partition by range (day) (
        partition q1 start (0) end (90),
        partition q2 start (90) end (180),
        partition q3 start (180) end (270),
        default partition tail
    )""", "insert into sales values " + ",".join(
    f"({i}, {i % 400}, {i * 3}, 'r{i % 3}')" for i in range(400)))


def _pair(tmp_path, mode, nseg=4, name="c"):
    if mode == "memory":
        return (greengage_tpu.connect(numsegments=nseg),
                greengage_tpu_torch.connect(numsegments=nseg, device="cpu"))
    return (greengage_tpu.connect(str(tmp_path / f"j{name}"),
                                  numsegments=nseg),
            greengage_tpu_torch.connect(str(tmp_path / f"t{name}"),
                                        numsegments=nseg, device="cpu"))


def _both(j, t, text):
    """One statement in both packages: equal tags, or equal rows and equal
    partition counts."""
    want = j.sql(text)
    got = t.sql(text)
    if isinstance(want, str):
        assert got == want, (text, got, want)
        return got
    assert_rows_match(got.rows(), want.rows(), text)
    if getattr(want, "plan_text", None) is None:
        assert (got.stats.get("partitions") or {}) \
            == (want.stats.get("partitions") or {}), text
    return got


def _raises_both(j, t, text, match):
    with pytest.raises((SqlError, JSqlError, ValueError, KeyError),
                       match=match):
        j.sql(text)
    with pytest.raises((SqlError, ValueError, KeyError), match=match):
        t.sql(text)


def _children(db, table):
    return {p.name: db.store.segment_rowcounts(f"{table}#{p.name}")
            for p in db.catalog.get(table).partitions}


def _sales(tmp_path, mode):
    j, t = _pair(tmp_path, mode)
    for text in SALES:
        _both(j, t, text)
    return j, t


@pytest.fixture
def pair(request):
    made = []
    yield made
    for j, t in made:
        t.close()


@pytest.mark.parametrize("mode", MODES)
def test_rows_land_in_partitions(tmp_path, devices8, pair, mode):
    j, t = _sales(tmp_path, mode)
    pair.append((j, t))
    assert _children(t, "sales") == _children(j, "sales")
    counts = {k: sum(v) for k, v in _children(t, "sales").items()}
    assert counts == {"q1": 90, "q2": 90, "q3": 90, "tail": 130}


def test_select_spans_partitions(tmp_path, devices8, pair):
    j, t = _sales(tmp_path, "memory")
    pair.append((j, t))
    got = _both(j, t, "select count(*), sum(amount) from sales")
    assert got.rows() == [(400, sum(i * 3 for i in range(400)))]


def test_static_pruning_matches_oracle_and_prunes(tmp_path, devices8, pair):
    j, t = _sales(tmp_path, "directory")
    pair.append((j, t))
    for q, n in (("select count(*) from sales where day < 90", 90),
                 ("select count(*) from sales where day >= 90 "
                  "and day < 180", 90)):
        assert _both(j, t, q).rows() == [(n,)]
        assert t.sql(q).stats["partitions"] == {"sales": 2}
        want = str(j.sql("explain " + q))
        got = t.sql("explain " + q).plan_text
        assert "partitions: 2/4" in want and "partitions: 2/4" in got
    got = _both(j, t, "select amount from sales where day = 5 "
                      "order by amount")
    assert [a for (a,) in got.rows()] == [15]


def test_group_by_across_partitions(tmp_path, devices8, pair):
    j, t = _sales(tmp_path, "memory")
    pair.append((j, t))
    got = _both(j, t, "select region, count(*) from sales group by region "
                      "order by region")
    assert got.rows() == [("r0", 134), ("r1", 133), ("r2", 133)]


def test_join_partitioned_fact(tmp_path, devices8, pair):
    j, t = _sales(tmp_path, "directory")
    pair.append((j, t))
    for text in ("create table dim (region text, label int) "
                 "distributed replicated",
                 "insert into dim values ('r0', 10), ('r1', 11), "
                 "('r2', 12)"):
        _both(j, t, text)
    got = _both(j, t, "select label, count(*) from sales join dim "
                      "on sales.region = dim.region group by label "
                      "order by label")
    assert got.rows() == [(10, 134), (11, 133), (12, 133)]


@pytest.mark.parametrize("mode", MODES)
def test_dml_routes_and_moves_rows(tmp_path, devices8, pair, mode):
    j, t = _sales(tmp_path, mode)
    pair.append((j, t))
    _both(j, t, "delete from sales where day >= 270")
    assert _both(j, t, "select count(*) from sales").rows() == [(270,)]
    assert sum(t.store.segment_rowcounts("sales#tail")) == 0
    # an UPDATE that moves a row across partitions (day 10 -> 100)
    _both(j, t, "update sales set day = 100 where id = 10")
    assert _children(t, "sales") == _children(j, "sales")
    assert sum(t.store.segment_rowcounts("sales#q1")) == 89
    assert sum(t.store.segment_rowcounts("sales#q2")) == 91
    assert _both(j, t, "select day from sales where id = 10").rows() \
        == [(100,)]
    _both(j, t, "update sales set amount = amount + 1")
    _both(j, t, "select id, day, amount, region from sales order by id")
    _both(j, t, "delete from sales")
    assert _both(j, t, "select count(*) from sales").rows() == [(0,)]


def test_no_partition_accepts_errors_without_default(tmp_path, devices8,
                                                     pair):
    j, t = _pair(tmp_path, "memory", 2)
    pair.append((j, t))
    _both(j, t, "create table t (k int, v int) distributed by (k) "
                "partition by range (v) (partition a start (0) end (10))")
    _raises_both(j, t, "insert into t values (1, 99)", "no partition")
    _both(j, t, "insert into t values (1, 5)")
    assert _both(j, t, "select count(*) from t").rows() == [(1,)]


def test_list_partitions(tmp_path, devices8, pair):
    j, t = _pair(tmp_path, "directory", 2)
    pair.append((j, t))
    _both(j, t, """create table ev (k int, typ int) distributed by (k)
                   partition by list (typ) (
                     partition small values (1, 2),
                     partition big values (3),
                     default partition other)""")
    _both(j, t, "insert into ev values (1,1),(2,2),(3,3),(4,7)")
    assert _children(t, "ev") == _children(j, "ev")
    assert {k: sum(v) for k, v in _children(t, "ev").items()} \
        == {"small": 2, "big": 1, "other": 1}
    assert _both(j, t, "select count(*) from ev where typ = 3").rows() \
        == [(1,)]
    got = t.sql("explain select count(*) from ev where typ = 3").plan_text
    assert "partitions: 2/3" in got   # big + default
    assert "partitions: 2/3" in str(
        j.sql("explain select count(*) from ev where typ = 3"))


def test_every_expansion(tmp_path, devices8, pair):
    j, t = _pair(tmp_path, "memory", 2)
    pair.append((j, t))
    _both(j, t, "create table m (k int, d int) distributed by (k) partition "
                "by range (d) (partition p start (0) end (30) every (10))")
    names = [p.name for p in t.catalog.get("m").partitions]
    assert names == [p.name for p in j.catalog.get("m").partitions] \
        == ["p_1", "p_2", "p_3"]
    _both(j, t, "insert into m values (1, 5), (2, 15), (3, 25)")
    assert sum(t.store.segment_rowcounts("m#p_2")) == 1


@pytest.mark.parametrize("mode", MODES)
def test_parent_read_lands_children_in_one_slot(tmp_path, devices8, pair,
                                                mode):
    """The store reads a partitioned parent as its children (or the
    ``parts`` a pruned scan keeps) one after another: into a caller's
    slot, each child's rows at its offset, equal to the children's own
    reads; the counts over ``parts`` sum the same children."""
    j, t = _sales(tmp_path, mode)
    pair.append((j, t))
    st, snap = t.store, t.store.manifest.snapshot()
    names = [f"sales#{p.name}" for p in t.catalog.get("sales").partitions]
    for parts in (None, (names[0], names[3]), ()):
        kids = names if parts is None else list(parts)
        for seg in range(4):
            own = [st.read_segment(k, seg, ["id", "amount"], snap)
                   for k in kids]
            n = sum(r[2] for r in own)
            slot = np.full(n + 5, -1, np.int64)
            cols, valids, got = st.read_segment(
                "sales", seg, ["id", "amount"], snap,
                dest={"amount": slot}, parts=parts)
            assert got == n
            assert not n or np.shares_memory(cols["amount"], slot)
            for c in ("id", "amount"):
                want = (np.concatenate([r[0][c] for r in own]) if own
                        else np.empty(0, np.int64))
                assert np.array_equal(cols[c], want), (parts, seg, c)
            assert (slot[n:] == -1).all()
        assert st.segment_rowcounts("sales", snap, parts) == [
            sum(st.segment_rowcounts(k, snap)[s] for k in kids)
            for s in range(4)]
        assert st.pruned_rowcounts("sales", snap, None, parts) \
            == st.segment_rowcounts("sales", snap, parts)


@pytest.mark.parametrize("mode", MODES)
def test_add_drop_partition(tmp_path, devices8, pair, mode):
    j, t = _sales(tmp_path, mode)
    pair.append((j, t))
    _both(j, t, "alter table sales drop partition tail")
    assert _both(j, t, "select count(*) from sales").rows() == [(270,)]
    _both(j, t, "alter table sales add partition q4 start (270) end (360)")
    _both(j, t, "insert into sales values (9000, 300, 1, 'r0')")
    assert sum(t.store.segment_rowcounts("sales#q4")) == 1
    # the dropped child is gone from the manifest
    assert "sales#tail" not in t.store.manifest.snapshot()["tables"]
    _raises_both(j, t, "insert into sales values (9001, 900, 1, 'r0')",
                 "no partition")
    _both(j, t, "select region, sum(amount) from sales group by region "
                "order by region")


def test_overlap_and_duplicate_validation(tmp_path, devices8, pair):
    j, t = _pair(tmp_path, "memory", 2)
    pair.append((j, t))
    _raises_both(j, t, "create table x (k int, v int) distributed by (k) "
                       "partition by range (v) (partition a start (0) "
                       "end (10), partition b start (5) end (20))",
                 "overlapping")
    _raises_both(j, t, "create table y (k int, v int) distributed by (k) "
                       "partition by list (v) (partition a values (1), "
                       "partition b values (1, 2))", "multiple list")


def test_analyze_and_stats_span_partitions(tmp_path, devices8, pair):
    j, t = _sales(tmp_path, "directory")
    pair.append((j, t))
    _both(j, t, "analyze sales")
    st, jst = t.catalog.get("sales").stats, j.catalog.get("sales").stats
    assert st.rows == jst.rows == 400
    assert (st.columns["day"].min, st.columns["day"].max) \
        == (jst.columns["day"].min, jst.columns["day"].max) == (0, 399)


def test_transactional_multi_partition_insert(tmp_path, devices8, pair):
    """Transactions are ROADMAP Queue 1 item 1a-iii in the port: BEGIN
    raises naming it, and the rows stay as they were."""
    j, t = _sales(tmp_path, "memory")
    pair.append((j, t))
    for text in ("begin", "commit", "rollback"):
        with pytest.raises(SqlError, match="item 1a-iii"):
            t.sql(text)
    assert _both(j, t, "select count(*) from sales").rows() == [(400,)]


def test_drop_table_drops_children(tmp_path, devices8, pair):
    j, t = _sales(tmp_path, "directory")
    pair.append((j, t))
    _both(j, t, "drop table sales")
    for db in (j, t):
        snap = db.store.manifest.snapshot()
        assert not any(x.startswith("sales#") for x in snap["tables"])
    _raises_both(j, t, "select * from sales", "does not exist")


@pytest.mark.parametrize("mode", MODES)
def test_expand_partitioned(tmp_path, devices8, pair, mode):
    j, t = _sales(tmp_path, mode)
    pair.append((j, t))
    before = _both(j, t, "select sum(amount) from sales").rows()
    assert t.expand(8) == j.expand(8)
    assert _both(j, t, "select sum(amount) from sales").rows() == before
    counts = t.store.segment_rowcounts("sales#q1")
    assert counts == j.store.segment_rowcounts("sales#q1")
    assert len(counts) == 8 and sum(counts) == 90
    _both(j, t, "select count(*) from sales where day < 90")


def test_every_with_dates(tmp_path, devices8, pair):
    j, t = _pair(tmp_path, "memory", 2)
    pair.append((j, t))
    _both(j, t, "create table dt (k int, dd date) distributed by (k) "
                "partition by range (dd) (partition m start "
                "(date '2024-01-01') end (date '2024-03-01') every (31))")
    assert len(t.catalog.get("dt").partitions) == 2   # 60 days / 31
    _both(j, t, "insert into dt values (1, date '2024-02-15')")
    assert sum(t.store.segment_rowcounts("dt#m_2")) == 1


def test_partition_def_shape_validation(tmp_path, devices8, pair):
    j, t = _pair(tmp_path, "memory", 2)
    pair.append((j, t))
    _both(j, t, "create table lt (k int, v int) distributed by (k) "
                "partition by list (v) (partition a values (1))")
    _raises_both(j, t, "alter table lt add partition b", "VALUES")
    _both(j, t, "create table rt (k int, v int) distributed by (k) "
                "partition by range (v) (partition a start (0) end (10))")
    _raises_both(j, t, "alter table rt add partition b values (5)",
                 "LIST syntax")
    _raises_both(j, t, "create table nt (k int, v int) distributed by (k) "
                       "partition by list (v) (partition a values (null))",
                 "NULL")


def test_failed_routed_insert_stages_nothing(tmp_path, devices8, pair):
    """The JAX case wraps the insert in BEGIN ... COMMIT (item 1a-iii in
    the port): a row batch with a NULL in a NOT NULL column raises before
    any child stages, inside a transaction or not."""
    j, t = _pair(tmp_path, "directory", 2)
    pair.append((j, t))
    _both(j, t, "create table st (k int, v int not null) distributed by "
                "(k) partition by range (v) (partition a start (0) end (10), "
                "partition b start (10) end (20))")
    _raises_both(j, t, "insert into st values (1, 5), (2, null)",
                 "not-null")
    assert _both(j, t, "select count(*) from st").rows() == [(0,)]
    assert t.store.manifest.snapshot()["tables"].get("st#a") is None


def test_two_unbounded_starts_rejected(tmp_path, devices8, pair):
    j, t = _pair(tmp_path, "memory", 2)
    pair.append((j, t))
    _raises_both(j, t, "create table ub (k int, v int) distributed by (k) "
                       "partition by range (v) (partition a end (10), "
                       "partition b end (20))", "overlapping")


def test_checkcat_clean_on_the_port_directory(tmp_path, devices8, pair,
                                              capsys):
    """The JAX package's catalog checker finds the directory the port
    wrote (partitions, children, a reopen) consistent."""
    from greengage_tpu.mgmt import cli

    j, t = _sales(tmp_path, "directory")
    t.sql("alter table sales add partition q4 start (400) end (500)")
    t.close()
    t2 = greengage_tpu_torch.connect(str(tmp_path / "tc"), device="cpu")
    assert t2.sql("select count(*) from sales").rows() == [(400,)]
    assert [p.name for p in t2.catalog.get("sales").partitions] \
        == ["q1", "q2", "q3", "tail", "q4"]
    t2.close()
    rc = cli.main(["checkcat", "-d", str(tmp_path / "tc")])
    out = capsys.readouterr().out
    assert rc == 0 and "consistent" in out
    # and the JAX package reads the port's partitioned rows
    jd = greengage_tpu.connect(str(tmp_path / "tc"))
    assert jd.sql("select count(*), sum(amount) from sales").rows() \
        == [(400, sum(i * 3 for i in range(400)))]


# ---- the whole slice on one statement set -----------------------------------

Q1_SELECT = """
  select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
         sum(l_extendedprice) as sum_base_price,
         sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
         sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
         avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price,
         avg(l_discount) as avg_disc, count(*) as count_order
  from lineitem_p where {where}
  group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus"""
SLICE = {
    "q1": Q1_SELECT.format(where="l_shipdate <= date '1998-09-02'"),
    "q1_month": Q1_SELECT.format(
        where="l_shipdate >= date '1995-06-01' and "
              "l_shipdate < date '1995-07-01'"),
    "q6_1994": """
      select sum(l_extendedprice * l_discount) as revenue from lineitem_p
      where l_shipdate >= date '1994-01-01' and l_shipdate < date '1995-01-01'
        and l_discount between 0.05 and 0.07 and l_quantity < 24""",
}


def lineitem_p_ddl() -> str:
    """TPC-H lineitem partitioned a year a partition, 1992-1998, and a
    DEFAULT (the yearly fact partitioning of Greenplum's "Partitioning
    Large Tables")."""
    from greengage_tpu_torch.utils import tpch as ttpch

    cols = ttpch.DDL.split("create table if not exists lineitem (")[1] \
        .split(") distributed by")[0]
    years = ", ".join(
        f"partition y{y} start (date '{y}-01-01') end (date '{y + 1}-01-01')"
        for y in range(1992, 1999))
    return (f"create table lineitem_p ({cols}) distributed by (l_orderkey) "
            f"partition by range (l_shipdate) ({years}, "
            "default partition other)")


@pytest.mark.parametrize("nseg", [1, 4])
def test_partitioned_lineitem_q1_q6_month_range(devices8, nseg):
    """A small TPC-H lineitem partitioned by year, loaded in l_shipdate
    order: Q1, a month-range Q1 and Q6 (1994) give the JAX package's rows
    with the same partition and block counts; the fused aggregation's
    plain version runs (``fused_dense_min_rows`` lowered)."""
    from greengage_tpu.utils import tpch as jtpch
    from greengage_tpu_torch.utils import tpch as ttpch

    li = ttpch.generate(0.01)["lineitem"]
    jli = jtpch.generate(0.01)["lineitem"]
    order = np.argsort(li["l_shipdate"], kind="stable")
    j = greengage_tpu.connect(numsegments=nseg)
    t = greengage_tpu_torch.connect(numsegments=nseg, device="cpu")
    try:
        for db, cols, mod in ((j, jli, greengage_tpu.types),
                              (t, li, greengage_tpu_torch.types)):
            db.settings.fused_dense_min_rows = 128
            db.sql(lineitem_p_ddl())
            db.load_table("lineitem_p", {
                k: (mod.Coded(v.vocab, v.codes[order])
                    if isinstance(v, mod.Coded) else v[order])
                for k, v in cols.items()})
        for name, q in SLICE.items():
            got, want = t.sql(q), j.sql(q)
            assert_rows_match(got.rows(), want.rows(), name)
            assert got.stats["partitions"] == want.stats["partitions"]
            assert got.stats.get("zone_prune", {}) \
                == want.stats.get("zone_prune", {}), name
        assert t.sql(SLICE["q1_month"]).stats["partitions"] \
            == {"lineitem_p": 2}
        assert t.sql(SLICE["q1"]).stats["fused_gate"]
    finally:
        t.close()
