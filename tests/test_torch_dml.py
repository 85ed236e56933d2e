"""INSERT, DELETE, UPDATE and VACUUM in the port against the JAX package:
tests/test_dml.py and tests/test_visimap.py replayed.

Each case runs the same statements through ``greengage_tpu.connect(...)``
and ``greengage_tpu_torch.connect(..., device="cpu")``, in memory and in a
database directory (``path=``), and holds every command tag equal and
every SELECT's rows to the JAX package's (``assert_rows_match``: integers
and DECIMAL exactly, float64 within 1e-12 relative). Beside the replay:

  * DELETE writes deletion bitmaps only (no data file of the table is
    rewritten in a directory), UPDATE appends one segment's files, VACUUM
    compacts the bitmaps away, as the JAX store does;
  * the cases the port does not take yet raise naming their ROADMAP item:
    a DML inside a transaction (1a-iii), raw TEXT (1e); a width change
    (expand) gives the JAX package's rows;
  * a warm statement after a write restages (the stage cache is keyed by
    the store's version) and never reads stale tensors; a cached plan
    that binds a TEXT literal does not outlive an INSERT that grows the
    dictionary; cap hints kept from before an INSERT are too small after
    it and the overflow retry answers exactly;
  * TPC-H Q1 after DELETE, UPDATE, INSERT ... SELECT and COPY at a tiny
    scale, ``fused_dense_min_rows`` lowered so the fused path's plain
    version runs, equal to the JAX package's rows.

Each test builds its own databases in its own ``tmp_path``; threads are
joined with a timeout in a ``finally``.
"""

import os
import threading

import numpy as np
import pytest

import greengage_tpu
import greengage_tpu.utils.tpch as jtpch
import greengage_tpu_torch
from greengage_tpu_torch.ops import fused_agg
from greengage_tpu_torch.sql.parser import SqlError
from greengage_tpu_torch.storage import native
from greengage_tpu_torch.utils import tpch as ttpch
from greengage_tpu_torch.utils.plancorpus import TPCH22
from torch_breadth import assert_rows_match

MODES = ("memory", "directory")


def _pair(tmp_path, mode, nseg):
    if mode == "memory":
        return (greengage_tpu.connect(numsegments=nseg),
                greengage_tpu_torch.connect(numsegments=nseg, device="cpu"))
    return (greengage_tpu.connect(path=str(tmp_path / "j"),
                                  numsegments=nseg),
            greengage_tpu_torch.connect(path=str(tmp_path / "t"),
                                        numsegments=nseg, device="cpu"))


def _both(j, t, text):
    """One statement in both packages: equal tags, or equal rows."""
    want = j.sql(text)
    got = t.sql(text)
    if isinstance(want, str):
        assert got == want, (text, got, want)
        return got
    assert_rows_match(got.rows(), want.rows(), text)
    return got


def _segfiles(db, table):
    """(data rels, bitmap rels) the manifest references (chunk and mask
    ids in memory)."""
    snap = db.store.manifest.snapshot()
    tmeta = snap["tables"].get(table, {"segfiles": {}})
    masks = set(tmeta.get("delmask", {}).values())
    data = {rel for files in tmeta["segfiles"].values() for rel in files
            if rel not in masks}
    return data, masks


# ---- tests/test_dml.py ------------------------------------------------------

DML_SETUP = (
    "create table t (k bigint, v int, s text, amt decimal(8,2)) "
    "distributed by (k)",
    "insert into t values (1, 10, 'a', 1.50), (2, 20, 'b', 2.50), "
    "(3, 30, 'a', 3.50), (4, null, 'c', 4.50), (5, 50, 'b', 5.50)",
)

DML_CASES = {
    "delete_with_predicate": (
        "delete from t where v > 25", "select k from t order by k"),
    "delete_all_and_empty_table": (
        "delete from t", "select count(*) from t",
        "insert into t values (9, 9, 'z', 9.00)", "select count(*) from t"),
    "update_values_and_nulls": (
        "update t set v = v + 1 where k <= 2",
        "select k, v from t order by k",
        "update t set v = null where k = 1", "select v from t where k = 1"),
    "update_decimal_and_text": (
        "update t set amt = amt * 2 where s = 'a'",
        "select k, amt from t where s = 'a' order by k",
        "update t set s = 'zzz' where k = 2", "select s from t where k = 2",
        "update t set s = s where k = 3", "select s from t where k = 3"),
    "update_distribution_key": (
        "update t set k = 1000 where k = 5",
        "select v from t where k = 1000", "select k, v, s, amt from t "
        "order by k"),
    "insert_select_and_union": (
        "insert into t select k + 100, v, s, amt from t where k < 4",
        "insert into t select k + 200, v, s, amt from t where k = 1 "
        "union all select k + 300, v, s, amt from t where k = 2",
        "select k, v, s, amt from t order by k"),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(DML_CASES))
def test_dml_statements_match_jax(tmp_path, devices8, case, mode):
    j, t = _pair(tmp_path, mode, 4)
    try:
        for text in DML_SETUP + DML_CASES[case]:
            _both(j, t, text)
    finally:
        t.close()


def test_update_distribution_key_moves_rows(tmp_path):
    t = greengage_tpu_torch.connect(path=str(tmp_path / "t"), numsegments=4,
                                    device="cpu")
    try:
        for text in DML_SETUP:
            t.sql(text)
        t.sql("update t set k = 1000 where k = 5")
        found = [seg for seg in range(4)
                 if 1000 in t.store.read_segment("t", seg)[0]["k"]]
        want = int(native.hash_i64(np.array([1000], np.int64))[0] % 4)
        assert found == [want]
    finally:
        t.close()


def test_update_errors_match_jax(tmp_path, devices8):
    j, t = _pair(tmp_path, "memory", 4)
    try:
        for text in DML_SETUP:
            _both(j, t, text)
        for text, match in (("update t set nope = 1", "does not exist"),
                            ("update t set v = 1, v = 2",
                             "multiple assignments"),
                            ("delete from t where k in (select k from t)",
                             "IN/EXISTS"),
                            ("insert into t values (1, 2)", "arity")):
            with pytest.raises(Exception, match=match):
                j.sql(text)
            with pytest.raises(SqlError, match=match):
                t.sql(text)
    finally:
        t.close()


def test_dml_in_a_transaction_raises_naming_its_item(tmp_path):
    """The JAX test stages a DELETE in a transaction and rolls it back;
    the port's transactions wait for ROADMAP Queue 1 item 1a-iii."""
    t = greengage_tpu_torch.connect(numsegments=4, device="cpu")
    try:
        for text in DML_SETUP:
            t.sql(text)
        with pytest.raises(SqlError, match="item 1a-iii"):
            t.sql("begin")
        assert t.sql("delete from t where k = 1") == "DELETE 1"
    finally:
        t.close()


# ---- tests/test_visimap.py --------------------------------------------------

N = 20_000


def _visimap_pair(tmp_path, mode):
    j, t = _pair(tmp_path, mode, 8)
    cols = {"k": np.arange(N), "g": (np.arange(N) % 97).astype(np.int64),
            "v": np.arange(N, dtype=np.int64)}
    for db in (j, t):
        db.sql("create table t (k int, g int, v int) distributed by (k)")
        db.load_table("t", dict(cols))
    return j, t


VISIMAP_CASES = {
    "truncating_delete_counts_live_rows": (
        "delete from t where k < 100", "delete from t",
        "select count(*) from t"),
    "null_predicate_keeps_row": (
        "insert into t values (100000, null, 5)", "delete from t where g = 0",
        "select count(*) from t", "delete from t where v >= 10000",
        "select count(*) from t"),
    "aggregates_and_joins_skip_deleted": (
        "delete from t where k % 2 = 0", "select sum(v) from t",
        "create table d (pk int, w int) distributed by (pk)",
        "insert into d select k, v from t where k < 200",
        "select count(*) from t, d where t.k = d.pk"),
    "insert_after_delete_is_live": (
        "delete from t where k < 19000", "insert into t values (1, 1, 777)",
        "select v from t where k = 1", "delete from t where v = 777",
        "select count(*) from t where k = 1"),
    "update_moves_row_across_segments": (
        "update t set k = 777777 where k = 42",
        "select count(*) from t where k = 42",
        "select v from t where k = 777777", "select count(*) from t"),
    "update_expression_and_where_null": (
        "update t set v = v * 2 where g < 3", "select sum(v) from t",
        "update t set g = null where k < 5", "update t set v = 0 where g = 1",
        "select count(*), sum(v) from t where g is null"),
    "whole_table_update": (
        "update t set v = 1", "select sum(v) from t"),
    "pruned_range_scan_after_delete": (
        "analyze t", "delete from t where k >= 100 and k < 200",
        "select count(*) from t where k < 1000"),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(VISIMAP_CASES))
def test_visimap_statements_match_jax(tmp_path, devices8, case, mode):
    j, t = _visimap_pair(tmp_path, mode)
    try:
        for text in VISIMAP_CASES[case]:
            _both(j, t, text)
    finally:
        t.close()


@pytest.mark.parametrize("mode", MODES)
def test_delete_is_bitmap_only_and_update_appends_one_segment(tmp_path,
                                                              devices8, mode):
    j, t = _visimap_pair(tmp_path, mode)
    try:
        before, _ = _segfiles(t, "t")
        assert _both(j, t, "delete from t where k < 100") == "DELETE 100"
        after, masks = _segfiles(t, "t")
        assert after == before and masks      # no data file rewritten
        assert sum(t.store.live_rowcounts("t")) == N - 100
        assert t.store.live_rowcounts("t") == j.store.live_rowcounts("t")
        assert _both(j, t, "update t set v = -5 where k = 123") == "UPDATE 1"
        after2, _ = _segfiles(t, "t")
        assert before <= after2 and 0 < len(after2 - before) <= 3
        _both(j, t, "select v from t where k = 123")
        _both(j, t, "select count(*) from t")
        # the whole-table UPDATE republishes: no bitmap
        _both(j, t, "update t set v = 1")
        assert not _segfiles(t, "t")[1]
    finally:
        t.close()


@pytest.mark.parametrize("mode", MODES)
def test_vacuum_compacts_bitmap_away(tmp_path, devices8, mode):
    j, t = _visimap_pair(tmp_path, mode)
    try:
        _both(j, t, "delete from t where k % 3 = 0")
        live = t.sql("select count(*) from t").rows()[0][0]
        before, masks0 = _segfiles(t, "t")
        assert masks0
        assert t.vacuum("t") == j.vacuum("t") == {"t": live}
        after, masks1 = _segfiles(t, "t")
        assert not masks1 and after.isdisjoint(before)
        assert sum(t.store.segment_rowcounts("t")) == live
        assert t.store.segment_rowcounts("t") \
            == j.store.segment_rowcounts("t")
        _both(j, t, "select count(*), sum(v), min(k), max(k) from t")
        assert t.vacuum() == j.vacuum() == {}
    finally:
        t.close()


def test_replicated_table_delete_update(tmp_path, devices8):
    j, t = _pair(tmp_path, "directory", 8)
    try:
        for db in (j, t):
            db.sql("create table r (a int, b int) distributed replicated")
            db.load_table("r", {"a": np.arange(100), "b": np.arange(100)})
        for text in ("delete from r where a < 10", "select count(*) from r",
                     "update r set b = -1 where a = 50",
                     "select b from r where a = 50", "select count(*) from r",
                     "select sum(b) from r"):
            _both(j, t, text)
        assert t.store.live_rowcounts("r") == j.store.live_rowcounts("r")
    finally:
        t.close()


def test_analyze_sees_live_rows_only(tmp_path, devices8):
    j, t = _visimap_pair(tmp_path, "memory")
    try:
        for db in (j, t):
            db.sql("delete from t where k >= 1000")
            db.sql("analyze t")
        assert t.catalog.get("t").stats.rows == 1000 \
            == j.catalog.get("t").stats.rows
    finally:
        t.close()


def test_what_waits_raises_naming_its_item(tmp_path, devices8):
    """test_visimap.py's transaction cases (1a-iii) and its raw-TEXT case
    (1e) raise naming their item; its expand case (a width change in
    ``rewrite_table``, ported with the block cache) gives the JAX
    package's rows and widths."""
    j = greengage_tpu.connect(path=str(tmp_path / "j"), numsegments=4)
    t = greengage_tpu_torch.connect(path=str(tmp_path / "t"), numsegments=4,
                                    device="cpu")
    try:
        for db in (j, t):
            db.sql("create table t (k int, v int) distributed by (k)")
            db.load_table("t", {"k": np.arange(500), "v": np.arange(500)})
        for text in ("begin", "commit", "rollback"):
            with pytest.raises(SqlError, match="item 1a-iii"):
                t.sql(text)
        t.sql("create table rt (k int, s text) distributed by (k)")
        strs = [f"payload-{i:06d}-{'x' * (i % 13)}" for i in range(5000)]
        with pytest.raises(NotImplementedError, match="item 1e"):
            t.load_table("rt", {"k": np.arange(5000), "s": strs})
        _both(j, t, "delete from t where k >= 100")
        # rt exists in the port only (its raw load raised): it moves empty
        assert t.expand(8) == dict(j.expand(8), rt=0) == {"t": 100, "rt": 0}
        assert t.store.segment_rowcounts("t") \
            == j.store.segment_rowcounts("t")
        _both(j, t, "select k, v from t order by k")
        assert not t.store.manifest.snapshot()["tables"]["t"].get("delmask")
    finally:
        t.close()


@pytest.mark.parametrize("mode", MODES)
def test_concurrent_reads_during_delete(tmp_path, mode):
    """Readers racing a DELETE see the whole table or the deleted one,
    never part of a bitmap."""
    t = greengage_tpu_torch.connect(
        numsegments=8, device="cpu",
        **({"path": str(tmp_path / "t")} if mode == "directory" else {}))
    errs, seen = [], set()
    stop = threading.Event()
    t.sql("create table t (k int, g int, v int) distributed by (k)")
    t.load_table("t", {"k": np.arange(N), "g": np.arange(N) % 97,
                       "v": np.arange(N)})

    def reader():
        try:
            while not stop.is_set():
                n = int(t.sql("select count(*) from t").rows()[0][0])
                seen.add(n)
                if n not in (N, N // 2):
                    errs.append(n)
                    return
        except Exception as e:   # reported below
            errs.append(repr(e))

    th = [threading.Thread(target=reader) for _ in range(2)]
    try:
        for x in th:
            x.start()
        assert t.sql("delete from t where k < 10000") == "DELETE 10000"
    finally:
        stop.set()
        for x in th:
            x.join(timeout=60)
        t.close()
    assert not any(x.is_alive() for x in th)
    assert not errs, errs


# ---- the caches around a write ---------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_warm_statements_after_a_write_restage(tmp_path, devices8, mode):
    """The executor's stage cache is keyed (table, column, cap, version):
    every write bumps the version, so a warm statement after it restages
    and answers from the new rows, never stale tensors."""
    j, t = _visimap_pair(tmp_path, mode)
    try:
        q = "select count(*), sum(v) from t where g < 50"
        for text in (q, q, "delete from t where k % 5 = 0", q, q,
                     "update t set v = v + 1 where g = 7", q,
                     "insert into t values (-1, 3, 5)", q):
            v0 = t.store.manifest.version()
            _both(j, t, text)
            if not text.startswith("select"):
                assert t.store.manifest.version() > v0
        keys = {k[3] for k in t.executor._stage_cache}
        assert keys == {t.store.manifest.version()}
    finally:
        t.close()


def test_a_text_literal_plan_does_not_outlive_a_growing_insert(tmp_path,
                                                               devices8):
    j, t = _pair(tmp_path, "memory", 4)
    try:
        for db in (j, t):
            db.sql("create table w (k int, s text) distributed by (k)")
            db.sql("insert into w values (1, 'a'), (2, 'b')")
        q = "select count(*) from w where s = 'new'"
        for text in (q, q, "insert into w values (3, 'new'), (4, 'new')", q,
                     "update w set s = 'newer' where k = 3", q,
                     "select count(*) from w where s = 'newer'"):
            _both(j, t, text)
        assert t.sql(q).rows() == [(1,)]
    finally:
        t.close()


def test_cap_hints_kept_before_an_insert_retry_exactly(tmp_path, devices8):
    """A join whose warm run kept exact cap hints, then an INSERT that
    grows its output past them: the overflow retry answers exactly."""
    j, t = _pair(tmp_path, "memory", 4)
    try:
        for db in (j, t):
            db.sql("create table a (k int, x int) distributed by (k)")
            db.sql("create table b (k int, y int) distributed by (y)")
            db.load_table("a", {"k": np.arange(2000),
                                "x": np.arange(2000) % 13})
            db.load_table("b", {"k": np.arange(0, 2000, 50),
                                "y": np.arange(40)})
        q = ("select a.x, count(*), sum(b.y) from a, b where a.k = b.k "
             "group by a.x order by a.x")
        _both(j, t, q)
        _both(j, t, q)
        for db in (j, t):
            db.load_table("b", {"k": np.arange(1, 2000, 3),
                                "y": np.arange(667) + 100})
        res = _both(j, t, q)
        _both(j, t, q)
        assert sum(r[1] for r in res.rows()) == 40 + 667
    finally:
        t.close()


def test_batch_serving_after_a_write(tmp_path, devices8):
    """A parameterised SELECT batched before and after a DELETE and an
    INSERT: the batch binds the plan of its store version."""
    j, t = _visimap_pair(tmp_path, "memory")
    t.sql("set batch_serving_enabled = on")
    try:
        def run(lo):
            return _both(j, t, f"select count(*), sum(v) from t "
                               f"where k >= {lo}")

        run(10)
        run(20)
        _both(j, t, "delete from t where k < 15000")
        run(10)
        _both(j, t, "insert into t values (5, 5, 5), (25, 25, 25)")
        run(10)
        run(20)
    finally:
        t.close()


# ---- Q1 after DML, through the fused path's plain version ---------------------

@pytest.mark.parametrize("mode", MODES)
def test_q1_after_dml_matches_jax(tmp_path, devices8, mode):
    j, t = _pair(tmp_path, mode, 8)
    try:
        for db in (j, t):
            db.settings.fused_dense_min_rows = 128
        ttpch.load(t, sf=0.002, tables=("lineitem",))
        jtpch.load(j, sf=0.002, tables=("lineitem",))
        csv = str(tmp_path / "li.csv")
        _both(j, t, "delete from lineitem where l_shipdate < "
                    "date '1993-01-01'")
        _both(j, t, "update lineitem set l_discount = l_discount + 0.01 "
                    "where l_orderkey % 100 = 0")
        _both(j, t, "insert into lineitem select * from lineitem "
                    "where l_orderkey % 1000 = 1")
        t.sql(f"copy lineitem to '{csv}'")
        n = t.sql("select count(*) from lineitem where l_orderkey < 300"
                  ).rows()[0][0]
        sub = str(tmp_path / "sub.csv")
        with open(csv) as f, open(sub, "w") as g:
            g.writelines(ln for ln in f if int(ln.split(",", 1)[0]) < 300)
        assert _both(j, t, f"copy lineitem from '{sub}'") == f"COPY {n}"
        before = fused_agg.LAUNCHES
        res = _both(j, t, TPCH22["q1"])
        assert res.stats["fused_gate"] and len(res)
        if mode == "directory":
            t.close()
            t = greengage_tpu_torch.connect(path=str(tmp_path / "t"),
                                            device="cpu")
            t.settings.fused_dense_min_rows = 128
            _both(j, t, TPCH22["q1"])
        assert t.vacuum("lineitem") == j.vacuum("lineitem")
        _both(j, t, TPCH22["q1"])
        assert fused_agg.LAUNCHES == before   # plain versions on the CPU
    finally:
        t.close()
