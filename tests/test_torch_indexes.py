"""Secondary indexes (block-value indexes) in the port against the JAX
package: tests/test_indexes.py replayed.

CREATE INDEX registers the index in the catalog and builds, per data file
(per chunk in memory), the sorted (value, block) pairs; equality and range
scans stage only the blocks holding a matching value — block-selective
scans on unclustered data where zone maps keep everything. Every case
holds the rows and ``stats["zone_prune"]`` equal to the JAX package's.

The JAX file's 800,000-row table becomes 268,000 rows at 4 segments (two
blocks a segment, the second one small, which is what the pruning cases
need), and its 400,000-row tables 280,000: both packages load the same
cut. The module fixture holds the table the probes read; the cases that
load tables of their own build their own databases. The raw-TEXT case
(ROADMAP Queue 1 item 1e) pins the port's raise.
"""

import numpy as np
import pytest

import greengage_tpu
import greengage_tpu_torch
from greengage_tpu.sql.parser import SqlError as JSqlError
from greengage_tpu_torch import types as TT
from greengage_tpu_torch.planner.logical import describe
from greengage_tpu_torch.sql.parser import SqlError
from greengage_tpu_torch.sql.parser import parse as tparse
from torch_breadth import assert_rows_match

N = 268_000


@pytest.fixture(scope="module")
def dbs(devices8):
    j = greengage_tpu.connect(numsegments=4)
    t = greengage_tpu_torch.connect(numsegments=4, device="cpu")
    rng = np.random.default_rng(0)
    cols = {"k": rng.permutation(N).astype(np.int32),
            "v": np.arange(N, dtype=np.int32)}
    for db in (j, t):
        db.sql("create table t (k int, v int) distributed by (k)")
        db.load_table("t", dict(cols))
    yield j, t
    t.close()


def _both(j, t, text):
    want, got = j.sql(text), t.sql(text)
    if isinstance(want, str):
        assert got == want, (text, got, want)
        return got
    assert_rows_match(got.rows(), want.rows(), text)
    assert got.stats.get("zone_prune", {}) == want.stats.get("zone_prune",
                                                             {}), text
    return got


def _raises_both(j, t, text, match):
    with pytest.raises((JSqlError, ValueError), match=match):
        j.sql(text)
    with pytest.raises((SqlError, ValueError), match=match):
        t.sql(text)


def test_index_prunes_unclustered_equality(dbs):
    j, t = dbs
    before = _both(j, t, "select v from t where k = 12345")
    _both(j, t, "create index t_k on t (k)")
    try:
        after = _both(j, t, "select v from t where k = 12345")
        assert after.rows() == before.rows()
        bk, bt = before.stats["zone_prune"]["t"]
        ak, at = after.stats["zone_prune"]["t"]
        assert bk == bt            # zone maps keep everything (unclustered)
        assert ak < at             # the index prunes
        assert after.stats["index_hits"] == {"t": 1}
    finally:
        _both(j, t, "drop index t_k")


def test_index_correct_across_many_probes(dbs):
    j, t = dbs
    _both(j, t, "create index t_k2 on t (k)")
    try:
        for k in np.random.default_rng(7).integers(0, N, 5):
            assert len(_both(j, t, f"select v from t where k = {int(k)}")) \
                == 1
        assert _both(j, t, "select v from t where k = -5").rows() == []
    finally:
        _both(j, t, "drop index t_k2")


def _own(nseg=4, path=None):
    if path is None:
        return (greengage_tpu.connect(numsegments=nseg),
                greengage_tpu_torch.connect(numsegments=nseg, device="cpu"))
    return (greengage_tpu.connect(path=str(path / "j"), numsegments=nseg),
            greengage_tpu_torch.connect(path=str(path / "t"),
                                        numsegments=nseg, device="cpu"))


def test_bitmap_low_ndv(devices8):
    j, t = _own()
    try:
        code = np.ones(280_000, np.int32)
        code[-1] = 7
        for db in (j, t):
            db.sql("create table ev (k int, code int) distributed by (k)")
            db.load_table("ev", {"k": np.arange(280_000, dtype=np.int32),
                                 "code": code})
        _both(j, t, "create index ev_code on ev using bitmap (code)")
        r = _both(j, t, "select k from ev where code = 7")
        assert r.rows() == [(279_999,)]
        kept, total = r.stats["zone_prune"]["ev"]
        assert kept < total
    finally:
        t.close()


@pytest.mark.parametrize("mode", ["memory", "directory"])
def test_index_survives_reopen_and_new_inserts(tmp_path, devices8, mode):
    """A directory keeps the index (catalog.json) and its sidecars across
    a reopen; files written after CREATE INDEX are indexed lazily. In
    memory the same statements run without the reopen."""
    j, t = _own(4, tmp_path if mode == "directory" else None)
    try:
        rng = np.random.default_rng(3)
        cols = {"k": rng.permutation(100_000).astype(np.int32),
                "v": np.zeros(100_000, np.int32)}
        for db in (j, t):
            db.sql("create table s (k int, v int) distributed by (k)")
            db.load_table("s", dict(cols))
        _both(j, t, "create index s_k on s (k)")
        if mode == "directory":
            t.close()
            j = greengage_tpu.connect(path=str(tmp_path / "j"))
            t = greengage_tpu_torch.connect(path=str(tmp_path / "t"),
                                            device="cpu")
            assert "s_k" in t.catalog.get("s").indexes
            snap = t.store.manifest.snapshot()
            rels = [r for f in snap["tables"]["s"]["segfiles"].values()
                    for r in f if r.startswith("seg") and "/k." in r]
            import os
            assert all(os.path.exists(os.path.join(
                str(tmp_path / "t"), "data", "s",
                r[:-len(".ggb")] + ".bidx.npz")) for r in rels)
        _both(j, t, "insert into s values (1000001, 42)")
        r = _both(j, t, "select v from s where k = 1000001")
        assert r.rows() == [(42,)]
        _both(j, t, "select count(*) from s where k < 500")
    finally:
        t.close()


def test_index_ddl_errors(dbs):
    j, t = dbs
    _both(j, t, "create index dup_i on t (k)")
    try:
        _raises_both(j, t, "create index dup_i on t (v)", "already exists")
        _both(j, t, "create index if not exists dup_i on t (v)")   # no-op
        _raises_both(j, t, "create index h on t using hash (k)",
                     "access method")
        _raises_both(j, t, "drop index nope", "does not exist")
        _both(j, t, "drop index if exists nope")
    finally:
        _both(j, t, "drop index dup_i")


def test_raw_column_not_indexable(devices8):
    """Raw-encoded TEXT is ROADMAP Queue 1 item 1e in the port: the load
    the JAX case indexes raises naming it."""
    t = greengage_tpu_torch.connect(numsegments=4, device="cpu")
    try:
        t.sql("create table rr (a int, c text) distributed by (a)")
        object.__setattr__(t.catalog.get("rr").column("c"), "encoding",
                           "raw")
        with pytest.raises(NotImplementedError, match="item 1e"):
            t.load_table("rr", {"a": np.array([1], np.int32),
                                "c": np.array(["x"], dtype=object)})
    finally:
        t.close()


def test_text_index_prunes(devices8):
    j, t = _own()
    try:
        n = 280_000
        tags = np.array(["common"] * n, dtype=object)
        tags[123_456] = "needle"
        codes = (tags == "needle").astype(np.int32)
        for db, mod in ((j, greengage_tpu.types), (t, TT)):
            db.sql("create table tx (k int, tag text) distributed by (k)")
            db.load_table("tx", {"k": np.arange(n, dtype=np.int32),
                                 "tag": mod.Coded(["common", "needle"],
                                                  codes)})
        _both(j, t, "create index tx_tag on tx (tag)")
        r = _both(j, t, "select k from tx where tag = 'needle'")
        assert r.rows() == [(123_456,)]
        kept, total = r.stats["zone_prune"]["tx"]
        assert kept < total
        # an absent literal: code -1 prunes everything
        assert _both(j, t, "select k from tx where tag = 'ghost'").rows() \
            == []
    finally:
        t.close()


@pytest.mark.parametrize("mode", ["memory", "directory"])
def test_index_with_dml(tmp_path, devices8, mode):
    j, t = _own(4, tmp_path if mode == "directory" else None)
    try:
        for db in (j, t):
            db.sql("create table u (k int, v int) distributed by (k)")
            db.load_table("u", {"k": np.arange(100_000, dtype=np.int32),
                                "v": np.arange(100_000, dtype=np.int32)})
        _both(j, t, "create index u_k on u (k)")
        _both(j, t, "update u set v = 0 where k = 77")
        _both(j, t, "delete from u where k = 99")
        assert _both(j, t, "select v from u where k = 77").rows() == [(0,)]
        assert _both(j, t, "select v from u where k = 99").rows() == []
        assert _both(j, t, "select count(*) from u").rows() == [(99_999,)]
        t.vacuum()
        j.vacuum()
        assert _both(j, t, "select v from u where k = 77").rows() == [(0,)]
    finally:
        t.close()


def test_index_range_probe_prunes(dbs):
    """Range ops probe the sorted (value, block) run (the btree range
    scan, _bt_first)."""
    j, t = dbs
    _both(j, t, "create index t_k3 on t (k)")
    try:
        r = _both(j, t, "select count(*) from t where k < 40")
        assert r.rows()[0][0] == 40
        kept, total = r.stats["zone_prune"]["t"]
        assert kept < total, (kept, total)
        r = _both(j, t, f"select count(*) from t where k >= {N - 40}")
        assert r.rows()[0][0] == 40
        kept, total = r.stats["zone_prune"]["t"]
        assert kept < total, (kept, total)
        # a wide range keeps everything on unclustered data
        r = _both(j, t, "select count(*) from t where k >= 10")
        assert r.rows()[0][0] == N - 10
    finally:
        _both(j, t, "drop index t_k3")


def test_explain_shows_index_access_path(dbs):
    j, t = dbs
    _both(j, t, "create index t_k4 on t (k)")
    try:
        for q in ("select v from t where k = 5", "select v from t where k < 9"):
            planned, _, _ = t._plan(tparse(q)[0])
            assert "(index: t_k4)" in describe(planned)
            assert "(index: t_k4)" in t.sql("explain " + q).plan_text
            assert "(index: t_k4)" in str(j.sql("explain " + q))
    finally:
        _both(j, t, "drop index t_k4")
    planned, _, _ = t._plan(tparse("select v from t where k = 5")[0])
    assert "(index:" not in describe(planned)
