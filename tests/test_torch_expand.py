"""``Database.expand(n)`` in the port against the JAX package: every table
rewritten at a new width (gpexpand's redistribution), held to the JAX
package's rows, per-segment counts and pruning.

  * tests/test_visimap.py's expand case: the deletion bitmap goes, the
    live rows stay, in memory and in a directory (where the width also
    survives a reopen);
  * a partitioned table: every child re-placed, the parent's shared
    policy moved once, static pruning as before;
  * an indexed table: the index stays in the catalog, the rewritten files
    are indexed again and a probe prunes as the JAX package's does.

The port's segments are a leading tensor axis, so a new width is a new
layout: the executor's programs and stage cache go with the old one.
"""

import numpy as np
import pytest

import greengage_tpu
import greengage_tpu_torch
from torch_breadth import assert_rows_match

MODES = ("memory", "directory")


def _pair(tmp_path, mode, nseg):
    if mode == "memory":
        return (greengage_tpu.connect(numsegments=nseg),
                greengage_tpu_torch.connect(numsegments=nseg, device="cpu"))
    return (greengage_tpu.connect(str(tmp_path / "j"), numsegments=nseg),
            greengage_tpu_torch.connect(str(tmp_path / "t"),
                                        numsegments=nseg, device="cpu"))


def _both(j, t, text, prune=True):
    want, got = j.sql(text), t.sql(text)
    if isinstance(want, str):
        assert got == want, (text, got, want)
        return got
    assert_rows_match(got.rows(), want.rows(), text)
    if prune:
        assert got.stats.get("zone_prune", {}) \
            == want.stats.get("zone_prune", {}), text
    return got


def _masks(db, table):
    tmeta = db.store.manifest.snapshot()["tables"].get(table, {})
    return dict(tmeta.get("delmask", {}))


@pytest.mark.parametrize("mode", MODES)
def test_expand_drops_bitmap_and_keeps_live_rows(tmp_path, devices8, mode):
    j, t = _pair(tmp_path, mode, 4)
    try:
        for db in (j, t):
            db.sql("create table t (k int, v int) distributed by (k)")
            db.load_table("t", {"k": np.arange(5000), "v": np.arange(5000)})
        _both(j, t, "delete from t where k >= 1000")
        assert _masks(t, "t")
        assert t.expand(8) == j.expand(8) == {"t": 1000}
        assert t.numsegments == 8 and t.executor.nseg == 8
        assert _both(j, t, "select count(*) from t").rows() == [(1000,)]
        assert not _masks(t, "t") and not _masks(j, "t")
        assert t.store.segment_rowcounts("t") \
            == j.store.segment_rowcounts("t")
        _both(j, t, "select k, v from t where k < 20 order by k")
        _both(j, t, "insert into t values (7777, 1)")
        _both(j, t, "select count(*), sum(v) from t")
        if mode == "directory":
            t.close()
            t = greengage_tpu_torch.connect(str(tmp_path / "t"),
                                            device="cpu")
            assert t.numsegments == 8
            assert t.catalog.get("t").policy.numsegments == 8
            _both(j, t, "select count(*), sum(v) from t")
    finally:
        t.close()


@pytest.mark.parametrize("mode", MODES)
def test_expand_partitioned_table(tmp_path, devices8, mode):
    j, t = _pair(tmp_path, mode, 2)
    try:
        for db in (j, t):
            db.sql("create table m (k int, d int, x bigint) distributed by "
                   "(k) partition by range (d) (partition p start (0) end "
                   "(300) every (100), default partition rest)")
            db.load_table("m", {"k": np.arange(3000),
                                "d": np.arange(3000) % 400,
                                "x": np.arange(3000) * 7})
        _both(j, t, "update m set d = d + 1 where k % 10 = 0")
        assert t.expand(4) == j.expand(4)
        for p in ("p_1", "p_2", "p_3", "rest"):
            assert t.store.segment_rowcounts(f"m#{p}") \
                == j.store.segment_rowcounts(f"m#{p}")
            assert len(t.store.segment_rowcounts(f"m#{p}")) == 4
        r = _both(j, t, "select count(*), sum(x) from m where d < 100")
        assert r.stats["partitions"] == {"m": 2}
        _both(j, t, "select d, count(*) from m group by d order by d "
                    "limit 5")
    finally:
        t.close()


@pytest.mark.parametrize("mode", MODES)
def test_expand_indexed_table(tmp_path, devices8, mode):
    j, t = _pair(tmp_path, mode, 2)
    try:
        n = 280_000   # two blocks a segment after the expand
        k = np.random.default_rng(11).permutation(n).astype(np.int32)
        for db in (j, t):
            db.sql("create table s (k int, v int) distributed by (k)")
            db.load_table("s", {"k": k, "v": np.arange(n, dtype=np.int32)})
        _both(j, t, "create index s_k on s (k)")
        before = _both(j, t, "select v from s where k < 25 order by v")
        assert t.expand(4) == j.expand(4)
        assert "s_k" in t.catalog.get("s").indexes
        after = _both(j, t, "select v from s where k < 25 order by v")
        assert after.rows() == before.rows()
        r = _both(j, t, "select v from s where k = 4242")
        assert r.rows() == [(int(np.flatnonzero(k == 4242)[0]),)]
        kept, total = r.stats["zone_prune"]["s"]
        assert kept < total
    finally:
        t.close()
