"""Join-driven runtime partition elimination in the port against the JAX
package: tests/test_dynamic_prune.py replayed.

A partitioned probe joined on its partition key to a filtered small build
stages only the child partitions a surviving build key can land in (the
execution-time half of nodePartitionSelector.c). The port decides it on
the host before compiling (exec/executor.py ``_dyn_pruned_parts``), so the
staged capacity shrinks with it. Every case holds the rows and
``stats["dynamic_prune"]`` equal to the JAX package's; the module fixture
is read-only (in memory, 4 segments), the case that needs other tables
builds its own.
"""

import numpy as np
import pytest

import greengage_tpu
import greengage_tpu_torch
from torch_breadth import assert_rows_match


@pytest.fixture(scope="module")
def dbs(devices8):
    j = greengage_tpu.connect(numsegments=4)
    t = greengage_tpu_torch.connect(numsegments=4, device="cpu")
    n = 80_000
    rng = np.random.default_rng(5)
    fact = {"k": np.arange(n), "pd": rng.integers(0, 400, n),
            "v": rng.integers(0, 100, n)}
    for db in (j, t):
        db.sql("""create table fact (k int, pd int, v int) distributed by (k)
                  partition by range (pd)
                  (partition p0 start (0) end (100),
                   partition p1 start (100) end (200),
                   partition p2 start (200) end (300),
                   partition p3 start (300) end (400))""")
        db.load_table("fact", dict(fact))
        # dim: 400 keys, the category selects a narrow pd band
        db.sql("create table dim (pk int, cat int) distributed by (pk)")
        db.load_table("dim", {"pk": np.arange(400),
                              "cat": np.arange(400) // 100})
        db.sql("analyze")
    yield j, t
    t.close()


def _both(j, t, text):
    want, got = j.sql(text), t.sql(text)
    assert_rows_match(got.rows(), want.rows(), text)
    assert got.stats.get("dynamic_prune", {}) \
        == want.stats.get("dynamic_prune", {}), text
    return got


def test_build_filter_prunes_probe_partitions(dbs):
    j, t = dbs
    # cat = 2 selects pk in [200, 300): only partition p2 can match
    r = _both(j, t, "select count(*), sum(f.v) from fact f, dim d "
                    "where f.pd = d.pk and d.cat = 2")
    assert r.stats["dynamic_prune"].get("fact") == (1, 4), r.stats
    want = _both(j, t, "select count(*), sum(v) from fact "
                       "where pd >= 200 and pd < 300").rows()
    assert r.rows() == want


def test_no_build_filter_still_prunes_by_existing_keys(devices8):
    j = greengage_tpu.connect(numsegments=4)
    t = greengage_tpu_torch.connect(numsegments=4, device="cpu")
    try:
        for db in (j, t):
            db.sql("""create table f2 (k int, pd int) distributed by (k)
                      partition by range (pd)
                      (partition a start (0) end (50),
                       partition b start (50) end (100))""")
            db.load_table("f2", {"k": np.arange(1000),
                                 "pd": np.arange(1000) % 100})
            db.sql("create table d2 (pk int) distributed by (pk)")
            db.load_table("d2", {"pk": np.arange(10)})   # partition a only
            db.sql("analyze")
        r = _both(j, t, "select count(*) from f2, d2 where f2.pd = d2.pk")
        assert r.stats["dynamic_prune"].get("f2") == (1, 2), r.stats
        assert r.rows()[0][0] == 10 * 10
    finally:
        t.close()


def test_selection_is_cached_per_manifest_version(devices8):
    """The join-driven selection is the block cache's ``dyn`` member,
    tagged with its manifest version: a write to the dimension gives the
    next statement a new selection (held to the JAX package's), and the
    old version's entry goes."""
    j = greengage_tpu.connect(numsegments=2)
    t = greengage_tpu_torch.connect(numsegments=2, device="cpu")
    try:
        for db in (j, t):
            db.sql("""create table f3 (k int, pd int) distributed by (k)
                      partition by range (pd)
                      (partition a start (0) end (50),
                       partition b start (50) end (100))""")
            db.load_table("f3", {"k": np.arange(400),
                                 "pd": np.arange(400) % 100})
            db.sql("create table d3 (pk int) distributed by (pk)")
            db.load_table("d3", {"pk": np.arange(5)})
            db.sql("analyze")
        q = "select count(*) from f3, d3 where f3.pd = d3.pk"
        dyn = t.store.blockcache.cache("dyn")
        assert _both(j, t, q).stats["dynamic_prune"]["f3"] == (1, 2)
        v0 = t.store.manifest.snapshot()["version"]
        assert [k[3] for k in dyn] == [v0]
        for db in (j, t):
            db.sql("insert into d3 values (70)")
        assert _both(j, t, q).stats["dynamic_prune"]["f3"] == (2, 2)
        v1 = t.store.manifest.snapshot()["version"]
        assert v1 != v0 and [k[3] for k in dyn] == [v1]
    finally:
        t.close()


def test_left_join_never_prunes_probe(dbs):
    j, t = dbs
    r = _both(j, t, "select count(*) from fact f left join dim d "
                    "on f.pd = d.pk and d.cat = 2")
    assert "fact" not in r.stats.get("dynamic_prune", {}), r.stats
    assert r.rows()[0][0] == 80_000   # every probe row survives


def test_semi_join_prunes(dbs):
    j, t = dbs
    r = _both(j, t, "select count(*) from fact where pd in "
                    "(select pk from dim where cat = 0)")
    want = _both(j, t, "select count(*) from fact where pd < 100").rows()
    assert r.rows() == want
    dyn = r.stats.get("dynamic_prune", {})
    if "fact" in dyn:          # the semi-join shape reached the annotation
        assert dyn["fact"] == (1, 4)


def test_empty_build_filter_keeps_nothing_but_defaults(dbs):
    j, t = dbs
    r = _both(j, t, "select count(*) from fact f, dim d "
                    "where f.pd = d.pk and d.cat = 99")
    assert r.rows()[0][0] == 0
    assert r.stats["dynamic_prune"].get("fact") == (0, 4), r.stats


def test_static_and_dynamic_compose(dbs):
    # static prune (pd < 200 keeps p0, p1) AND the build filter (cat = 0
    # keeps p0): the intersection stages one child
    j, t = dbs
    r = _both(j, t, "select count(*) from fact f, dim d "
                    "where f.pd = d.pk and d.cat = 0 and f.pd < 200")
    want = _both(j, t, "select count(*) from fact where pd < 100").rows()
    assert r.rows() == want
    assert r.stats["dynamic_prune"].get("fact", (99, 99))[0] <= 1, r.stats


def test_explicit_join_syntax_also_prunes(dbs):
    """WHERE conjuncts sink below an explicit JOIN ... ON, so the build
    filter reaches the dim scan and the selector fires for this syntax
    too."""
    j, t = dbs
    r = _both(j, t, "select count(*), sum(f.v) from fact f join dim d "
                    "on f.pd = d.pk where d.cat = 2")
    assert r.stats["dynamic_prune"].get("fact") == (1, 4), r.stats
    want = _both(j, t, "select count(*), sum(v) from fact "
                       "where pd >= 200 and pd < 300").rows()
    assert r.rows() == want


def test_left_join_where_on_nullable_side_not_sunk(dbs):
    # WHERE d.cat = 2 on the NULLABLE side of a left join rejects the
    # null-extended rows: it stays above the join
    j, t = dbs
    r = _both(j, t, "select count(*) from fact f left join dim d "
                    "on f.pd = d.pk where d.cat = 2")
    want = _both(j, t, "select count(*) from fact where pd >= 200 and "
                       "pd < 300").rows()
    assert r.rows() == want


def test_explain_analyze_surfaces_runtime_pruning(dbs):
    j, t = dbs
    q = ("explain analyze select count(*) from fact f, dim d "
         "where f.pd = d.pk and d.cat = 2")
    line = "Dynamic partition selector fact: 1/4 children staged"
    assert line in j.sql(q).plan_text
    assert line in t.sql(q).plan_text
