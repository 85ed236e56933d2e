"""The plan cache in the port against the JAX package on the same inputs.

(a) ``sql/paramize.paramize`` over every statement of the TPC-H and TPC-DS
    plan corpora equals the JAX function: the hoisted values and types and
    the parameterised statement (its signature, the plan-cache key).
(b) tests/test_plan_cache.py's statements replayed through both sessions:
    equal rows, equal ``plan_cache_hit`` / ``_miss`` counter deltas, equal
    ``stats["plan_cache"]``, and the LRU bound. The JAX test's compile
    counts have no counterpart (the port compiles no executable); its
    partitioned table's pinned partition-key literal and its LIMIT are
    replayed.
(c) Warm tiers: a statement whose group table overflows its estimate runs
    at the JAX package's ``tiers_used`` cold, warm and warm with another
    literal (the cap hints live under the plan cache's key), and the
    hints die with the statement's last bound plan.

Counters are read as deltas.
"""

import numpy as np
import pytest

import greengage_tpu
import greengage_tpu_torch
from greengage_tpu.analysis.plancorpus import TPCDS_QUERIES, TPCH_QUERIES
from greengage_tpu.runtime.logger import counters as jcounters
from greengage_tpu.sql.paramize import paramize as jparamize
from greengage_tpu.sql.parser import parse as jparse
from greengage_tpu.utils import tpcds as jtpcds
from greengage_tpu.utils import tpch as jtpch
from greengage_tpu_torch.runtime.logger import counters as tcounters
from greengage_tpu_torch.sql.paramize import paramize as tparamize
from greengage_tpu_torch.sql.parser import parse as tparse
from greengage_tpu_torch.utils import tpcds as ttpcds
from greengage_tpu_torch.utils import tpch as ttpch

PKGS = (("jax", greengage_tpu, {}),
        ("torch", greengage_tpu_torch, {"device": "cpu"}))
COUNTERS = {"jax": jcounters, "torch": tcounters}


# ---- (a) paramize over the corpora ---------------------------------------------

@pytest.fixture(scope="module")
def catalogs(devices8):
    out = {}
    for name, pkg, kw in PKGS:
        for suite, ddl in (("h", (jtpch if name == "jax" else ttpch).DDL),
                           ("ds", (jtpcds if name == "jax"
                                   else ttpcds).DDL)):
            d = pkg.connect(numsegments=8, **kw)
            d.sql(ddl)
            out[name, suite] = d.catalog
    return out


CORPUS = {**{"tpch:" + k: v for k, v in TPCH_QUERIES.items()},
          **{"tpcds:" + k: v for k, v in TPCDS_QUERIES.items()}}


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_paramize_equals_jax(catalogs, name):
    suite = "ds" if name.startswith("tpcds:") else "h"
    text = CORPUS[name]
    jn, jv, js = jparamize(jparse(text)[0], catalogs["jax", suite])
    tn, tv, ts = tparamize(tparse(text)[0], catalogs["torch", suite])
    assert ts == js
    assert repr(tn) == repr(jn)
    if jv is None:
        assert tv is None
    else:
        assert tv.values == jv.values
        assert repr(tv.types) == repr(jv.types)


# ---- (b) tests/test_plan_cache.py's statements ---------------------------------

@pytest.fixture()
def dbs(devices8):
    cols = {"k": np.arange(3000, dtype=np.int32),
            "a": np.arange(3000, dtype=np.int32),
            "v": np.arange(3000) * 0.5}
    out = {}
    for name, pkg, kw in PKGS:
        d = pkg.connect(numsegments=4, **kw)
        # both loops off: a feedback promotion re-plans a shape once,
        # which would perturb the exact hit counts pinned here
        # (tests/test_torch_feedback.py owns that interplay)
        d.sql("set cost_feedback = off")
        d.sql("create table t (k int, a int, v double precision) "
              "distributed by (k)")
        d.load_table("t", cols)
        out[name] = d
    yield out
    out["torch"].close()


def _replay(dbs, stmts):
    """Run ``stmts`` on both sessions -> {pkg: ([results], counter deltas
    of the plan cache)}."""
    out = {}
    for name, d in dbs.items():
        base = COUNTERS[name].snapshot()
        res = [d.sql(q) for q in stmts]
        delta = COUNTERS[name].since(base, "plan_cache_")
        out[name] = (res, delta)
    return out


def _assert_replay_equal(got):
    (jres, jd), (tres, td) = got["jax"], got["torch"]
    assert td == jd
    for j, t in zip(jres, tres):
        if isinstance(j, str):
            assert t == j
            continue
        assert t.rows() == j.rows()
        assert t.stats["plan_cache"] == j.stats["plan_cache"]


def test_repeated_shape_hits_the_plan_cache(dbs):
    got = _replay(dbs, ["select count(*) from t where a > 100",
                        "select count(*) from t where a > 2000",
                        "select count(*) from t where a > 100"])
    _assert_replay_equal(got)
    res, delta = got["torch"]
    assert [r.rows()[0][0] for r in res] == [2899, 999, 2899]
    assert delta == {"plan_cache_miss": 1, "plan_cache_hit": 2}
    assert res[1].stats["plan_cache"] == {"hit": True, "params": 1,
                                          "fallback": False}


def test_float_and_arith_literals_hoist(dbs):
    got = _replay(dbs, [
        "select k, v * 2.5 from t where v < 10.0 and a >= 3",
        "select k, v * 7.5 from t where v < 4.0 and a >= 1"])
    _assert_replay_equal(got)
    res, delta = got["torch"]
    assert len(res[0]) == 17 and len(res[1]) == 7
    assert delta.get("plan_cache_hit") == 1


def test_new_store_version_rebinds(dbs):
    q = "select count(*), sum(v) from t where a > 10"
    first = _replay(dbs, [q])
    for d in dbs.values():
        d.load_table("t", {"k": np.array([90001], dtype=np.int32),
                           "a": np.array([90001], dtype=np.int32),
                           "v": np.array([1.0])})
    again = _replay(dbs, [q])
    _assert_replay_equal(first)
    _assert_replay_equal(again)
    assert again["torch"][0][0].rows()[0][0] \
        == first["torch"][0][0].rows()[0][0] + 1
    assert again["torch"][1] == {"plan_cache_miss": 1}


def test_limit_stays_pinned(dbs):
    got = _replay(dbs, ["select k from t order by k limit 5",
                        "select k from t order by k limit 7"])
    _assert_replay_equal(got)
    res, delta = got["torch"]
    assert len(res[1]) == 7 and delta == {"plan_cache_miss": 2}


def test_partition_key_literal_stays_pinned(dbs):
    """tests/test_plan_cache.py (c): a partition key's literal is not
    hoisted, so static pruning stays value-exact (one child against two)
    and a changed value is another cache entry."""
    for d in dbs.values():
        d.sql("create table pt (d int, m int) distributed by (m) "
              "partition by range (d) "
              "(partition p1 start (0) end (100), "
              " partition p2 start (100) end (200))")
        d.load_table("pt", {"d": np.arange(200, dtype=np.int32),
                            "m": np.arange(200, dtype=np.int32)})
    got = _replay(dbs, ["select count(*) from pt where d < 50",
                        "select count(*) from pt where d < 150"])
    _assert_replay_equal(got)
    res, delta = got["torch"]
    assert [r.rows()[0][0] for r in res] == [50, 150]
    assert delta == {"plan_cache_miss": 2}
    assert [r.stats["partitions"]["pt"] for r in res] == [1, 2]


def test_distkey_equality_pinned(dbs):
    got = _replay(dbs, ["select v from t where k = 17",
                        "select v from t where k = 23"])
    _assert_replay_equal(got)
    res, _ = got["torch"]
    assert [r.rows()[0][0] for r in res] == [8.5, 11.5]
    assert res[1].stats["plan_cache"]["params"] == 0


def test_plan_cache_lru_and_hint_lifetime(dbs):
    stmts = ["set plan_cache_size = 2",
             "select count(*) from t where a > 1",          # shape A
             "select sum(v) from t where a > 2",            # shape B
             "select count(*) from t where a > 3",          # touch A (LRU)
             "select max(a) from t where v < 9.0",          # C evicts B
             "select count(*) from t where a > 4"]          # A again
    got = _replay(dbs, stmts)
    _assert_replay_equal(got)
    assert got["torch"][0][-1].stats["plan_cache"]["hit"] is True
    d = dbs["torch"]
    assert len(d._select_cache) <= 2
    live = {v[3] for v in d._select_cache.values()}
    assert set(d.executor._cap_hints) <= live


def test_plan_cache_params_off(dbs):
    got = _replay(dbs, ["set plan_cache_params = off",
                        "select count(*) from t where a > 7",
                        "select count(*) from t where a > 8",
                        "set plan_cache_params = on"])
    _assert_replay_equal(got)
    assert got["torch"][1] == {"plan_cache_miss": 2}


# ---- (c) warm tiers ---------------------------------------------------------------

def test_warm_runs_start_from_the_kept_counts(dbs):
    """Without ANALYZE the group table's estimate is the default, below
    the 1000 groups: the cold run overflows it and retries; a warm run,
    with the same or another literal, starts at the kept count."""
    q = "select a % 1000, count(*) from t where a > {} group by a % 1000"
    stmts = [q.format(10), q.format(10), q.format(20)]
    got = _replay(dbs, stmts)
    (jres, _), (tres, _) = got["jax"], got["torch"]
    for j, t in zip(jres, tres):
        assert sorted(t.rows()) == sorted(j.rows())
    tiers = [r.stats["tiers_used"] for r in tres]
    assert tiers == [r.stats["tiers_used"] for r in jres]
    assert tiers == [2, 1, 1]


def test_hints_die_with_the_last_bound_plan(dbs):
    d = dbs["torch"]
    d.sql("select a, count(*) from t where a > 10 group by a")
    assert len(d.executor._cap_hints) == 1
    d.sql("set plan_cache_size = 1")
    d.sql("select count(*) from t where a > 1")
    assert len(d._select_cache) == 1
    assert not d.executor._cap_hints
    d.sql("set plan_cache_size = 256")


def test_evicted_statement_seeded_from_the_feedback_store(dbs):
    """A statement whose bound plan (and with it its cap hints) left the
    cache starts at the feedback store's copy of its hints, in both
    packages: no overflow retry on its next run."""
    q = "select a % 1000, count(*) from t where a > 10 group by a % 1000"
    tiers = {}
    for name, d in dbs.items():
        first = d.sql(q)
        d.sql("set plan_cache_size = 1")
        d.sql("select count(*) from t where a > 1")      # evicts q's plan
        d.sql("set plan_cache_size = 256")
        again = d.sql(q)
        assert sorted(again.rows()) == sorted(first.rows())
        assert not again.stats["plan_cache"]["hit"]
        tiers[name] = (first.stats["tiers_used"], again.stats["tiers_used"])
    assert tiers["torch"] == tiers["jax"] == (2, 1)
