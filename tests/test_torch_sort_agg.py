"""The port's sort-based grouping (greengage_tpu_torch/ops/agg.py:
group_sort, sorted_group_aggregate) against the JAX package's
(greengage_tpu/ops/agg.py), segment by segment, and GROUP BY statements
without a dense key domain — tests/test_sort_agg.py's shapes — against the
JAX package's rows.

Tolerances: permutations, run starts, int64 (scaled DECIMAL) sums, counts,
min and max must be equal. float64 sums may differ by relative 1e-12 (the
two scatters add in different orders); avg may differ by one ulp (XLA
divides by a reciprocal)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import greengage_tpu
import greengage_tpu_torch
from greengage_tpu import types as JT
from greengage_tpu.ops import agg as jagg
from greengage_tpu.utils import tpch as jtpch
from greengage_tpu_torch import types as TT
from greengage_tpu_torch.ops import agg as tagg
from greengage_tpu_torch.utils import tpch as ttpch

NSEG, N = 3, 900


def _keys(seed, packed):
    """Two keys: a nullable int64 with many duplicates and an int32, plus
    a selection; packed bounds cover every value."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-40, 40, (NSEG, N))
    a_valid = rng.random((NSEG, N)) >= 0.1
    b = rng.integers(0, 5, (NSEG, N)).astype(np.int32)
    sel = rng.random((NSEG, N)) < 0.8
    bounds = [(-40, 39), (0, 4)] if packed else None
    return [(a, a_valid, TT.INT64, JT.INT64), (b, None, TT.INT32, JT.INT32)], \
        sel, bounds


def _specs(keys, s=None):
    if s is None:
        return [tagg.KeySpec(torch.from_numpy(v),
                             None if m is None else torch.from_numpy(m), tt)
                for v, m, tt, _ in keys]
    return [jagg.KeySpec(jnp.asarray(v[s]),
                         None if m is None else jnp.asarray(m[s]), jt)
            for v, m, _, jt in keys]


@pytest.mark.parametrize("packed", [False, True])
def test_group_sort_matches_jax(packed):
    keys, sel, bounds = _keys(1, packed)
    perm, boundary, sel_sorted, viol = tagg.group_sort(
        _specs(keys), torch.from_numpy(sel), bounds)
    for s in range(NSEG):
        jperm, jb, jsel, jviol = jagg.group_sort(_specs(keys, s),
                                                jnp.asarray(sel[s]), bounds)
        assert np.array_equal(perm[s].numpy(), np.asarray(jperm))
        assert np.array_equal(boundary[s].numpy(), np.asarray(jb))
        assert np.array_equal(sel_sorted[s].numpy(), np.asarray(jsel))
        assert (jviol is None) == (viol is None) == (not packed)
    if packed:
        assert not bool(viol)


def test_group_sort_float_keys_group_zeros_and_nans():
    v = np.array([[1.5, -0.0, 0.0, np.nan, 2.5, np.nan, 1.5, -1.0]])
    sel = np.ones_like(v, dtype=bool)
    perm, boundary, _, _ = tagg.group_sort(
        [tagg.KeySpec(torch.from_numpy(v), None, TT.FLOAT64)],
        torch.from_numpy(sel))
    jperm, jb, _, _ = jagg.group_sort(
        [jagg.KeySpec(jnp.asarray(v[0]), None, JT.FLOAT64)], jnp.asarray(sel[0]))
    assert np.array_equal(perm[0].numpy(), np.asarray(jperm))
    assert np.array_equal(boundary[0].numpy(), np.asarray(jb))
    assert int(boundary.sum()) == 5     # -1.0, 0.0, 1.5, 2.5, NaN


def test_pack_violation_matches_jax():
    keys, sel, _ = _keys(2, True)
    bounds = [(-40, 20), (0, 4)]        # the first key reaches 39
    _, _, _, viol = tagg.group_sort(_specs(keys), torch.from_numpy(sel),
                                    bounds)
    jviol = [bool(jagg.group_sort(_specs(keys, s), jnp.asarray(sel[s]),
                                  bounds)[3]) for s in range(NSEG)]
    assert bool(viol) == any(jviol) is True


def _agg_specs(mod, cols, xp):
    v, fv, v_valid = xp(cols["v"]), xp(cols["f"]), xp(cols["valid"])
    A = mod.AggSpec
    return [A("cnt", "count_star", None, None),
            A("cnt_v", "count", v, v_valid),
            A("sum_v", "sum", v, v_valid),
            A("sum_f", "sum", fv, None),
            A("avg_v", "avg", v, v_valid, 2),
            A("min_v", "min", v, v_valid),
            A("max_v", "max", v, None),
            A("min_f", "min", fv, None),
            A("max_f", "max", fv, v_valid)]


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("out_cap", [32, 1024])
def test_sorted_group_aggregate_matches_jax(packed, out_cap):
    """int64 sums of scaled-decimal magnitude (limb split), float64 sums,
    counts, avg, min and max; out_cap 32 drops groups (the caller flags
    total > out_cap), 1024 takes the scatter form of the group starts and
    32 the binary search."""
    keys, sel, bounds = _keys(3, packed)
    rng = np.random.default_rng(4)
    cols = {"v": rng.integers(-10 ** 15, 10 ** 15, (NSEG, N)),
            "f": rng.random((NSEG, N)) * 1e6 - 2e5,
            "valid": rng.random((NSEG, N)) >= 0.2}
    perm, boundary, sel_sorted, _ = tagg.group_sort(
        _specs(keys), torch.from_numpy(sel), bounds)
    tspecs = [tagg.AggSpec(sp.name, sp.func,
                           None if sp.values is None
                           else sp.values.gather(1, perm),
                           None if sp.valid is None
                           else sp.valid.gather(1, perm), sp.decimal_scale)
              for sp in _agg_specs(tagg, cols, torch.from_numpy)]
    vals, valids, srcpos, total = tagg.sorted_group_aggregate(
        boundary, sel_sorted, tspecs, out_cap)
    for s in range(NSEG):
        jperm, jb, jsel, _ = jagg.group_sort(_specs(keys, s),
                                            jnp.asarray(sel[s]), bounds)
        jcols = {k: np.asarray(v[s])[np.asarray(jperm)]
                 for k, v in cols.items()}
        jvals, jvalids, jsrc, jtotal = jagg.sorted_group_aggregate(
            jb, jsel, _agg_specs(jagg, jcols, jnp.asarray), out_cap)
        assert int(total[s]) == int(jtotal)
        assert np.array_equal(srcpos[s].numpy(), np.asarray(jsrc))
        for name, jv in jvals.items():
            got, want = vals[name][s].numpy(), np.asarray(jv)
            if name == "sum_f":
                np.testing.assert_allclose(got, want, rtol=1e-12)
            elif name == "avg_v":
                np.testing.assert_array_max_ulp(got, want, maxulp=1)
            else:
                assert np.array_equal(got, want), name
            jm = jvalids.get(name)
            if jm is not None:
                assert np.array_equal(valids[name][s].numpy(),
                                      np.asarray(jm)), name
    assert int(total.max()) > 32


# ---- GROUP BY statements without a dense key domain -----------------------

@pytest.fixture(scope="module")
def dbs(devices8):
    jdb = greengage_tpu.connect(numsegments=8)
    jdb.sql("set cost_feedback = off")
    jtpch.load(jdb, sf=0.002)
    out = {"jax": jdb}
    for nseg in (1, 8):
        db = greengage_tpu_torch.connect(numsegments=nseg, device="cpu")
        ttpch.load(db, sf=0.002)
        out[nseg] = db
    nul = {"k": np.arange(5), "g": np.array([10, 10, 0, 0, 20]),
           "v": np.arange(1, 6)}
    flt = {"k": np.arange(5), "g": np.array([1.5, 1.5, -0.0, 0.0, 2.5]),
           "v": np.arange(1, 6)}
    for db in out.values():
        db.sql("create table nulg (k int, g int, v int) distributed by (k);"
               "create table fltg (k int, g float, v int) "
               "distributed by (k)")
        db.load_table("nulg", nul, {"g": np.array([1, 1, 0, 0, 1], bool)})
        db.load_table("fltg", flt)
    return out


GROUP_BYS = {
    "orderkey": ("select l_orderkey, count(*), sum(l_quantity), "
                 "min(l_discount), max(l_extendedprice) from lineitem "
                 "group by l_orderkey order by l_orderkey", ()),
    "two-phase suppkey": ("select l_suppkey, count(*), avg(l_quantity) "
                          "from lineitem group by l_suppkey "
                          "order by l_suppkey", (2,)),
    "text and int": ("select l_returnflag, l_suppkey, sum(l_extendedprice) "
                     "from lineitem group by l_returnflag, l_suppkey "
                     "order by l_returnflag, l_suppkey", ()),
    "nullable key": ("select g, count(*), sum(v) from nulg group by g "
                     "order by g", ()),
    "float key": ("select g, sum(v) from fltg group by g order by g", ()),
    "having": ("select l_orderkey, count(*) as n from lineitem "
               "group by l_orderkey having count(*) >= 6 "
               "order by l_orderkey", ()),
    "date key": ("select extract(year from o_orderdate) y, count(*), "
                 "sum(o_totalprice) from orders group by 1 order by 1", ()),
}


@pytest.mark.parametrize("nseg", [1, 8])
@pytest.mark.parametrize("name", sorted(GROUP_BYS))
def test_group_by_rows_equal_jax(dbs, name, nseg):
    text, avg_cols = GROUP_BYS[name]
    got = dbs[nseg].sql(text).rows()
    want = dbs["jax"].sql(text).rows()
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for i, (a, b) in enumerate(zip(g, w)):
            if i in avg_cols:
                assert abs(a - b) <= np.spacing(max(abs(a), abs(b)))
            else:
                assert a == b or (a != a and b != b), (name, i, a, b)


def test_group_count_overflow_retries_at_its_exact_count():
    """An un-analyzed table: the group-count estimate (4 sqrt(n)) sits far
    below the 5000 real groups, the group table overflows, and the retry
    sizes it from the exact count the device reported."""
    rng = np.random.default_rng(5)
    n = 20_000
    cols = {"k": np.arange(n), "g": rng.integers(0, 5000, n),
            "v": rng.integers(-100, 100, n)}
    jdb = greengage_tpu.connect(numsegments=4)
    tdb = greengage_tpu_torch.connect(numsegments=4, device="cpu")
    for db in (jdb, tdb):
        db.sql("create table gc (k bigint, g bigint, v bigint) "
               "distributed by (k)")
        db.load_table("gc", cols)
    q = "select g, count(*), sum(v) from gc group by g order by g"
    got = tdb.sql(q)
    assert got.stats["tiers_used"] > 1
    assert got.rows() == jdb.sql(q).rows()
    assert len(got) == len(np.unique(cols["g"]))


def test_group_pack_violation_after_an_append_reruns_unpacked():
    """Keys appended after ANALYZE fall outside the packed bounds: the
    group sort flags the violation and the retry runs unpacked at the same
    tier."""
    rng = np.random.default_rng(6)
    n = 4000
    cols = {"k": np.arange(n), "g": rng.integers(0, 100, n),
            "v": rng.integers(-100, 100, n)}
    more = {"k": np.arange(n, n + 50), "g": np.arange(1000, 1050),
            "v": np.ones(50, np.int64)}
    jdb = greengage_tpu.connect(numsegments=4)
    jdb.sql("set cost_feedback = off")
    tdb = greengage_tpu_torch.connect(numsegments=4, device="cpu")
    for db in (jdb, tdb):
        db.sql("create table gp (k bigint, g bigint, v bigint) "
               "distributed by (k)")
        db.load_table("gp", cols)
        db.sql("analyze gp")
        db.load_table("gp", more)
    q = "select g, count(*), sum(v) from gp group by g order by g"
    got = tdb.sql(q)
    assert got.stats["attempts"] == 2 and got.stats["tiers_used"] == 1
    assert got.rows() == jdb.sql(q).rows()
    assert got.rows()[-1] == (1049, 1, 1)
