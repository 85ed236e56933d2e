"""The port's plan validation (greengage_tpu_torch/analysis/plancheck.py)
against the JAX package's (greengage_tpu/analysis/plancheck.py).

  * every plan of the TPC-H and TPC-DS plan corpora validates in both
    packages (TPC-H SF 0.005 and tests/test_analysis.py's TPC-DS mini star
    schema, copied into the port with tests/torch_breadth.py's mirror);
  * the broken plans of tests/test_analysis.py (a dropped state Motion, a
    join side hashed on the wrong key, an interior Gather, a prune
    predicate over no column, an ordered-global window without its key
    spec or over its 64-bit budget, a global window above a funnel, a
    range window without its range Motion, a range Motion landing hashed)
    raise the same ``PlanInvariantError`` in both: the same invariant and
    the same node path;
  * the ``plan_validate`` hook of tests/test_analysis.py's
    ``test_plan_validate_guc_hook``: on, planning runs the validator; off,
    it does not; and a spill bucket plan is validated too.

Both packages plan with their feedback loops off, so the two planners see
the same statistics (tests/test_torch_sql.py).
"""

import types

import numpy as np
import pytest

import greengage_tpu
import greengage_tpu_torch
from greengage_tpu import expr as JE
from greengage_tpu import types as JT
from greengage_tpu.analysis import plancheck as jcheck
from greengage_tpu.analysis.plancorpus import (TPCDS_QUERIES, TPCH_QUERIES,
                                               load_tpcds_mini)
from greengage_tpu.planner import locus as jlocus
from greengage_tpu.planner import logical as jlogical
from greengage_tpu.sql.parser import parse as jparse
from greengage_tpu.utils import tpch as jtpch
from greengage_tpu_torch import expr as TE
from greengage_tpu_torch import types as TT
from greengage_tpu_torch.analysis import plancheck as tcheck
from greengage_tpu_torch.planner import locus as tlocus
from greengage_tpu_torch.planner import logical as tlogical
from greengage_tpu_torch.sql.parser import parse as tparse
from greengage_tpu_torch.utils import tpch as ttpch
from torch_breadth import mirror

SF = 0.005

JAX = types.SimpleNamespace(E=JE, T=JT, check=jcheck, L=jlocus, P=jlogical,
                            parse=jparse)
PORT = types.SimpleNamespace(E=TE, T=TT, check=tcheck, L=tlocus, P=tlogical,
                             parse=tparse)


@pytest.fixture(scope="module")
def dbs(devices8):
    j = greengage_tpu.connect(numsegments=8)
    t = greengage_tpu_torch.connect(numsegments=8, device="cpu")
    for d in (j, t):
        d.sql("set cost_feedback = off")
    jtpch.load(j, sf=SF)
    ttpch.load(t, sf=SF)
    for d in (j, t):
        d.sql("analyze")
    yield {"jax": (j, JAX), "port": (t, PORT)}
    j.close()
    t.close()


@pytest.fixture(scope="module")
def dsdbs(devices8):
    j = greengage_tpu.connect(numsegments=8)
    j.sql("set cost_feedback = off")
    load_tpcds_mini(j, n_fact=5_000)
    t = greengage_tpu_torch.connect(numsegments=8, device="cpu")
    t.sql("set cost_feedback = off")
    mirror(j, t)
    yield {"jax": (j, JAX), "port": (t, PORT)}
    j.close()
    t.close()


def _find(plan, pred):
    stack = [plan]
    while stack:
        p = stack.pop()
        if pred(p):
            return p
        stack.extend(p.children)
    return None


@pytest.mark.parametrize("side", ["jax", "port"])
@pytest.mark.parametrize("name", sorted(TPCH_QUERIES))
def test_tpch_corpus_plan_validates(dbs, side, name):
    d, m = dbs[side]
    planned, _c, _o = d._plan(m.parse(TPCH_QUERIES[name])[0])
    m.check.validate_plan(planned, d.catalog)


@pytest.mark.parametrize("side", ["jax", "port"])
@pytest.mark.parametrize("name", sorted(TPCDS_QUERIES))
def test_tpcds_corpus_plan_validates(dsdbs, side, name):
    d, m = dsdbs[side]
    planned, _c, _o = d._plan(m.parse(TPCDS_QUERIES[name])[0])
    m.check.validate_plan(planned, d.catalog)


# ---- the broken plans of tests/test_analysis.py ---------------------------
# each takes (Database, modules) and returns the broken plan

def _dropped_motion(d, m):
    planned, _, _ = d._plan(m.parse(TPCH_QUERIES["q1_pricing_summary"])[0])
    final = _find(planned, lambda p: isinstance(p, m.P.Aggregate)
                  and p.phase == "final")
    final.child = final.child.child
    return planned


def _wrong_dist_key(d, m):
    planned, _, _ = d._plan(m.parse(TPCH_QUERIES["q3_shipping_priority"])[0])
    hashed = m.L.LocusKind.HASHED
    join = _find(planned, lambda p: isinstance(p, m.P.Join)
                 and p.left.locus is not None and p.right.locus is not None
                 and p.left.locus.kind is hashed
                 and p.right.locus.kind is hashed)
    other = [c.id for c in join.right.out_cols()
             if c.id not in join.right.locus.keys]
    join.right.locus = m.L.Locus.hashed((other[0],),
                                        join.right.locus.numsegments)
    return planned


def _interior_gather(d, m):
    planned, _, _ = d._plan(m.parse(TPCH_QUERIES["q1_pricing_summary"])[0])
    final = _find(planned, lambda p: isinstance(p, m.P.Aggregate)
                  and p.phase == "final")
    funnel = m.P.Motion(m.P.MotionKind.GATHER, final.child)
    funnel.locus = m.L.Locus.entry()
    funnel.est_rows = final.child.est_rows
    final.child = funnel
    return planned


def _bad_prune(d, m):
    planned, _, _ = d._plan(
        m.parse("select count(*) from orders where o_orderkey > 7")[0])
    scan = _find(planned, lambda p: getattr(p, "prune_preds", ()))
    scan.prune_preds = (("no_such_column", ">", 7),)
    return planned


_ORDERED = ("select o_orderkey, ntile(4) over (order by o_orderkey) nt "
            "from orders")
_RANGE = ("select o_orderkey, sum(o_totalprice) over "
          "(order by o_totalprice, o_orderkey) rs from orders")


def _ordered_without_spec(d, m):
    planned, _, _ = d._plan(m.parse(_ORDERED)[0])
    win = _find(planned, lambda p: isinstance(p, m.P.Window))
    assert win.global_mode == "ordered"
    win.gkey_spec = None
    return planned


def _ordered_over_budget(d, m):
    planned, _, _ = d._plan(m.parse(_ORDERED)[0])
    win = _find(planned, lambda p: isinstance(p, m.P.Window))
    spec = win.gkey_spec
    win.gkey_spec = {"mode": "packed",
                     "fields": [dict(f, bits=40) for f in spec["fields"]]
                     + [dict(spec["fields"][0], bits=40)]}
    return planned


def _global_above_funnel(d, m):
    planned, _, _ = d._plan(m.parse(_ORDERED)[0])
    win = _find(planned, lambda p: isinstance(p, m.P.Window))
    funnel = m.P.Motion(m.P.MotionKind.REDISTRIBUTE, win.child,
                        hash_exprs=[m.E.Literal(0, m.T.INT64)])
    funnel.locus = m.L.Locus(m.L.LocusKind.SINGLE_QE, (), d.numsegments)
    funnel.est_rows = win.child.est_rows
    win.child = funnel
    return planned


def _range_without_motion(d, m):
    planned, _, _ = d._plan(m.parse(_RANGE)[0])
    win = _find(planned, lambda p: isinstance(p, m.P.Window))
    assert win.global_mode == "range"
    win.child = win.child.child
    return planned


def _range_motion_hashed(d, m):
    planned, _, _ = d._plan(m.parse(_RANGE)[0])
    win = _find(planned, lambda p: isinstance(p, m.P.Window))
    moved = win.child
    assert moved.range_spec is not None
    moved.locus = m.L.Locus.hashed((moved.hash_exprs[0].name,),
                                   d.numsegments)
    return planned


BROKEN = {
    "dropped_motion": (_dropped_motion, "I5"),
    "wrong_dist_key": (_wrong_dist_key, "I4"),
    "interior_gather": (_interior_gather, "I3"),
    "bad_prune_predicate": (_bad_prune, "I6"),
    "ordered_global_without_spec": (_ordered_without_spec, "I5"),
    "ordered_global_over_budget": (_ordered_over_budget, "I5"),
    "global_window_above_funnel": (_global_above_funnel, "I3"),
    "range_window_without_range_motion": (_range_without_motion, "I5"),
    "range_motion_landing_hashed": (_range_motion_hashed, "I2"),
}


@pytest.mark.parametrize("name", sorted(BROKEN))
def test_broken_plan_raises_the_same_error(dbs, name):
    breaker, invariant = BROKEN[name]
    seen = {}
    for side in ("jax", "port"):
        d, m = dbs[side]
        planned = breaker(d, m)
        with pytest.raises(m.check.PlanInvariantError) as ei:
            m.check.validate_plan(planned, d.catalog)
        seen[side] = (ei.value.invariant, ei.value.path)
    assert seen["jax"] == seen["port"]
    assert seen["port"][0] == invariant


def test_plan_validate_guc_hook(dbs, monkeypatch):
    """tests/test_analysis.py::test_plan_validate_guc_hook on the port."""
    import greengage_tpu_torch.exec.session as S

    d, _m = dbs["port"]
    calls = []
    orig = S.validate_plan
    monkeypatch.setattr(
        S, "validate_plan",
        lambda p, cat=None: (calls.append(1), orig(p, cat))[1])
    d.sql("select count(*) + 17 from region")   # unique: forces a plan
    assert calls, "plan_validate on: _plan must run the validator"
    calls.clear()
    d.sql("select count(*) + 17 from region")   # a plan-cache hit
    assert not calls
    d.sql("set plan_validate = off")
    try:
        d.sql("select count(*) + 18 from region")
        assert not calls, "plan_validate off: validator must not run"
    finally:
        d.sql("set plan_validate = on")
    assert d.sql("show plan_validate") == "True"


def test_spill_bucket_plans_are_validated(monkeypatch):
    """A window spilled in partition buckets validates its bucket plan, as
    the JAX spill does (greengage_tpu/exec/spill.py)."""
    import greengage_tpu_torch.exec.spill as SP

    calls = []
    orig = SP.validate_plan
    monkeypatch.setattr(
        SP, "validate_plan",
        lambda p, cat=None: (calls.append(p), orig(p, cat))[1])
    d = greengage_tpu_torch.connect(numsegments=4, device="cpu")
    try:
        n = 200_000
        d.sql("create table ws (k int, g int, v int) distributed by (k)")
        d.load_table("ws", {"k": np.arange(n), "g": np.arange(n) % 97,
                            "v": np.arange(n) % 13})
        d.sql("analyze")
        d.sql("set vmem_protect_limit_mb = 3")
        r = d.sql("select g, v, rank() over (partition by g order by v) rk "
                  "from ws")
        assert r.stats.get("spill_kind") == "window"
        assert len(r) == n
        assert calls, "the bucket plan must be validated"
    finally:
        d.close()
