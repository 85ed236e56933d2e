"""WITH RECURSIVE in the port against the JAX package:
tests/test_recursive_cte.py replayed.

The session's fixpoint (``Database._select_recursive``) materialises each
recursive CTE in worktables it creates, loads, DELETEs from and drops, so
every test makes its own pair of databases (the JAX file's module-scoped
one would be written to by each statement) and holds each statement's
rows to the JAX package's, or its error to the same error.
"""

import pytest

import greengage_tpu
import greengage_tpu_torch
from greengage_tpu_torch.exec.executor import QueryError
from greengage_tpu_torch.sql.parser import SqlError
from torch_breadth import assert_rows_match

SETUP = (
    "create table edges (src int, dst int, w int) distributed by (src)",
    "insert into edges values (1,2,4),(2,3,1),(3,4,7),(2,5,2),(6,7,9)",
    "create table emp (id int, boss int, name text) distributed by (id)",
    "insert into emp values (1, null, 'ceo'), (2, 1, 'vp1'), (3, 1, 'vp2'), "
    "(4, 2, 'mgr'), (5, 4, 'eng'), (6, 4, 'eng2')",
)

CASES = {
    "series_generation": (
        "with recursive s(n) as (select 1 union all "
        "select n+1 from s where n < 100) "
        "select count(*), sum(n), min(n), max(n) from s"),
    "graph_reachability_union_dedupes": (
        "with recursive reach(node) as (select 1 union "
        "select dst from edges, reach where edges.src = reach.node) "
        "select node from reach order by node"),
    "hierarchy_with_depth_and_join": (
        "with recursive org(id, depth) as ("
        "  select id, 0 from emp where boss is null"
        "  union all"
        "  select emp.id, org.depth + 1 from emp, org where emp.boss = org.id"
        ") select emp.name, org.depth from org, emp "
        "where org.id = emp.id order by org.depth, emp.name"),
    "mixed_with_plain_cte": (
        "with recursive "
        "roots(node) as (select src from edges where src = 1), "
        "reach(node) as (select node from roots union "
        "  select dst from edges, reach where edges.src = reach.node) "
        "select count(*) from reach"),
    "weighted_paths_and_text": (
        "with recursive p(node, cost, path) as ("
        "  select 1, 0, 'n1' union all"
        "  select edges.dst, p.cost + edges.w, 'via' from edges, p"
        "  where edges.src = p.node) "
        "select node, cost, path from p order by node, cost"),
}


@pytest.fixture()
def pair(tmp_path, devices8):
    j = greengage_tpu.connect(numsegments=4)
    t = greengage_tpu_torch.connect(path=str(tmp_path / "t"), numsegments=4,
                                    device="cpu")
    for db in (j, t):
        for text in SETUP:
            db.sql(text)
    yield j, t
    t.close()


@pytest.mark.parametrize("case", sorted(CASES))
def test_recursive_statements_match_jax(pair, case):
    j, t = pair
    want = j.sql(CASES[case]).rows()
    assert want
    assert_rows_match(t.sql(CASES[case]).rows(), want, case)
    # the worktables went with the statement
    assert not [n for n in t.catalog.tables if n.startswith("__rec")]


def test_cycle_terminates_with_union(pair):
    j, t = pair
    for db in (j, t):
        db.sql("create table cyc (a int, b int) distributed by (a)")
        db.sql("insert into cyc values (1,2),(2,3),(3,1)")
    q = ("with recursive t(n) as (select 1 union "
         "select b from cyc, t where cyc.a = t.n) select count(*) from t")
    assert t.sql(q).rows() == j.sql(q).rows() == [(3,)]


def test_runaway_union_all_bounded(pair):
    """UNION ALL over a cycle never stops adding rows: the fixpoint stops
    at its iteration bound with the JAX package's error. The bound is 500
    in both packages; only the port's run is repeated here (the JAX
    file's own test runs its 500 iterations)."""
    _j, t = pair
    with pytest.raises(QueryError, match="exceeded 500 iterations"):
        t.sql("with recursive t(n) as (select 1 union all "
              "select n from t) select count(*) from t")
    assert not [n for n in t.catalog.tables if n.startswith("__rec")]


def test_self_ref_without_recursive_is_plain_table_ref(pair):
    for db in pair:
        with pytest.raises(Exception, match="t"):
            db.sql("with t(n) as (select 1 union all select n+1 from t) "
                   "select * from t")


def test_no_base_term_rejected(pair):
    for db in pair:
        with pytest.raises(SqlError if db is pair[1] else Exception,
                           match="non-recursive"):
            db.sql("with recursive t(n) as (select n from t union all "
                   "select n from t) select * from t")
