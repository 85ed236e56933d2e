"""All 22 TPC-H statements through the port against the JAX package.

The texts are the port's copies (``greengage_tpu_torch.utils.plancorpus.
TPCH22``), each held equal, whitespace normalised, to the JAX package's
own text: tests/test_tpch_full.py, test_tpch_more.py and test_subqueries.py
(read with ``ast``), bench.py's Q5 and the JAX plan corpus's Q1, Q3 and Q6.
Both packages load TPC-H SF 0.02 from the same generator onto 4 segments
(tests/test_tpch_full.py's data), both analyzed, with their feedback loops
off so the two planners see the same statistics; every statement's rows
must match (tests/torch_breadth.py: integers, DECIMAL, dates and text
exactly, float64 within 1e-12 relative), and every plan of both packages
passes its ``validate_plan``.
"""

import ast
import os
import re

import numpy as np
import pytest

import greengage_tpu
import greengage_tpu_torch
from greengage_tpu.analysis.plancheck import validate_plan as jvalidate
from greengage_tpu.analysis.plancorpus import TPCH_QUERIES as J_CORPUS
from greengage_tpu.sql.parser import parse as jparse
from greengage_tpu.utils import tpch as jtpch
from greengage_tpu_torch.analysis.plancheck import validate_plan as tvalidate
from greengage_tpu_torch.sql.parser import parse as tparse
from greengage_tpu_torch.utils import tpch as ttpch
from greengage_tpu_torch.utils.plancorpus import TPCH22
from torch_breadth import assert_rows_match

SF = 0.02
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# where the JAX package keeps each text: (file, test function) or the
# corpus / bench.py
SOURCES = {
    "q1": ("corpus", "q1_pricing_summary"),
    "q3": ("corpus", "q3_shipping_priority"),
    "q6": ("corpus", "q6_forecast_revenue"),
    "q5": ("bench", "Q5"),
    "q4": ("test_subqueries.py", "test_tpch_q4_order_priority"),
    "q17": ("test_subqueries.py", "test_tpch_q17_correlated_scalar"),
    "q10": ("test_tpch_more.py", "test_q10_returned_item_reporting"),
    "q12": ("test_tpch_more.py", "test_q12_shipmode_priority"),
    "q13": ("test_tpch_more.py", "test_q13_customer_distribution"),
    "q14": ("test_tpch_more.py", "test_q14_promo_effect"),
    "q19": ("test_tpch_more.py", "test_q19_discounted_revenue"),
    "q2": ("test_tpch_full.py", "test_q2_min_cost_supplier"),
    "q7": ("test_tpch_full.py", "test_q7_volume_shipping"),
    "q8": ("test_tpch_full.py", "test_q8_market_share"),
    "q9": ("test_tpch_full.py", "test_q9_product_type_profit"),
    "q11": ("test_tpch_full.py", "test_q11_important_stock"),
    "q15": ("test_tpch_full.py", "test_q15_top_supplier_cte"),
    "q16": ("test_tpch_full.py", "test_q16_supplier_count_distinct"),
    "q18": ("test_tpch_full.py", "test_q18_large_volume_customer"),
    "q20": ("test_tpch_full.py", "test_q20_potential_part_promotion"),
    "q21": ("test_tpch_full.py",
            "test_q21_suppliers_who_kept_orders_waiting"),
    "q22": ("test_tpch_full.py", "test_q22_global_sales_opportunity"),
}
NAMES = sorted(TPCH22, key=lambda k: int(k[1:]))


def _jax_text(name: str) -> str:
    where, what = SOURCES[name]
    if where == "corpus":
        return J_CORPUS[what]
    path = (os.path.join(ROOT, "bench.py") if where == "bench"
            else os.path.join(HERE, where))
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if where == "bench" and isinstance(node, ast.Assign) \
                and getattr(node.targets[0], "id", None) == what:
            return node.value.value
        if isinstance(node, ast.FunctionDef) and node.name == what:
            for c in ast.walk(node):
                if isinstance(c, ast.Call) \
                        and isinstance(c.func, ast.Attribute) \
                        and c.func.attr == "sql":
                    return c.args[0].value
    raise AssertionError(f"{name}: no text at {where}:{what}")


def _ws(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


@pytest.fixture(scope="module")
def jdb(devices8):
    d = greengage_tpu.connect(numsegments=4)
    d.sql("set cost_feedback = off")
    jtpch.load(d, SF)
    d.sql("analyze")
    yield d
    d.close()


@pytest.fixture(scope="module")
def tdb():
    d = greengage_tpu_torch.connect(numsegments=4, device="cpu")
    d.sql("set cost_feedback = off")
    ttpch.load(d, SF)
    d.sql("analyze")
    yield d
    d.close()


def test_the_port_has_all_22_statements():
    assert NAMES == [f"q{i}" for i in range(1, 23)]
    assert set(SOURCES) == set(TPCH22)


@pytest.mark.parametrize("name", NAMES)
def test_tpch22_text_equals_the_jax_text(name):
    assert _ws(TPCH22[name]) == _ws(_jax_text(name))


@pytest.mark.parametrize("name", NAMES)
def test_tpch22_rows_equal_jax(jdb, tdb, name):
    want = jdb.sql(TPCH22[name]).rows()
    got = tdb.sql(TPCH22[name]).rows()
    assert_rows_match(got, want, name)


@pytest.mark.parametrize("name", NAMES)
def test_tpch22_plans_validate_in_both(jdb, tdb, name):
    jplanned, _c, _o = jdb._plan(jparse(TPCH22[name])[0])
    jvalidate(jplanned, jdb.catalog)
    tplanned, _c, _o = tdb._plan(tparse(TPCH22[name])[0])
    tvalidate(tplanned, tdb.catalog)


# the statements chip_smoke.py's tpch22 phases see refused on the card:
# "multi" = the multi-match re-plan passes the ceiling (Q8, Q9 and Q21 at
# SF 1), "unique" = the first plan does (Q7, Q8, Q18, Q21 at SF10)
# (statement, the plan refused, the first plan's estimate over the
# ceiling): the ceiling this scale needs for the refusal the card meets
PAST_CEILING = [("q7", "unique", 64), ("q18", "unique", 2),
                ("q21", "unique", 2), ("q8", "multi", None),
                ("q9", "multi", None)]


def _coded(cols: dict, coded_cls) -> dict:
    """Generated columns with every text column a dictionary column of
    ``coded_cls`` (sorted vocabulary): a unique name per row would load as
    raw TEXT, which the port does not hold (ROADMAP Queue 1 item 1e)."""
    out = {}
    for k, v in cols.items():
        if isinstance(v, list):
            vocab, codes = np.unique(np.asarray(v, dtype=object),
                                     return_inverse=True)
            v = coded_cls(list(vocab), codes.astype(np.int32))
        elif hasattr(v, "vocab"):
            v = coded_cls(list(v.vocab), v.codes)
        out[k] = v
    return out


@pytest.fixture(scope="module")
def multi_dbs(devices8):
    """SF 0.05 on 8 segments, where Q8's and Q9's unique-key joins meet
    duplicate build keys in both packages."""
    from greengage_tpu import types as JT
    from greengage_tpu_torch import types as TT

    data = ttpch.generate(0.05)
    j = greengage_tpu.connect(numsegments=8)
    t = greengage_tpu_torch.connect(numsegments=8, device="cpu")
    for d, cls, ddl in ((j, JT.Coded, jtpch.DDL), (t, TT.Coded, ttpch.DDL)):
        d.sql("set cost_feedback = off")
        d.sql(ddl)
        for table, cols in data.items():
            d.load_table(table, _coded(cols, cls))
        d.sql("analyze")
    yield j, t
    t.close()
    j.close()


@pytest.mark.parametrize("name,plan,over", PAST_CEILING)
def test_a_statement_past_the_ceiling_is_not_spillable_in_both(
        multi_dbs, name, plan, over):
    """ROADMAP Queue 3 item 13 (shared): these TPC-H shapes have no
    partial-aggregate cut or sort to spill by. Past the ceiling both
    packages raise the same QueryError, with the same estimate: under a
    ceiling between the unique-key plan's estimate and its multi-match
    re-plan's ("multi": Q8 and Q9 meet duplicate build keys at this
    scale, and their re-plans are estimated from item 12's runaway join
    estimates), or below the first plan's ("unique"). On the card the
    ceiling is its memory over the segments (10 GB at 8): at SF 1 the
    re-plans of Q8, Q9 and Q21 are estimated at 31, 56 and 17.6 GB a
    segment; at SF10 the first plans of Q7, Q8, Q18 and Q21 at 15.2, 15.1,
    27.4 and 11.5 GB."""
    from greengage_tpu.exec.executor import QueryError as JQueryError
    from greengage_tpu_torch.exec.executor import QueryError

    jdb, tdb = multi_dbs
    text = TPCH22[name]
    est = {}
    for multi in (False, True):
        planned, consts, _o = tdb._plan(tparse(text)[0],
                                        force_multi_join=multi)
        est[multi] = tdb.executor.compile(planned, consts).est_bytes
    if plan == "multi":
        limit_mb = ((est[False] + est[True]) // 2) >> 20
        assert est[False] < limit_mb << 20 < est[True]
        refused = est[True]
    else:
        limit_mb = max((est[False] >> 20) // over, 1)
        refused = None
    errors = {}
    for side, d, err in (("jax", jdb, JQueryError), ("port", tdb, QueryError)):
        d.sql(f"set vmem_protect_limit_mb = {limit_mb}")
        try:
            with pytest.raises(err, match="not spillable") as ei:
                d.sql(text)
        finally:
            d.sql("set vmem_protect_limit_mb = 12288")
        errors[side] = str(ei.value)
    assert errors["port"] == errors["jax"]
    if refused is not None:
        assert f"~{refused >> 20} MB per segment" in errors["port"]
