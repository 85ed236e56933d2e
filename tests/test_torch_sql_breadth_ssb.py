"""The SSB, subquery and strings/CTE statements of the JAX suites through
the port against the JAX package.

Every constant SELECT or WITH statement of tests/test_ssb.py,
tests/test_subqueries.py and tests/test_strings_cte.py's ``db`` fixture
(tests/torch_breadth.py ``statements``) runs in both packages on the same
data: the JAX side is the JAX test's own fixture (INSERTs and loads), the
port's a copy of its tables loaded through ``load_table``
(torch_breadth ``mirror``). Rows must match (integers, DECIMAL, dates and
text exactly, float64 within 1e-12 relative); a statement the JAX package
refuses must raise in the port too. Left out: test_strings_cte.py's
raw-TEXT statements (its ``rawdb`` fixture; raw TEXT waits for ROADMAP
Queue 1 item 1e) and statements over tables a test creates in its own
body (the fixtures' tables are what is copied).
"""

import os
import sys

import pytest

import greengage_tpu_torch
from torch_breadth import assert_same_answer, mirror, statements

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import test_ssb as J_SSB  # noqa: E402
import test_strings_cte as J_STR  # noqa: E402
import test_subqueries as J_SUB  # noqa: E402

# tables the tests create in their own bodies, which no fixture holds
_BODY_TABLES = ("sq_n", "sq_r", "cs_a", "cs_b")


def _cases(module, receiver=None):
    out = []
    for test, k, text in statements(module.__file__, receiver=receiver):
        if any(f" {t} " in f" {text} ".replace(",", " ").replace("\n", " ")
               for t in _BODY_TABLES):
            continue
        out.append(pytest.param(text, id=f"{test}-{k}"))
    return out


def _pair(jfixture, *args):
    j = jfixture.__wrapped__(*args)
    if isinstance(j, tuple):    # (Database, pandas oracle frames)
        j = j[0]
    t = greengage_tpu_torch.connect(numsegments=j.numsegments, device="cpu")
    mirror(j, t)
    for d in (j, t):
        d.sql("analyze")
    return j, t


@pytest.fixture(scope="module")
def ssb(devices8):
    j, t = _pair(J_SSB.env, devices8)
    yield j, t
    t.close()
    j.close()


@pytest.fixture(scope="module")
def sub(devices8):
    j, t = _pair(J_SUB.db, devices8)
    yield j, t
    t.close()
    j.close()


@pytest.fixture(scope="module")
def strs(devices8):
    j, t = _pair(J_STR.db, devices8)
    yield j, t
    t.close()
    j.close()


@pytest.mark.parametrize("text", _cases(J_SSB))
def test_ssb_statement_equals_jax(ssb, text):
    assert_same_answer(*ssb, text)


@pytest.mark.parametrize("text", _cases(J_SUB))
def test_subquery_statement_equals_jax(sub, text):
    assert_same_answer(*sub, text)


@pytest.mark.parametrize("text", _cases(J_STR, receiver="db"))
def test_strings_cte_statement_equals_jax(strs, text):
    assert_same_answer(*strs, text)
