"""The TPC-DS statements of the JAX suites through the port against the
JAX package.

Every constant SELECT or WITH statement of tests/test_tpcds_full.py (on
its data: utils/tpcds.py at scale 1.0, 4 segments, loaded from the same
generator into both packages) and of tests/test_tpcds_subset.py (its
fixture's tables, copied into the port through ``load_table`` by
tests/torch_breadth.py ``mirror``) runs in both packages. Rows must match
(integers, DECIMAL, dates and text exactly, float64 within 1e-12
relative); a statement the JAX package refuses must raise in the port
too. Q37 and Q82 of test_tpcds_full.py are marked ``slow``: cold, each
package admits their multi-match re-plan by a runaway estimate and takes
36 s and 70 s on the CPU (ROADMAP Queue 3 item 12).
"""

import os
import sys

import pytest

import greengage_tpu
import greengage_tpu_torch
from greengage_tpu.utils import tpcds as jtpcds
from greengage_tpu_torch.utils import tpcds as ttpcds
from torch_breadth import assert_same_answer, mirror, statements

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import test_tpcds_subset as J_SUBSET  # noqa: E402

SCALE = 1.0
SLOW = ("test_q37_catalog_inventory", "test_q82_store_inventory")


def _full_cases():
    out = []
    for test, k, text in statements(os.path.join(HERE,
                                                 "test_tpcds_full.py")):
        marks = (pytest.mark.slow,) if test in SLOW else ()
        out.append(pytest.param(text, id=f"{test}-{k}", marks=marks))
    return out


@pytest.fixture(scope="module")
def full(devices8):
    j = greengage_tpu.connect(numsegments=4)
    jtpcds.load(j, SCALE)
    t = greengage_tpu_torch.connect(numsegments=4, device="cpu")
    ttpcds.load(t, SCALE)
    for d in (j, t):
        d.sql("analyze")
    yield j, t
    t.close()
    j.close()


@pytest.fixture(scope="module")
def subset(devices8):
    j = J_SUBSET.env.__wrapped__(devices8)
    if isinstance(j, tuple):    # (Database, pandas oracle frames)
        j = j[0]
    t = greengage_tpu_torch.connect(numsegments=j.numsegments, device="cpu")
    mirror(j, t)
    for d in (j, t):
        d.sql("analyze")
    yield j, t
    t.close()
    j.close()


@pytest.mark.parametrize("text", _full_cases())
def test_tpcds_full_statement_equals_jax(full, text):
    assert_same_answer(*full, text)


@pytest.mark.parametrize("text", [
    pytest.param(text, id=f"{test}-{k}")
    for test, k, text in statements(J_SUBSET.__file__)])
def test_tpcds_subset_statement_equals_jax(subset, text):
    assert_same_answer(*subset, text)
