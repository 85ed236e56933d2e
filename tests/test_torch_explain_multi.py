"""EXPLAIN ANALYZE of a statement whose unique-key join meets duplicate
build keys (ROADMAP Queue 3 item 11).

TPC-DS Q82 over tests/test_tpcds_full.py's data (utils/tpcds.py, scale
1.0, 4 segments) plans a unique-key hash join whose build side holds
duplicate keys. The SELECT re-plans with multi-match joins in both
packages and answers 7 rows. On a fresh shape (no SELECT of it ran
before), the port's EXPLAIN ANALYZE re-plans the same way and annotates
the multi-match plan: its top node's actual rows equal the SELECT's rows.
The JAX package's EXPLAIN ANALYZE raises ``QueryError`` (hash join build
side has duplicate keys) instead: that stays as it is in the reference
and is pinned here beside the port's answer.

Cold, the re-plan is admitted by a runaway estimate and takes about 70 s
on the CPU (ROADMAP Queue 3 item 12), once; the JAX SELECT's rows are held
to the port's in tests/test_torch_sql_breadth_tpcds.py (slow).
"""

import re

import pytest

import greengage_tpu
import greengage_tpu_torch
from greengage_tpu.exec.executor import QueryError as JQueryError
from greengage_tpu.utils import tpcds as jtpcds
from greengage_tpu_torch.utils import tpcds as ttpcds

Q82 = """
      select i_item_id, i_item_desc, i_current_price
      from item, inventory, date_dim, store_sales
      where i_current_price between 30.00 and 60.00
        and inv_item_sk = i_item_sk and d_date_sk = inv_date_sk
        and d_date between cast('2001-06-01' as date)
                       and (cast('2001-06-01' as date) + 60 days)
        and i_manufact_id in (10, 30, 50, 70)
        and inv_quantity_on_hand between 100 and 500
        and ss_item_sk = i_item_sk
      group by i_item_id, i_item_desc, i_current_price
      order by i_item_id limit 100"""


@pytest.fixture(scope="module")
def dbs(devices8):
    j = greengage_tpu.connect(numsegments=4)
    jtpcds.load(j, 1.0)
    t = greengage_tpu_torch.connect(numsegments=4, device="cpu")
    ttpcds.load(t, 1.0)
    for d in (j, t):
        d.sql("analyze")
    yield j, t
    t.close()
    j.close()


def test_explain_analyze_of_a_multi_match_statement_answers(dbs):
    j, t = dbs
    # the reference raises on the fresh shape (shared, left as it is)
    with pytest.raises(JQueryError, match="duplicate keys"):
        j.sql("explain analyze " + Q82)
    r = t.sql("explain analyze " + Q82)
    annotated = [int(n) for n in re.findall(r"actual rows=(\d+)",
                                            r.plan_text)]
    assert annotated, r.plan_text
    select = t.sql(Q82)
    assert select.stats["multi_join_replan"] is False   # remembered
    rows = select.rows()
    assert len(rows) == 7
    # the top annotated node (the Limit under the Gather) returns the
    # SELECT's rows
    assert annotated[0] == len(rows)
    assert f"rows: {len(rows)}" in r.plan_text
