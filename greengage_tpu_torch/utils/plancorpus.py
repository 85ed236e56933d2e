"""The TPC-H statement corpus — the port's copy of the TPC-H half of
greengage_tpu/analysis/plancorpus.py: the statement shapes the port
plans and runs (joins of every motion flavor, one- and two-phase
aggregates, global and partitioned windows, a funnelled LIMIT, semi and
anti subqueries, a UNION ALL). The tests hold it equal to the JAX
package's; chip_smoke.py re-plans it under the card's cost calibration.
"""

from __future__ import annotations

TPCH_QUERIES: dict[str, str] = {
    "q1_pricing_summary": """
      select l_returnflag, l_linestatus, sum(l_quantity), count(*)
      from lineitem where l_shipdate <= date '1998-09-02'
      group by l_returnflag, l_linestatus
      order by l_returnflag, l_linestatus""",
    "q3_shipping_priority": """
      select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
             o_orderdate, o_shippriority
      from customer, orders, lineitem
      where c_mktsegment = 'BUILDING'
        and c_custkey = o_custkey and l_orderkey = o_orderkey
        and o_orderdate < date '1995-03-15' and l_shipdate > date '1995-03-15'
      group by l_orderkey, o_orderdate, o_shippriority
      order by revenue desc, o_orderdate limit 10""",
    "q6_forecast_revenue": """
      select sum(l_extendedprice * l_discount) as revenue
      from lineitem
      where l_shipdate >= date '1994-01-01'
        and l_shipdate < date '1995-01-01'
        and l_discount between 0.05 and 0.07 and l_quantity < 24""",
    "q10_returned_items": """
      select c_custkey, c_name,
             sum(l_extendedprice * (1 - l_discount)) as revenue,
             c_acctbal, n_name
      from customer, orders, lineitem, nation
      where c_custkey = o_custkey and l_orderkey = o_orderkey
        and o_orderdate >= date '1993-10-01'
        and o_orderdate < date '1994-01-01'
        and l_returnflag = 'R' and c_nationkey = n_nationkey
      group by c_custkey, c_name, c_acctbal, n_name
      order by revenue desc limit 20""",
    "q12_shipmode": """
      select l_shipmode,
             sum(case when o_orderpriority = '1-URGENT'
                       or o_orderpriority = '2-HIGH' then 1 else 0 end)
               as high_line_count,
             sum(case when o_orderpriority <> '1-URGENT'
                       and o_orderpriority <> '2-HIGH' then 1 else 0 end)
               as low_line_count
      from orders, lineitem
      where o_orderkey = l_orderkey
        and l_shipmode in ('MAIL', 'SHIP')
        and l_commitdate < l_receiptdate and l_shipdate < l_commitdate
        and l_receiptdate >= date '1994-01-01'
        and l_receiptdate < date '1995-01-01'
      group by l_shipmode order by l_shipmode""",
    "q14_promo_effect": """
      select 100.00 * sum(case when p_type like 'type 1%'
                               then l_extendedprice * (1 - l_discount)
                               else 0 end)
             / sum(l_extendedprice * (1 - l_discount)) as promo_revenue
      from lineitem, part
      where l_partkey = p_partkey
        and l_shipdate >= date '1995-09-01'
        and l_shipdate < date '1995-10-01'""",
    "q18_large_volume": """
      select c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
             sum(l_quantity)
      from customer, orders, lineitem
      where o_orderkey in (
              select l_orderkey from lineitem
              group by l_orderkey having sum(l_quantity) > 250)
        and c_custkey = o_custkey and o_orderkey = l_orderkey
      group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
      order by o_totalprice desc, o_orderdate limit 100""",
    "point_direct_dispatch":
        "select o_totalprice from orders where o_orderkey = 100",
    "semi_exists": """
      select c_custkey, c_name from customer
      where exists (select 1 from orders where o_custkey = c_custkey
                    and o_totalprice > 100000)
      order by c_custkey limit 50""",
    "anti_not_in": """
      select c_custkey from customer
      where c_custkey not in (select o_custkey from orders)
      order by c_custkey limit 50""",
    "scalar_subquery": """
      select l_orderkey, l_extendedprice from lineitem
      where l_extendedprice > (select avg(l_extendedprice) from lineitem)
      order by l_extendedprice desc limit 25""",
    "global_window_rank": """
      select o_orderkey, o_totalprice,
             row_number() over (order by o_orderkey) rn
      from orders order by rn limit 20""",
    "partitioned_window": """
      select o_custkey, o_orderkey, o_totalprice,
             sum(o_totalprice) over (partition by o_custkey) cust_total
      from orders order by o_custkey, o_orderkey limit 30""",
    "union_all_branches": """
      select o_orderkey as k, o_totalprice as v from orders
        where o_totalprice > 150000
      union all
      select l_orderkey as k, l_extendedprice as v from lineitem
        where l_quantity > 45
      order by k, v limit 40""",
    "distinct_group": """
      select distinct l_shipmode from lineitem order by l_shipmode""",
    "cross_join_scalar": """
      select n_name, r_name from nation, region
      where n_regionkey = r_regionkey order by n_name limit 10""",
    "buried_limit_subquery": """
      select k from (select o_orderkey as k from orders
                     order by o_totalprice desc limit 5) t
      order by k""",
    "two_phase_strewn_group": """
      select l_suppkey, count(*) c, sum(l_quantity) q
      from lineitem group by l_suppkey order by c desc, l_suppkey limit 15""",
    # ---- the window engine: every shape below must plan with the
    # ---- root Gather as its ONLY Gather and no SingleQE funnel --------
    "ordered_global_ntile": """
      select o_orderkey, ntile(4) over (order by o_orderkey) nt
      from orders order by o_orderkey limit 20""",
    "ordered_global_lag_lead": """
      select o_orderkey, lag(o_totalprice) over (order by o_orderdate,
                                                 o_orderkey) lp,
             lead(o_custkey, 2) over (order by o_orderdate, o_orderkey) lc
      from orders order by o_orderkey limit 20""",
    "ordered_global_text_rank": """
      select o_clerk, ntile(3) over (order by o_clerk) nt,
             dense_rank() over (order by o_clerk) dr
      from orders order by o_clerk limit 20""",
    "range_window_running_sum": """
      select o_orderkey, sum(o_totalprice) over (order by o_totalprice,
                                                 o_orderkey) rs
      from orders order by o_orderkey limit 20""",
    "ordered_global_decimal_rank": """
      select o_orderkey, rank() over (order by o_totalprice desc) rk
      from orders order by o_orderkey limit 20""",
    "whole_frame_first_value": """
      select o_custkey, first_value(o_totalprice) over
               (partition by o_custkey) f
      from orders order by o_orderkey limit 20""",
}


# The 22 TPC-H statements as the JAX package's tests and bench run them:
# Q1, Q3 and Q6 are the corpus's above; Q5 is bench.py's; Q4 and Q17 are
# tests/test_subqueries.py's; Q10, Q12, Q13, Q14 and Q19
# tests/test_tpch_more.py's; the rest tests/test_tpch_full.py's (a test
# holds each equal to its source, whitespace normalised). chip_smoke.py's
# tpch22 phase runs them on the card.
TPCH22: dict[str, str] = {
    "q1": TPCH_QUERIES["q1_pricing_summary"],
    "q3": TPCH_QUERIES["q3_shipping_priority"],
    "q6": TPCH_QUERIES["q6_forecast_revenue"],
    "q2": """
      select s_acctbal, s_name, n_name, p_partkey, p_mfgr
      from part, supplier, partsupp, nation, region
      where p_partkey = ps_partkey and s_suppkey = ps_suppkey and p_size = 15
        and s_nationkey = n_nationkey and n_regionkey = r_regionkey
        and r_name = 'EUROPE'
        and ps_supplycost = (
          select min(ps_supplycost) from partsupp, supplier, nation, region
          where p_partkey = ps_partkey and s_suppkey = ps_suppkey
            and s_nationkey = n_nationkey and n_regionkey = r_regionkey
            and r_name = 'EUROPE')
      order by s_acctbal desc, n_name, s_name, p_partkey limit 10""",
    "q4": """
      select o_orderpriority, count(*) as order_count
      from orders
      where o_orderdate >= date '1993-07-01'
        and o_orderdate < date '1993-07-01' + interval '3' month
        and exists (
          select 1 from lineitem
          where l_orderkey = o_orderkey and l_commitdate < l_receiptdate)
      group by o_orderpriority
      order by o_orderpriority""",
    "q5": """
      select n_name, sum(l_extendedprice * (1 - l_discount)) as revenue
      from customer, orders, lineitem, supplier, nation, region
      where c_custkey = o_custkey and l_orderkey = o_orderkey
        and l_suppkey = s_suppkey and c_nationkey = s_nationkey
        and s_nationkey = n_nationkey and n_regionkey = r_regionkey
        and r_name = 'ASIA'
        and o_orderdate >= date '1994-01-01'
        and o_orderdate < date '1994-01-01' + interval '1' year
      group by n_name
      order by revenue desc""",
    "q7": """
      select supp_nation, cust_nation, l_year, sum(volume) as revenue
      from (select n1.n_name as supp_nation, n2.n_name as cust_nation,
                   extract(year from l_shipdate) as l_year,
                   l_extendedprice * (1 - l_discount) as volume
            from supplier, lineitem, orders, customer, nation n1, nation n2
            where s_suppkey = l_suppkey and o_orderkey = l_orderkey
              and c_custkey = o_custkey and s_nationkey = n1.n_nationkey
              and c_nationkey = n2.n_nationkey
              and ((n1.n_name = 'FRANCE' and n2.n_name = 'GERMANY')
                or (n1.n_name = 'GERMANY' and n2.n_name = 'FRANCE'))
              and l_shipdate between date '1995-01-01' and date '1996-12-31'
           ) as shipping
      group by supp_nation, cust_nation, l_year
      order by supp_nation, cust_nation, l_year""",
    "q8": """
      select o_year,
             sum(case when nation = 'BRAZIL' then volume else 0 end)
               / sum(volume) as mkt_share
      from (select extract(year from o_orderdate) as o_year,
                   l_extendedprice * (1 - l_discount) as volume,
                   n2.n_name as nation
            from part, supplier, lineitem, orders, customer,
                 nation n1, nation n2, region
            where p_partkey = l_partkey and s_suppkey = l_suppkey
              and l_orderkey = o_orderkey and o_custkey = c_custkey
              and c_nationkey = n1.n_nationkey
              and n1.n_regionkey = r_regionkey and r_name = 'AMERICA'
              and s_nationkey = n2.n_nationkey
              and o_orderdate between date '1995-01-01'
                                  and date '1996-12-31') as all_nations
      group by o_year order by o_year""",
    "q9": """
      select nation, o_year, sum(amount) as sum_profit
      from (select n_name as nation, extract(year from o_orderdate) as o_year,
                   l_extendedprice * (1 - l_discount)
                     - ps_supplycost * l_quantity as amount
            from part, supplier, lineitem, partsupp, orders, nation
            where s_suppkey = l_suppkey and ps_suppkey = l_suppkey
              and ps_partkey = l_partkey and p_partkey = l_partkey
              and o_orderkey = l_orderkey and s_nationkey = n_nationkey
              and p_name like '%name 1%') as profit
      group by nation, o_year order by nation, o_year desc""",
    "q10": """
      select c_custkey, c_name,
             sum(l_extendedprice * (1 - l_discount)) as revenue,
             c_acctbal, n_name
      from customer, orders, lineitem, nation
      where c_custkey = o_custkey and l_orderkey = o_orderkey
        and o_orderdate >= date '1993-10-01'
        and o_orderdate < date '1993-10-01' + interval '3' month
        and l_returnflag = 'R' and c_nationkey = n_nationkey
      group by c_custkey, c_name, c_acctbal, n_name
      order by revenue desc limit 20""",
    "q11": """
      select ps_partkey, sum(ps_supplycost * ps_availqty) as value
      from partsupp, supplier, nation
      where ps_suppkey = s_suppkey and s_nationkey = n_nationkey
        and n_name = 'GERMANY'
      group by ps_partkey
      having sum(ps_supplycost * ps_availqty) > (
        select sum(ps_supplycost * ps_availqty) * 0.0001
        from partsupp, supplier, nation
        where ps_suppkey = s_suppkey and s_nationkey = n_nationkey
          and n_name = 'GERMANY')
      order by value desc, ps_partkey limit 20""",
    "q12": """
      select l_shipmode,
             sum(case when o_orderpriority = '1-URGENT'
                       or o_orderpriority = '2-HIGH' then 1 else 0 end) as high_line_count,
             sum(case when o_orderpriority <> '1-URGENT'
                       and o_orderpriority <> '2-HIGH' then 1 else 0 end) as low_line_count
      from orders, lineitem
      where o_orderkey = l_orderkey
        and l_shipmode in ('MAIL', 'SHIP')
        and l_commitdate < l_receiptdate and l_shipdate < l_commitdate
        and l_receiptdate >= date '1994-01-01'
        and l_receiptdate < date '1994-01-01' + interval '1' year
      group by l_shipmode order by l_shipmode""",
    "q13": """
      select c_count, count(*) as custdist from (
        select c_custkey, count(o_orderkey) as c_count
        from customer left join orders
          on c_custkey = o_custkey and o_comment not like '%comment 1%'
        group by c_custkey
      ) c_orders
      group by c_count
      order by custdist desc, c_count desc""",
    "q14": """
      select 100.00 * sum(case when p_type like 'type 1%'
                          then l_extendedprice * (1 - l_discount) else 0 end)
             / sum(l_extendedprice * (1 - l_discount)) as promo_revenue
      from lineitem, part
      where l_partkey = p_partkey
        and l_shipdate >= date '1995-09-01'
        and l_shipdate < date '1995-09-01' + interval '1' month""",
    "q15": """
      with revenue as (
        select l_suppkey as supplier_no,
               sum(l_extendedprice * (1 - l_discount)) as total_revenue
        from lineitem
        where l_shipdate >= date '1996-01-01'
          and l_shipdate < date '1996-04-01'
        group by l_suppkey)
      select s_suppkey, s_name, total_revenue from supplier, revenue
      where s_suppkey = supplier_no
        and total_revenue = (select max(total_revenue) from revenue)
      order by s_suppkey""",
    "q16": """
      select p_brand, p_size, count(distinct ps_suppkey) as cnt
      from partsupp, part
      where p_partkey = ps_partkey and p_brand <> 'Brand#45'
        and p_size in (49, 14, 23, 45, 19, 3, 36, 9)
      group by p_brand, p_size
      order by cnt desc, p_brand, p_size limit 15""",
    "q17": """
      select sum(l_extendedprice) / 7.0 as avg_yearly
      from lineitem, part
      where p_partkey = l_partkey and p_brand = 'Brand#23'
        and l_quantity < (select 0.2 * avg(l_quantity) from lineitem
                          where l_partkey = p_partkey)""",
    "q18": """
      select c_name, c_custkey, o_orderkey, o_totalprice,
             sum(l_quantity)
      from customer, orders, lineitem
      where o_orderkey in (select l_orderkey from lineitem
                           group by l_orderkey having sum(l_quantity) > 150)
        and c_custkey = o_custkey and o_orderkey = l_orderkey
      group by c_name, c_custkey, o_orderkey, o_totalprice
      order by o_totalprice desc, o_orderkey limit 10""",
    "q19": """
      select sum(l_extendedprice * (1 - l_discount)) as revenue
      from lineitem, part
      where p_partkey = l_partkey
        and ((p_brand = 'Brand#11' and l_quantity between 1 and 11
              and p_size between 1 and 5)
          or (p_brand = 'Brand#22' and l_quantity between 10 and 20
              and p_size between 1 and 10)
          or (p_brand = 'Brand#33' and l_quantity between 20 and 30
              and p_size between 1 and 15))
        and l_shipmode in ('AIR', 'REG AIR')""",
    "q20": """
      select s_name, s_address from supplier, nation
      where s_suppkey in (
        select ps_suppkey from partsupp
        where ps_partkey in (select p_partkey from part
                             where p_name like 'part name 1%')
          and ps_availqty > (select 0.5 * sum(l_quantity) from lineitem
              where l_partkey = ps_partkey and l_suppkey = ps_suppkey))
        and s_nationkey = n_nationkey and n_name = 'CANADA'
      order by s_name""",
    "q21": """
      select s_name, count(*) as numwait
      from supplier, lineitem l1, orders, nation
      where s_suppkey = l1.l_suppkey and o_orderkey = l1.l_orderkey
        and o_orderstatus = 'F' and l1.l_receiptdate > l1.l_commitdate
        and exists (select 1 from lineitem l2
                    where l2.l_orderkey = l1.l_orderkey
                      and l2.l_suppkey <> l1.l_suppkey)
        and not exists (select 1 from lineitem l3
                        where l3.l_orderkey = l1.l_orderkey
                          and l3.l_suppkey <> l1.l_suppkey
                          and l3.l_receiptdate > l3.l_commitdate)
        and s_nationkey = n_nationkey
      group by s_name order by numwait desc, s_name limit 10""",
    "q22": """
      select cntrycode, count(*) as numcust,
                        sum(c_acctbal) as totacctbal
      from (select substring(c_phone from 7 for 1) as cntrycode, c_acctbal
            from customer
            where substring(c_phone from 7 for 1) in ('1','2','3')
              and c_acctbal > (select avg(c_acctbal) from customer
                               where c_acctbal > 0.00)
              and not exists (select 1 from orders
                              where o_custkey = c_custkey)) as custsale
      group by cntrycode order by cntrycode""",
}
