"""Deterministic TPC-H-style data generator (dbgen-lite) — the port's copy
of ``generate`` from greengage_tpu/utils/tpch.py, with the same rng draws
in the same order, so the port's tables equal the JAX package's for the
same ``sf`` and ``seed``.

Structurally faithful to TPC-H (key relationships, value ranges, decimal
scales, date windows) with simplified text columns: free-text *_comment
fields use a small vocabulary so dictionary encoding stays cheap (the
reference's benchmark harness concern is bulk numbers, not prose —
src/test/performance loads synthetic rows similarly). Row counts follow the
spec: lineitem ≈ 6M x SF, orders = 1.5M x SF, customer = 150k x SF,
part = 200k x SF, supplier = 10k x SF.
"""

from __future__ import annotations
import numpy as np

from greengage_tpu_torch import types as T
from greengage_tpu_torch.types import Coded

NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1), ("EGYPT", 4),
    ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3), ("INDIA", 2), ("INDONESIA", 2),
    ("IRAN", 4), ("IRAQ", 4), ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0),
    ("MOROCCO", 0), ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3), ("UNITED KINGDOM", 3),
    ("UNITED STATES", 1),
]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
INSTRUCTS = ["COLLECT COD", "DELIVER IN PERSON", "NONE", "TAKE BACK RETURN"]

_D = T.date_to_days


def _dates(rng, n, lo="1992-01-01", hi="1998-08-02"):
    return rng.integers(_D(lo), _D(hi) + 1, n).astype(np.int32)


def _dec(rng, n, lo, hi, scale=2):
    """Random decimal in [lo, hi] as scaled int64."""
    return rng.integers(int(lo * 10**scale), int(hi * 10**scale) + 1, n).astype(np.int64)


def _vocab(rng, n, prefix, k) -> Coded:
    """Low-NDV text column in bulk-coded form (vocab + int32 codes): O(k)
    Python string work regardless of row count."""
    idx = rng.integers(0, k, n).astype(np.int32)
    return Coded([f"{prefix}{i}" for i in range(k)], idx)


def _choice(rng, n, values: list[str]) -> Coded:
    return Coded(list(values), rng.integers(0, len(values), n).astype(np.int32))


def generate(sf: float, seed: int = 19940801) -> dict[str, dict]:
    """-> {table: {col: np.ndarray | list[str]}} (decimals pre-scaled)."""
    rng = np.random.default_rng(seed)
    n_orders = max(int(1_500_000 * sf), 10)
    n_cust = max(int(150_000 * sf), 5)
    n_supp = max(int(10_000 * sf), 3)
    n_part = max(int(200_000 * sf), 5)

    nation = {
        "n_nationkey": np.arange(25, dtype=np.int32),
        "n_name": [n for n, _ in NATIONS],
        "n_regionkey": np.array([r for _, r in NATIONS], dtype=np.int32),
        "n_comment": _vocab(rng, 25, "nation comment ", 10),
    }
    region = {
        "r_regionkey": np.arange(5, dtype=np.int32),
        "r_name": REGIONS,
        "r_comment": _vocab(rng, 5, "region comment ", 5),
    }
    supplier = {
        "s_suppkey": np.arange(1, n_supp + 1, dtype=np.int64),
        "s_name": [f"Supplier#{i:09d}" for i in range(1, n_supp + 1)],
        "s_address": _vocab(rng, n_supp, "addr ", 500),
        "s_nationkey": rng.integers(0, 25, n_supp).astype(np.int32),
        "s_phone": _vocab(rng, n_supp, "phone ", 1000),
        "s_acctbal": _dec(rng, n_supp, -999.99, 9999.99),
        "s_comment": _vocab(rng, n_supp, "supp comment ", 200),
    }
    customer = {
        "c_custkey": np.arange(1, n_cust + 1, dtype=np.int64),
        "c_name": [f"Customer#{i:09d}" for i in range(1, n_cust + 1)],
        "c_address": _vocab(rng, n_cust, "addr ", 1000),
        "c_nationkey": rng.integers(0, 25, n_cust).astype(np.int32),
        "c_phone": _vocab(rng, n_cust, "phone ", 1000),
        "c_acctbal": _dec(rng, n_cust, -999.99, 9999.99),
        "c_mktsegment": _choice(rng, n_cust, SEGMENTS),
        "c_comment": _vocab(rng, n_cust, "cust comment ", 300),
    }
    part = {
        "p_partkey": np.arange(1, n_part + 1, dtype=np.int64),
        "p_name": _vocab(rng, n_part, "part name ", 2000),
        "p_mfgr": Coded([f"Manufacturer#{i}" for i in range(1, 6)],
                        rng.integers(0, 5, n_part).astype(np.int32)),
        "p_brand": Coded([f"Brand#{i}{j}" for i in range(1, 6) for j in range(1, 6)],
                         rng.integers(0, 25, n_part).astype(np.int32)),
        "p_type": _vocab(rng, n_part, "type ", 150),
        "p_size": rng.integers(1, 51, n_part).astype(np.int32),
        "p_container": _vocab(rng, n_part, "container ", 40),
        "p_retailprice": _dec(rng, n_part, 900.0, 2000.0),
        "p_comment": _vocab(rng, n_part, "part comment ", 100),
    }
    odate = _dates(rng, n_orders, "1992-01-01", "1998-08-02")
    orders = {
        "o_orderkey": np.arange(1, n_orders + 1, dtype=np.int64),
        "o_custkey": rng.integers(1, n_cust + 1, n_orders).astype(np.int64),
        "o_orderstatus": _choice(rng, n_orders, ["F", "O", "P"]),
        "o_totalprice": _dec(rng, n_orders, 800.0, 500000.0),
        "o_orderdate": odate,
        "o_orderpriority": _choice(rng, n_orders, PRIORITIES),
        "o_clerk": Coded(
            [f"Clerk#{i:09d}" for i in range(1, max(n_orders // 1000, 2))],
            rng.integers(0, max(n_orders // 1000, 2) - 1, n_orders).astype(np.int32)),
        "o_shippriority": np.zeros(n_orders, dtype=np.int32),
        "o_comment": _vocab(rng, n_orders, "order comment ", 500),
    }
    # lineitem: 1-7 lines per order (avg 4)
    lines_per = rng.integers(1, 8, n_orders)
    n_line = int(lines_per.sum())
    l_orderkey = np.repeat(orders["o_orderkey"], lines_per)
    l_odate = np.repeat(odate, lines_per)
    ship_delay = rng.integers(1, 122, n_line)
    l_ship = (l_odate + ship_delay).astype(np.int32)
    # linenumber = position within order, vectorized: global index minus the
    # order's first global index, +1
    starts = np.repeat(np.cumsum(lines_per) - lines_per, lines_per)
    l_linenumber = (np.arange(n_line) - starts + 1).astype(np.int32)
    lineitem = {
        "l_orderkey": l_orderkey,
        "l_partkey": rng.integers(1, n_part + 1, n_line).astype(np.int64),
        "l_suppkey": rng.integers(1, n_supp + 1, n_line).astype(np.int64),
        "l_linenumber": l_linenumber,
        "l_quantity": _dec(rng, n_line, 1.0, 50.0),
        "l_extendedprice": _dec(rng, n_line, 900.0, 100000.0),
        "l_discount": _dec(rng, n_line, 0.0, 0.10),
        "l_tax": _dec(rng, n_line, 0.0, 0.08),
        "l_returnflag": _choice(rng, n_line, ["A", "N", "R"]),
        "l_linestatus": _choice(rng, n_line, ["F", "O"]),
        "l_shipdate": l_ship,
        "l_commitdate": (l_ship + rng.integers(-30, 31, n_line)).astype(np.int32),
        "l_receiptdate": (l_ship + rng.integers(1, 31, n_line)).astype(np.int32),
        "l_shipinstruct": _choice(rng, n_line, INSTRUCTS),
        "l_shipmode": _choice(rng, n_line, SHIPMODES),
        "l_comment": _vocab(rng, n_line, "li comment ", 1000),
    }
    # partsupp: each part stocked by 4 suppliers (dbgen's layout: supplier
    # chosen by a part/index formula so pairs are unique)
    ps_part = np.repeat(part["p_partkey"], 4)
    idx4 = np.tile(np.arange(4, dtype=np.int64), n_part)
    ps_supp = ((ps_part + idx4 * (n_supp // 4 + 1)) % n_supp) + 1
    n_ps = len(ps_part)
    partsupp = {
        "ps_partkey": ps_part.astype(np.int64),
        "ps_suppkey": ps_supp.astype(np.int64),
        "ps_availqty": rng.integers(1, 10_000, n_ps).astype(np.int32),
        "ps_supplycost": _dec(rng, n_ps, 1.0, 1000.0),
        "ps_comment": _vocab(rng, n_ps, "ps comment ", 200),
    }
    return {
        "nation": nation, "region": region, "supplier": supplier,
        "customer": customer, "part": part, "partsupp": partsupp,
        "orders": orders, "lineitem": lineitem,
    }


# lineitem's schema as the JAX package's DDL declares it (decimal(15,2)
# money columns, DATE as days, TEXT as dictionary codes)
LINEITEM_TYPES = {
    "l_orderkey": T.INT64, "l_partkey": T.INT64, "l_suppkey": T.INT64,
    "l_linenumber": T.INT32,
    "l_quantity": T.decimal(2), "l_extendedprice": T.decimal(2),
    "l_discount": T.decimal(2), "l_tax": T.decimal(2),
    "l_returnflag": T.TEXT, "l_linestatus": T.TEXT,
    "l_shipdate": T.DATE, "l_commitdate": T.DATE, "l_receiptdate": T.DATE,
    "l_shipinstruct": T.TEXT, "l_shipmode": T.TEXT, "l_comment": T.TEXT,
}
LINEITEM_DISTKEY = "l_orderkey"
