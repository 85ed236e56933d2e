"""Deterministic TPC-DS-style data generator (dsdgen-lite) + schema DDL —
the port's copy of greengage_tpu/utils/tpcds.py, with the same rng draws
in the same order, so the port's tables equal the JAX package's for the
same ``scale`` and ``seed``.

Structurally faithful to the TPC-DS retail star schema (16 tables: three
sales channels + inventory over shared dimensions, surrogate-key
relationships, decimal scales, the 1998-2002 date_dim window, d_month_seq
months-since-1900 numbering) with simplified text columns: low-NDV
attributes use small vocabularies in bulk-coded form so dictionary
encoding stays cheap, like utils/tpch.py. Row counts scale linearly in
``scale`` from a test-scale base (store_sales = 60k rows at scale 1).

Tickets/orders group fact rows the way dsdgen does: every store ticket
(and catalog/web order) shares one customer, store, date, and demo set
across its line items — the Q68/Q73/Q79 per-ticket shapes depend on it.
"""

from __future__ import annotations

import numpy as np

from greengage_tpu_torch import types as T
from greengage_tpu_torch.types import Coded

_D = T.date_to_days

FIRST_DAY = "1998-01-01"
N_DATE = _D("2002-12-31") - _D(FIRST_DAY) + 1   # 1826 days

CATEGORIES = ["Books", "Electronics", "Home", "Jewelry", "Men", "Music",
              "Shoes", "Sports", "Children", "Women"]
STATES = ["CA", "GA", "IL", "NY", "OH", "TN", "TX", "WA"]
COUNTIES = [f"{s} County {i}" for s in ("Ziebach", "Walker", "Daviess",
                                        "Barrow", "Fairfield") for i in (1, 2)]
BUY_POTENTIAL = [">10000", "5001-10000", "1001-5000", "501-1000", "0-500",
                 "Unknown"]
EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree", "4 yr Degree",
             "Advanced Degree", "Unknown"]
CREDIT = ["Low Risk", "Good", "High Risk", "Unknown"]
DAY_NAMES = ["Thursday", "Friday", "Saturday", "Sunday", "Monday",
             "Tuesday", "Wednesday"]   # 1998-01-01 was a Thursday
SM_TYPES = ["EXPRESS", "NEXT DAY", "OVERNIGHT", "REGULAR", "TWO DAY",
            "LIBRARY"]


def _dec(rng, n, lo, hi, scale=2):
    return rng.integers(int(lo * 10**scale),
                        int(hi * 10**scale) + 1, n).astype(np.int64)


def _choice(rng, n, values) -> Coded:
    return Coded(list(values), rng.integers(0, len(values), n).astype(np.int32))


def _vocab(rng, n, prefix, k) -> Coded:
    idx = rng.integers(0, k, n).astype(np.int32)
    return Coded([f"{prefix}{i}" for i in range(k)], idx)


def generate(scale: float = 1.0, seed: int = 20020101) -> dict[str, dict]:
    """-> {table: {col: np.ndarray | Coded}} (decimals pre-scaled, scale 2;
    dates as days-since-epoch int32)."""
    rng = np.random.default_rng(seed)
    n_item = max(int(400 * scale), 40)
    n_store = max(int(12 * scale), 6)
    n_cust = max(int(2000 * scale), 100)
    n_addr = max(int(1000 * scale), 50)
    n_cd = 400
    n_hd = 144
    n_promo = 30
    n_wh = 5
    n_sm = len(SM_TYPES)
    n_web = 6
    n_ss_t = max(int(15_000 * scale), 200)     # store tickets (~4 lines each)
    n_cs_o = max(int(8_000 * scale), 100)      # catalog orders
    n_ws_o = max(int(8_000 * scale), 100)      # web orders

    # ---- date_dim: one row per day, 1998-01-01 .. 2002-12-31 ----------
    base = _D(FIRST_DAY)
    days = np.arange(N_DATE, dtype=np.int32)
    dates = (np.datetime64(FIRST_DAY) + days.astype("timedelta64[D]"))
    y = dates.astype("datetime64[Y]").astype(int) + 1970
    m = dates.astype("datetime64[M]").astype(int) % 12 + 1
    dom = (dates - dates.astype("datetime64[M]")).astype(int) + 1
    date_dim = {
        "d_date_sk": days.astype(np.int64),
        "d_date": (base + days).astype(np.int32),
        "d_year": y.astype(np.int32),
        "d_moy": m.astype(np.int32),
        "d_dom": dom.astype(np.int32),
        "d_qoy": ((m + 2) // 3).astype(np.int32),
        "d_dow": (days % 7).astype(np.int32),
        "d_day_name": Coded(DAY_NAMES, (days % 7).astype(np.int32)),
        # months since 1900 (dsdgen numbering): 1998-01 -> 1176
        "d_month_seq": ((y - 1900) * 12 + m - 1).astype(np.int32),
        "d_week_seq": (days // 7 + 5114).astype(np.int32),
    }

    # ---- time_dim: one row per minute ---------------------------------
    mins = np.arange(1440, dtype=np.int32)
    time_dim = {
        "t_time_sk": mins.astype(np.int64),
        "t_hour": (mins // 60).astype(np.int32),
        "t_minute": (mins % 60).astype(np.int32),
    }

    # ---- item ---------------------------------------------------------
    cat_idx = rng.integers(0, len(CATEGORIES), n_item).astype(np.int32)
    class_id = rng.integers(1, 17, n_item).astype(np.int32)
    brand_id = (cat_idx + 1) * 1000000 + class_id * 1000 \
        + rng.integers(1, 10, n_item)
    item = {
        "i_item_sk": np.arange(n_item, dtype=np.int64),
        "i_item_id": Coded([f"AAAAAAAA{i:08d}" for i in range(n_item)],
                           np.arange(n_item, dtype=np.int32)),
        "i_item_desc": _vocab(rng, n_item, "item description ", 200),
        "i_current_price": _dec(rng, n_item, 0.09, 99.99),
        "i_wholesale_cost": _dec(rng, n_item, 0.05, 70.00),
        "i_brand_id": brand_id.astype(np.int32),
        "i_brand": _vocab(rng, n_item, "importobrand #", 60),
        "i_class_id": class_id,
        "i_class": _vocab(rng, n_item, "class ", 16),
        "i_category_id": (cat_idx + 1).astype(np.int32),
        "i_category": Coded(CATEGORIES, cat_idx),
        "i_manufact_id": rng.integers(1, 100, n_item).astype(np.int32),
        "i_manufact": _vocab(rng, n_item, "manufact ", 90),
        "i_manager_id": rng.integers(1, 40, n_item).astype(np.int32),
    }

    # ---- store --------------------------------------------------------
    store = {
        "s_store_sk": np.arange(n_store, dtype=np.int64),
        "s_store_id": Coded([f"AAAAAAAA{i:04d}BAAA" for i in range(n_store)],
                            np.arange(n_store, dtype=np.int32)),
        # dsdgen reuses a tiny name vocabulary ("ought", "able", "ese", ...)
        "s_store_name": _choice(rng, n_store,
                                ["ought", "able", "pri", "ese", "anti"]),
        "s_company_name": Coded(["Unknown"], np.zeros(n_store, np.int32)),
        "s_state": _choice(rng, n_store, STATES),
        "s_county": _choice(rng, n_store, COUNTIES),
        "s_city": _choice(rng, n_store, ["Midway", "Fairview", "Oakdale",
                                         "Glendale", "Centerville"]),
        "s_zip": _vocab(rng, n_store, "554", 30),
        "s_gmt_offset": rng.choice([-500, -600], n_store).astype(np.int64),
    }

    # ---- customer + dims ----------------------------------------------
    customer = {
        "c_customer_sk": np.arange(n_cust, dtype=np.int64),
        "c_customer_id": Coded([f"AAAAAAAA{i:08d}" for i in range(n_cust)],
                               np.arange(n_cust, dtype=np.int32)),
        "c_current_cdemo_sk": rng.integers(0, n_cd, n_cust).astype(np.int64),
        "c_current_hdemo_sk": rng.integers(0, n_hd, n_cust).astype(np.int64),
        "c_current_addr_sk": rng.integers(0, n_addr, n_cust).astype(np.int64),
        "c_first_name": _vocab(rng, n_cust, "First", 300),
        "c_last_name": _vocab(rng, n_cust, "Last", 400),
        "c_salutation": _choice(rng, n_cust, ["Mr.", "Mrs.", "Ms.", "Dr.",
                                              "Miss", "Sir"]),
        "c_preferred_cust_flag": _choice(rng, n_cust, ["Y", "N"]),
        "c_birth_month": rng.integers(1, 13, n_cust).astype(np.int32),
        "c_birth_year": rng.integers(1924, 1993, n_cust).astype(np.int32),
        "c_birth_country": _choice(rng, n_cust, ["UNITED STATES", "CANADA",
                                                 "GERMANY", "JAPAN", "CHILE"]),
    }
    customer_address = {
        "ca_address_sk": np.arange(n_addr, dtype=np.int64),
        "ca_state": _choice(rng, n_addr, STATES),
        "ca_county": _choice(rng, n_addr, COUNTIES),
        "ca_city": _choice(rng, n_addr, ["Midway", "Fairview", "Oakdale",
                                         "Glendale", "Centerville",
                                         "Springdale", "Union Hill"]),
        "ca_zip": _vocab(rng, n_addr, "8", 400),
        "ca_country": Coded(["United States"], np.zeros(n_addr, np.int32)),
        "ca_gmt_offset": rng.choice([-500, -600, -700],
                                    n_addr).astype(np.int64),
        "ca_location_type": _choice(rng, n_addr, ["apartment", "condo",
                                                  "single family"]),
    }
    customer_demographics = {
        "cd_demo_sk": np.arange(n_cd, dtype=np.int64),
        "cd_gender": _choice(rng, n_cd, ["M", "F"]),
        "cd_marital_status": _choice(rng, n_cd, ["M", "S", "D", "W", "U"]),
        "cd_education_status": _choice(rng, n_cd, EDUCATION),
        "cd_purchase_estimate": (rng.integers(1, 20, n_cd) * 500).astype(
            np.int32),
        "cd_credit_rating": _choice(rng, n_cd, CREDIT),
        "cd_dep_count": rng.integers(0, 7, n_cd).astype(np.int32),
    }
    household_demographics = {
        "hd_demo_sk": np.arange(n_hd, dtype=np.int64),
        "hd_income_band_sk": rng.integers(0, 20, n_hd).astype(np.int64),
        "hd_buy_potential": _choice(rng, n_hd, BUY_POTENTIAL),
        "hd_dep_count": rng.integers(0, 10, n_hd).astype(np.int32),
        "hd_vehicle_count": rng.integers(-1, 5, n_hd).astype(np.int32),
    }
    promotion = {
        "p_promo_sk": np.arange(n_promo, dtype=np.int64),
        "p_channel_dmail": _choice(rng, n_promo, ["Y", "N"]),
        "p_channel_email": _choice(rng, n_promo, ["Y", "N"]),
        "p_channel_tv": _choice(rng, n_promo, ["Y", "N"]),
        "p_channel_event": _choice(rng, n_promo, ["Y", "N"]),
    }
    warehouse = {
        "w_warehouse_sk": np.arange(n_wh, dtype=np.int64),
        "w_warehouse_name": Coded(
            [f"Warehouse number {i} with a long name" for i in range(n_wh)],
            np.arange(n_wh, dtype=np.int32)),
        "w_warehouse_sq_ft": rng.integers(50_000, 1_000_000, n_wh).astype(
            np.int32),
        "w_state": _choice(rng, n_wh, STATES),
    }
    ship_mode = {
        "sm_ship_mode_sk": np.arange(n_sm, dtype=np.int64),
        "sm_type": Coded(SM_TYPES, np.arange(n_sm, dtype=np.int32)),
        "sm_carrier": _choice(rng, n_sm, ["UPS", "FEDEX", "AIRBORNE", "USPS",
                                          "DHL", "TBS"]),
    }
    web_site = {
        "web_site_sk": np.arange(n_web, dtype=np.int64),
        "web_name": Coded([f"site_{i}" for i in range(n_web)],
                          np.arange(n_web, dtype=np.int32)),
    }

    # ---- store_sales: per-ticket grouping -----------------------------
    def _fact(n_orders, lo_lines, hi_lines):
        lines = rng.integers(lo_lines, hi_lines + 1, n_orders)
        n = int(lines.sum())
        rep = np.repeat(np.arange(n_orders), lines)
        return lines, n, rep

    t_lines, n_ss, t_rep = _fact(n_ss_t, 1, 7)
    t_date = rng.integers(0, N_DATE, n_ss_t)
    t_cust = rng.integers(0, n_cust, n_ss_t)
    t_store = rng.integers(0, n_store, n_ss_t)
    t_hdemo = rng.integers(0, n_hd, n_ss_t)
    t_cdemo = rng.integers(0, n_cd, n_ss_t)
    t_addr = rng.integers(0, n_addr, n_ss_t)
    qty = rng.integers(1, 101, n_ss).astype(np.int32)
    whole = _dec(rng, n_ss, 1.0, 100.0)
    lp = (whole * rng.integers(100, 201, n_ss) // 100).astype(np.int64)
    sp = (lp * rng.integers(20, 101, n_ss) // 100).astype(np.int64)
    coupon = np.where(rng.random(n_ss) < 0.2,
                      (sp * qty // 10).astype(np.int64), 0)
    store_sales = {
        "ss_sold_date_sk": t_date[t_rep].astype(np.int64),
        "ss_sold_time_sk": rng.integers(0, 1440, n_ss).astype(np.int64),
        "ss_item_sk": rng.integers(0, n_item, n_ss).astype(np.int64),
        "ss_customer_sk": t_cust[t_rep].astype(np.int64),
        "ss_cdemo_sk": t_cdemo[t_rep].astype(np.int64),
        "ss_hdemo_sk": t_hdemo[t_rep].astype(np.int64),
        "ss_addr_sk": t_addr[t_rep].astype(np.int64),
        "ss_store_sk": t_store[t_rep].astype(np.int64),
        "ss_promo_sk": rng.integers(0, n_promo, n_ss).astype(np.int64),
        "ss_ticket_number": t_rep.astype(np.int64),
        "ss_quantity": qty,
        "ss_wholesale_cost": whole,
        "ss_list_price": lp,
        "ss_sales_price": sp,
        "ss_ext_discount_amt": ((lp - sp) * qty).astype(np.int64),
        "ss_ext_sales_price": (sp * qty).astype(np.int64),
        "ss_ext_wholesale_cost": (whole * qty).astype(np.int64),
        "ss_ext_list_price": (lp * qty).astype(np.int64),
        "ss_ext_tax": (sp * qty // 20).astype(np.int64),
        "ss_coupon_amt": coupon,
        "ss_net_paid": (sp * qty - coupon).astype(np.int64),
        "ss_net_profit": (sp * qty - coupon - whole * qty).astype(np.int64),
    }

    # ---- catalog_sales ------------------------------------------------
    o_lines, n_cs, o_rep = _fact(n_cs_o, 1, 5)
    o_date = rng.integers(0, N_DATE - 125, n_cs_o)
    o_cust = rng.integers(0, n_cust, n_cs_o)
    o_cdemo = rng.integers(0, n_cd, n_cs_o)
    o_addr = rng.integers(0, n_addr, n_cs_o)
    qty = rng.integers(1, 101, n_cs).astype(np.int32)
    whole = _dec(rng, n_cs, 1.0, 100.0)
    lp = (whole * rng.integers(100, 201, n_cs) // 100).astype(np.int64)
    sp = (lp * rng.integers(20, 101, n_cs) // 100).astype(np.int64)
    disc = ((lp - sp) * qty).astype(np.int64)
    cs_coupon = np.where(rng.random(n_cs) < 0.2,
                         (sp * qty // 10).astype(np.int64), 0)
    catalog_sales = {
        "cs_sold_date_sk": o_date[o_rep].astype(np.int64),
        "cs_ship_date_sk": (o_date[o_rep]
                            + rng.integers(1, 121, n_cs)).astype(np.int64),
        "cs_bill_customer_sk": o_cust[o_rep].astype(np.int64),
        "cs_bill_cdemo_sk": o_cdemo[o_rep].astype(np.int64),
        "cs_bill_addr_sk": o_addr[o_rep].astype(np.int64),
        "cs_ship_mode_sk": rng.integers(0, n_sm, n_cs).astype(np.int64),
        "cs_warehouse_sk": rng.integers(0, n_wh, n_cs).astype(np.int64),
        "cs_item_sk": rng.integers(0, n_item, n_cs).astype(np.int64),
        "cs_promo_sk": rng.integers(0, n_promo, n_cs).astype(np.int64),
        "cs_order_number": o_rep.astype(np.int64),
        "cs_quantity": qty,
        "cs_wholesale_cost": whole,
        "cs_list_price": lp,
        "cs_sales_price": sp,
        "cs_ext_discount_amt": disc,
        "cs_ext_sales_price": (sp * qty).astype(np.int64),
        "cs_ext_wholesale_cost": (whole * qty).astype(np.int64),
        "cs_coupon_amt": cs_coupon,
        "cs_net_profit": ((sp - whole) * qty).astype(np.int64),
    }

    # ---- web_sales ----------------------------------------------------
    w_lines, n_ws, w_rep = _fact(n_ws_o, 1, 5)
    w_date = rng.integers(0, N_DATE - 125, n_ws_o)
    w_cust = rng.integers(0, n_cust, n_ws_o)
    w_addr = rng.integers(0, n_addr, n_ws_o)
    w_site = rng.integers(0, n_web, n_ws_o)
    qty = rng.integers(1, 101, n_ws).astype(np.int32)
    whole = _dec(rng, n_ws, 1.0, 100.0)
    lp = (whole * rng.integers(100, 201, n_ws) // 100).astype(np.int64)
    sp = (lp * rng.integers(20, 101, n_ws) // 100).astype(np.int64)
    web_sales = {
        "ws_sold_date_sk": w_date[w_rep].astype(np.int64),
        "ws_ship_date_sk": (w_date[w_rep]
                            + rng.integers(1, 121, n_ws)).astype(np.int64),
        "ws_item_sk": rng.integers(0, n_item, n_ws).astype(np.int64),
        "ws_bill_customer_sk": w_cust[w_rep].astype(np.int64),
        "ws_bill_addr_sk": w_addr[w_rep].astype(np.int64),
        "ws_web_site_sk": w_site[w_rep].astype(np.int64),
        "ws_ship_mode_sk": rng.integers(0, n_sm, n_ws).astype(np.int64),
        "ws_warehouse_sk": rng.integers(0, n_wh, n_ws).astype(np.int64),
        "ws_promo_sk": rng.integers(0, n_promo, n_ws).astype(np.int64),
        "ws_order_number": w_rep.astype(np.int64),
        "ws_quantity": qty,
        "ws_wholesale_cost": whole,
        "ws_list_price": lp,
        "ws_sales_price": sp,
        "ws_ext_discount_amt": ((lp - sp) * qty).astype(np.int64),
        "ws_ext_sales_price": (sp * qty).astype(np.int64),
        "ws_ext_wholesale_cost": (whole * qty).astype(np.int64),
        "ws_net_paid": (sp * qty).astype(np.int64),
        "ws_net_profit": ((sp - whole) * qty).astype(np.int64),
    }

    # ---- inventory: weekly snapshots ----------------------------------
    inv_dates = np.arange(0, N_DATE, 7, dtype=np.int64)
    ii, ww, dd = np.meshgrid(np.arange(n_item), np.arange(n_wh),
                             inv_dates[::4], indexing="ij")
    inventory = {
        "inv_item_sk": ii.ravel().astype(np.int64),
        "inv_warehouse_sk": ww.ravel().astype(np.int64),
        "inv_date_sk": dd.ravel().astype(np.int64),
        "inv_quantity_on_hand": rng.integers(
            0, 1000, ii.size).astype(np.int32),
    }

    return {
        "date_dim": date_dim, "time_dim": time_dim, "item": item,
        "store": store, "customer": customer,
        "customer_address": customer_address,
        "customer_demographics": customer_demographics,
        "household_demographics": household_demographics,
        "promotion": promotion, "warehouse": warehouse,
        "ship_mode": ship_mode, "web_site": web_site,
        "store_sales": store_sales, "catalog_sales": catalog_sales,
        "web_sales": web_sales, "inventory": inventory,
    }


DDL = """
create table if not exists date_dim (
  d_date_sk bigint, d_date date, d_year int, d_moy int, d_dom int,
  d_qoy int, d_dow int, d_day_name text, d_month_seq int, d_week_seq int
) distributed replicated;
create table if not exists time_dim (
  t_time_sk bigint, t_hour int, t_minute int
) distributed replicated;
create table if not exists item (
  i_item_sk bigint, i_item_id text, i_item_desc text,
  i_current_price decimal(7,2), i_wholesale_cost decimal(7,2),
  i_brand_id int, i_brand text,
  i_class_id int, i_class text, i_category_id int, i_category text,
  i_manufact_id int, i_manufact text, i_manager_id int
) distributed by (i_item_sk);
create table if not exists store (
  s_store_sk bigint, s_store_id text, s_store_name text,
  s_company_name text, s_state text, s_county text, s_city text,
  s_zip text, s_gmt_offset decimal(5,2)
) distributed replicated;
create table if not exists customer (
  c_customer_sk bigint, c_customer_id text, c_current_cdemo_sk bigint,
  c_current_hdemo_sk bigint, c_current_addr_sk bigint, c_first_name text,
  c_last_name text, c_salutation text, c_preferred_cust_flag text,
  c_birth_month int, c_birth_year int, c_birth_country text
) distributed by (c_customer_sk);
create table if not exists customer_address (
  ca_address_sk bigint, ca_state text, ca_county text, ca_city text,
  ca_zip text, ca_country text, ca_gmt_offset decimal(5,2),
  ca_location_type text
) distributed by (ca_address_sk);
create table if not exists customer_demographics (
  cd_demo_sk bigint, cd_gender text, cd_marital_status text,
  cd_education_status text, cd_purchase_estimate int,
  cd_credit_rating text, cd_dep_count int
) distributed by (cd_demo_sk);
create table if not exists household_demographics (
  hd_demo_sk bigint, hd_income_band_sk bigint, hd_buy_potential text,
  hd_dep_count int, hd_vehicle_count int
) distributed replicated;
create table if not exists promotion (
  p_promo_sk bigint, p_channel_dmail text, p_channel_email text,
  p_channel_tv text, p_channel_event text
) distributed replicated;
create table if not exists warehouse (
  w_warehouse_sk bigint, w_warehouse_name text, w_warehouse_sq_ft int,
  w_state text
) distributed replicated;
create table if not exists ship_mode (
  sm_ship_mode_sk bigint, sm_type text, sm_carrier text
) distributed replicated;
create table if not exists web_site (
  web_site_sk bigint, web_name text
) distributed replicated;
create table if not exists store_sales (
  ss_sold_date_sk bigint, ss_sold_time_sk bigint, ss_item_sk bigint,
  ss_customer_sk bigint, ss_cdemo_sk bigint, ss_hdemo_sk bigint,
  ss_addr_sk bigint, ss_store_sk bigint, ss_promo_sk bigint,
  ss_ticket_number bigint, ss_quantity int,
  ss_wholesale_cost decimal(7,2), ss_list_price decimal(7,2),
  ss_sales_price decimal(7,2), ss_ext_discount_amt decimal(7,2),
  ss_ext_sales_price decimal(7,2), ss_ext_wholesale_cost decimal(7,2),
  ss_ext_list_price decimal(7,2), ss_ext_tax decimal(7,2),
  ss_coupon_amt decimal(7,2), ss_net_paid decimal(7,2),
  ss_net_profit decimal(7,2)
) distributed by (ss_item_sk);
create table if not exists catalog_sales (
  cs_sold_date_sk bigint, cs_ship_date_sk bigint,
  cs_bill_customer_sk bigint, cs_bill_cdemo_sk bigint,
  cs_bill_addr_sk bigint, cs_ship_mode_sk bigint, cs_warehouse_sk bigint,
  cs_item_sk bigint, cs_promo_sk bigint, cs_order_number bigint,
  cs_quantity int, cs_wholesale_cost decimal(7,2),
  cs_list_price decimal(7,2), cs_sales_price decimal(7,2),
  cs_ext_discount_amt decimal(7,2), cs_ext_sales_price decimal(7,2),
  cs_ext_wholesale_cost decimal(7,2), cs_coupon_amt decimal(7,2),
  cs_net_profit decimal(7,2)
) distributed by (cs_item_sk);
create table if not exists web_sales (
  ws_sold_date_sk bigint, ws_ship_date_sk bigint, ws_item_sk bigint,
  ws_bill_customer_sk bigint, ws_bill_addr_sk bigint,
  ws_web_site_sk bigint, ws_ship_mode_sk bigint, ws_warehouse_sk bigint,
  ws_promo_sk bigint, ws_order_number bigint, ws_quantity int,
  ws_wholesale_cost decimal(7,2), ws_list_price decimal(7,2),
  ws_sales_price decimal(7,2), ws_ext_discount_amt decimal(7,2),
  ws_ext_sales_price decimal(7,2), ws_ext_wholesale_cost decimal(7,2),
  ws_net_paid decimal(7,2), ws_net_profit decimal(7,2)
) distributed by (ws_item_sk);
create table if not exists inventory (
  inv_item_sk bigint, inv_warehouse_sk bigint, inv_date_sk bigint,
  inv_quantity_on_hand int
) distributed by (inv_item_sk);
"""

_DEC_COLS = {
    "i_current_price", "i_wholesale_cost", "s_gmt_offset", "ca_gmt_offset",
    "ss_wholesale_cost", "ss_list_price", "ss_sales_price",
    "ss_ext_discount_amt", "ss_ext_sales_price", "ss_ext_wholesale_cost",
    "ss_ext_list_price", "ss_ext_tax", "ss_coupon_amt", "ss_net_paid",
    "ss_net_profit",
    "cs_wholesale_cost", "cs_list_price", "cs_sales_price",
    "cs_ext_discount_amt", "cs_ext_sales_price", "cs_ext_wholesale_cost",
    "cs_coupon_amt", "cs_net_profit",
    "ws_wholesale_cost", "ws_list_price", "ws_sales_price",
    "ws_ext_discount_amt", "ws_ext_sales_price", "ws_ext_wholesale_cost",
    "ws_net_paid", "ws_net_profit",
}


def load(db, scale: float = 1.0, seed: int = 20020101,
         tables: list[str] | None = None) -> dict[str, int]:
    """Create schema + bulk load into a Database -> {table: rows}."""
    db.sql(DDL)
    data = generate(scale, seed)
    for name, cols in data.items():
        if tables is not None and name not in tables:
            continue
        db.load_table(name, cols)
    return {k: len(next(iter(v.values()))) for k, v in data.items()}


def to_pandas(data: dict[str, dict]):
    """Oracle-side view (Coded decoded, decimals descaled to float)."""
    import pandas as pd

    out = {}
    for t, cols in data.items():
        df = {}
        for c, v in cols.items():
            if isinstance(v, Coded):
                df[c] = v.decode()
            elif c in _DEC_COLS:
                df[c] = np.asarray(v, dtype=np.float64) / 100.0
            else:
                df[c] = v
        out[t] = pd.DataFrame(df)
    return out
