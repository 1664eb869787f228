"""TPC-DS table subset generator (BASELINE config #4).

The reference carries the full 99-query TPC-DS templates
(`ydb/library/benchmarks/queries/tpcds/`). This generator produces the
retail-star subset that the supported query shapes touch — store_sales
(fact), date_dim, item, customer, store — with TPC-DS-like domains
(brands/categories/manufacturers, a 5-year calendar). Deterministic.
"""

from __future__ import annotations

import numpy as np

from ydb_tpu_torch.core import dtypes as dt
from ydb_tpu_torch.core.schema import Column, Schema


def _i64(name):
    return Column(name, dt.DType(dt.Kind.INT64, False))


def _f64(name):
    return Column(name, dt.DType(dt.Kind.FLOAT64, False))


def _s(name):
    return Column(name, dt.DType(dt.Kind.STRING, False))


SCHEMAS = {
    "date_dim": (Schema([_i64("d_date_sk"), _i64("d_year"), _i64("d_moy"),
                         _i64("d_dom"), _i64("d_week_seq"),
                         _i64("d_qoy"), _i64("d_dow"),
                         _s("d_day_name")]), ["d_date_sk"]),
    "item": (Schema([_i64("i_item_sk"), _s("i_item_id"),
                     _i64("i_brand_id"), _s("i_brand"),
                     _i64("i_class_id"), _s("i_class"),
                     _i64("i_category_id"), _s("i_category"),
                     _i64("i_manufact_id"), _s("i_manufact"),
                     _i64("i_manager_id"),
                     _f64("i_current_price")]), ["i_item_sk"]),
    "store": (Schema([_i64("s_store_sk"), _s("s_store_name"),
                      _s("s_state"), _i64("s_zip_num")]), ["s_store_sk"]),
    "customer": (Schema([_i64("c_customer_sk"), _i64("c_current_addr_sk"),
                         _i64("c_current_cdemo_sk"),
                         _s("c_first_name"), _s("c_last_name"),
                         _i64("c_birth_year")]), ["c_customer_sk"]),
    "customer_address": (Schema([_i64("ca_address_sk"), _s("ca_state"),
                                 _i64("ca_zip_num")]), ["ca_address_sk"]),
    "customer_demographics": (Schema([_i64("cd_demo_sk"), _s("cd_gender"),
                                      _s("cd_marital_status"),
                                      _s("cd_education_status")]),
                              ["cd_demo_sk"]),
    "household_demographics": (Schema([_i64("hd_demo_sk"),
                                       _i64("hd_dep_count"),
                                       _i64("hd_vehicle_count")]),
                               ["hd_demo_sk"]),
    "time_dim": (Schema([_i64("t_time_sk"), _i64("t_hour"),
                         _i64("t_minute")]), ["t_time_sk"]),
    "promotion": (Schema([_i64("p_promo_sk"), _s("p_channel_email"),
                          _s("p_channel_event")]), ["p_promo_sk"]),
    "store_sales": (Schema([_i64("ss_ticket_sk"), _i64("ss_sold_date_sk"),
                            _i64("ss_sold_time_sk"),
                            _i64("ss_item_sk"), _i64("ss_customer_sk"),
                            _i64("ss_cdemo_sk"), _i64("ss_hdemo_sk"),
                            _i64("ss_promo_sk"),
                            _i64("ss_store_sk"), _i64("ss_quantity"),
                            _f64("ss_sales_price"), _f64("ss_list_price"),
                            _f64("ss_coupon_amt"),
                            _f64("ss_ext_sales_price"),
                            _f64("ss_ext_discount_amt"),
                            _f64("ss_ext_wholesale_cost"),
                            _f64("ss_net_profit")]), ["ss_ticket_sk"]),
    "web_sales": (Schema([_i64("ws_order_sk"), _i64("ws_sold_date_sk"),
                          _i64("ws_sold_time_sk"),
                          _i64("ws_ship_date_sk"),
                          _i64("ws_item_sk"),
                          _i64("ws_bill_customer_sk"),
                          _i64("ws_bill_addr_sk"),
                          _i64("ws_ship_hdemo_sk"),
                          _i64("ws_warehouse_sk"), _i64("ws_promo_sk"),
                          _i64("ws_quantity"),
                          _f64("ws_sales_price"), _f64("ws_list_price"),
                          _f64("ws_ext_sales_price"),
                          _f64("ws_ext_discount_amt"),
                          _f64("ws_net_profit")]), ["ws_order_sk"]),
    "catalog_sales": (Schema([_i64("cs_order_sk"), _i64("cs_sold_date_sk"),
                              _i64("cs_sold_time_sk"),
                              _i64("cs_ship_date_sk"),
                              _i64("cs_item_sk"),
                              _i64("cs_bill_customer_sk"),
                              _i64("cs_bill_cdemo_sk"),
                              _i64("cs_promo_sk"),
                              _i64("cs_warehouse_sk"),
                              _i64("cs_quantity"),
                              _f64("cs_sales_price"),
                              _f64("cs_list_price"),
                              _f64("cs_coupon_amt"),
                              _f64("cs_ext_sales_price"),
                              _f64("cs_ext_discount_amt"),
                              _f64("cs_net_profit")]), ["cs_order_sk"]),
    "store_returns": (Schema([_i64("sr_return_sk"),
                              _i64("sr_returned_date_sk"),
                              _i64("sr_item_sk"), _i64("sr_customer_sk"),
                              _i64("sr_cdemo_sk"),
                              _i64("sr_ticket_sk"),
                              _i64("sr_return_quantity"),
                              _f64("sr_return_amt"),
                              _f64("sr_net_loss")]), ["sr_return_sk"]),
    "web_returns": (Schema([_i64("wr_return_sk"),
                            _i64("wr_returned_date_sk"),
                            _i64("wr_item_sk"), _i64("wr_order_sk"),
                            _i64("wr_returning_customer_sk"),
                            _i64("wr_refunded_cdemo_sk"),
                            _i64("wr_return_quantity"),
                            _f64("wr_return_amt"),
                            _f64("wr_fee")]), ["wr_return_sk"]),
    "warehouse": (Schema([_i64("w_warehouse_sk"), _s("w_warehouse_name"),
                          _s("w_state")]), ["w_warehouse_sk"]),
    "inventory": (Schema([_i64("inv_row_sk"), _i64("inv_date_sk"),
                          _i64("inv_item_sk"), _i64("inv_warehouse_sk"),
                          _i64("inv_quantity_on_hand")]), ["inv_row_sk"]),
}

_CATS = np.array(["Books", "Home", "Electronics", "Jewelry", "Sports",
                  "Music", "Women", "Men", "Children", "Shoes"])
_DAYS = np.array(["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
                  "Friday", "Saturday"])
_STATES = np.array(["TN", "CA", "TX", "OH", "GA", "WA", "NY"])


def gen_tpcds(sf: float = 0.01, seed: int = 20260730) -> dict:
    rng = np.random.default_rng(seed)
    tables: dict = {}

    n_dates = 365 * 5
    d_sk = np.arange(1, n_dates + 1)
    yr = 1998 + (d_sk - 1) // 365
    doy = (d_sk - 1) % 365
    moy = doy // 31 + 1
    tables["date_dim"] = {
        "d_date_sk": d_sk, "d_year": yr, "d_moy": moy,
        "d_dom": doy % 31 + 1, "d_week_seq": (d_sk - 1) // 7 + 1,
        "d_qoy": (moy - 1) // 3 + 1, "d_dow": d_sk % 7,
        "d_day_name": _DAYS[d_sk % 7].astype(object)}

    n_item = max(200, int(1800 * sf * 10))
    i_sk = np.arange(1, n_item + 1)
    brand_id = rng.integers(1, 100, n_item) * 100 + rng.integers(1, 10,
                                                                 n_item)
    cat_ix = rng.integers(0, len(_CATS), n_item)
    manu = rng.integers(1, 100, n_item)
    class_id = rng.integers(1, 17, n_item)
    tables["item"] = {
        "i_item_sk": i_sk,
        "i_item_id": np.array([f"AAAA{k:012d}" for k in i_sk], object),
        "i_brand_id": brand_id,
        "i_brand": np.array([f"brand#{b}" for b in brand_id], object),
        "i_class_id": class_id,
        "i_class": np.array([f"class#{c}" for c in class_id], object),
        "i_category_id": cat_ix + 1,
        "i_category": _CATS[cat_ix].astype(object),
        "i_manufact_id": manu,
        "i_manufact": np.array([f"manu#{m}" for m in manu], object),
        "i_manager_id": rng.integers(1, 100, n_item),
        "i_current_price": (rng.random(n_item) * 100).round(2)}

    n_store = 12
    tables["store"] = {
        "s_store_sk": np.arange(1, n_store + 1),
        "s_store_name": np.array([f"store_{i}" for i in range(n_store)],
                                 object),
        "s_state": _STATES[rng.integers(0, len(_STATES), n_store)]
        .astype(object),
        "s_zip_num": rng.integers(10000, 10040, n_store)}

    n_addr = max(300, int(50_000 * sf))
    tables["customer_address"] = {
        "ca_address_sk": np.arange(1, n_addr + 1),
        "ca_state": _STATES[rng.integers(0, len(_STATES), n_addr)]
        .astype(object),
        "ca_zip_num": rng.integers(10000, 10040, n_addr)}

    n_cdemo = 7 * 6 * 4          # gender x marital x education grid
    n_cust = max(500, int(100_000 * sf))
    tables["customer"] = {
        "c_customer_sk": np.arange(1, n_cust + 1),
        "c_current_addr_sk": rng.integers(1, n_addr + 1, n_cust),
        "c_current_cdemo_sk": rng.integers(1, n_cdemo + 1, n_cust),
        "c_first_name": np.array([f"fn{i % 997}" for i in range(n_cust)],
                                 object),
        "c_last_name": np.array([f"ln{i % 499}" for i in range(n_cust)],
                                object),
        "c_birth_year": rng.integers(1930, 2005, n_cust)}

    # cross-joined demographic/time/promotion dimensions (TPC-DS keeps
    # these small and dense)

    genders = np.array(["M", "F"])
    marital = np.array(["S", "M", "D", "W", "U"])
    edu = np.array(["Primary", "Secondary", "College", "2 yr Degree",
                    "4 yr Degree", "Advanced Degree", "Unknown"])
    cd_sk = np.arange(1, n_cdemo + 1)
    tables["customer_demographics"] = {
        "cd_demo_sk": cd_sk,
        "cd_gender": genders[cd_sk % 2].astype(object),
        "cd_marital_status": marital[cd_sk % 5].astype(object),
        "cd_education_status": edu[cd_sk % 7].astype(object)}

    n_hdemo = 40
    hd_sk = np.arange(1, n_hdemo + 1)
    tables["household_demographics"] = {
        "hd_demo_sk": hd_sk, "hd_dep_count": hd_sk % 10,
        "hd_vehicle_count": hd_sk % 5}

    n_time = 24 * 60
    t_sk = np.arange(1, n_time + 1)
    tables["time_dim"] = {
        "t_time_sk": t_sk, "t_hour": (t_sk - 1) // 60,
        "t_minute": (t_sk - 1) % 60}

    n_promo = 30
    p_sk = np.arange(1, n_promo + 1)
    yn = np.array(["Y", "N"])
    tables["promotion"] = {
        "p_promo_sk": p_sk,
        "p_channel_email": yn[p_sk % 2].astype(object),
        "p_channel_event": yn[(p_sk // 2) % 2].astype(object)}

    n_ss = max(2000, int(2_880_000 * sf))
    tables["store_sales"] = {
        "ss_ticket_sk": np.arange(1, n_ss + 1),
        "ss_sold_date_sk": rng.integers(1, n_dates + 1, n_ss),
        "ss_sold_time_sk": rng.integers(1, n_time + 1, n_ss),
        "ss_item_sk": rng.integers(1, n_item + 1, n_ss),
        "ss_customer_sk": rng.integers(1, n_cust + 1, n_ss),
        "ss_cdemo_sk": rng.integers(1, n_cdemo + 1, n_ss),
        "ss_hdemo_sk": rng.integers(1, n_hdemo + 1, n_ss),
        "ss_promo_sk": rng.integers(1, n_promo + 1, n_ss),
        "ss_store_sk": rng.integers(1, n_store + 1, n_ss),
        "ss_quantity": rng.integers(1, 100, n_ss),
        "ss_sales_price": (rng.random(n_ss) * 200).round(2),
        "ss_list_price": (rng.random(n_ss) * 250).round(2),
        "ss_coupon_amt": (rng.random(n_ss) * 50).round(2),
        "ss_ext_sales_price": (rng.random(n_ss) * 2000).round(2),
        "ss_ext_discount_amt": (rng.random(n_ss) * 120).round(2),
        "ss_ext_wholesale_cost": (rng.random(n_ss) * 900).round(2),
        "ss_net_profit": ((rng.random(n_ss) - 0.3) * 1000).round(2)}

    n_wh = 6
    tables["warehouse"] = {
        "w_warehouse_sk": np.arange(1, n_wh + 1),
        "w_warehouse_name": np.array([f"wh_{i}" for i in range(n_wh)],
                                     object),
        "w_state": _STATES[rng.integers(0, len(_STATES), n_wh)]
        .astype(object)}

    n_ws = max(800, int(720_000 * sf))
    ws_sold = rng.integers(1, n_dates + 1, n_ws)
    tables["web_sales"] = {
        "ws_order_sk": np.arange(1, n_ws + 1),
        "ws_sold_date_sk": ws_sold,
        "ws_sold_time_sk": rng.integers(1, n_time + 1, n_ws),
        "ws_ship_date_sk": np.minimum(ws_sold + rng.integers(1, 120, n_ws),
                                      n_dates),
        "ws_item_sk": rng.integers(1, n_item + 1, n_ws),
        "ws_bill_customer_sk": rng.integers(1, n_cust + 1, n_ws),
        "ws_bill_addr_sk": rng.integers(1, n_addr + 1, n_ws),
        "ws_ship_hdemo_sk": rng.integers(1, n_hdemo + 1, n_ws),
        "ws_warehouse_sk": rng.integers(1, n_wh + 1, n_ws),
        "ws_promo_sk": rng.integers(1, n_promo + 1, n_ws),
        "ws_quantity": rng.integers(1, 100, n_ws),
        "ws_sales_price": (rng.random(n_ws) * 200).round(2),
        "ws_list_price": (rng.random(n_ws) * 250).round(2),
        "ws_ext_sales_price": (rng.random(n_ws) * 2000).round(2),
        "ws_ext_discount_amt": (rng.random(n_ws) * 120).round(2),
        "ws_net_profit": ((rng.random(n_ws) - 0.3) * 1000).round(2)}

    n_cs = max(1200, int(1_440_000 * sf))
    cs_sold = rng.integers(1, n_dates + 1, n_cs)
    tables["catalog_sales"] = {
        "cs_order_sk": np.arange(1, n_cs + 1),
        "cs_sold_date_sk": cs_sold,
        "cs_sold_time_sk": rng.integers(1, n_time + 1, n_cs),
        "cs_ship_date_sk": np.minimum(cs_sold + rng.integers(1, 120, n_cs),
                                      n_dates),
        "cs_item_sk": rng.integers(1, n_item + 1, n_cs),
        "cs_bill_customer_sk": rng.integers(1, n_cust + 1, n_cs),
        "cs_bill_cdemo_sk": rng.integers(1, n_cdemo + 1, n_cs),
        "cs_promo_sk": rng.integers(1, n_promo + 1, n_cs),
        "cs_warehouse_sk": rng.integers(1, n_wh + 1, n_cs),
        "cs_quantity": rng.integers(1, 100, n_cs),
        "cs_sales_price": (rng.random(n_cs) * 200).round(2),
        "cs_list_price": (rng.random(n_cs) * 250).round(2),
        "cs_coupon_amt": (rng.random(n_cs) * 50).round(2),
        "cs_ext_sales_price": (rng.random(n_cs) * 2000).round(2),
        "cs_ext_discount_amt": (rng.random(n_cs) * 120).round(2),
        "cs_net_profit": ((rng.random(n_cs) - 0.3) * 1000).round(2)}

    # ~10% of store tickets return (sr_ticket_sk + sr_item_sk link back)
    n_sr = max(200, n_ss // 10)
    sr_pick = rng.choice(n_ss, n_sr, replace=False)
    tables["store_returns"] = {
        "sr_return_sk": np.arange(1, n_sr + 1),
        "sr_returned_date_sk": np.minimum(
            tables["store_sales"]["ss_sold_date_sk"][sr_pick]
            + rng.integers(1, 90, n_sr), n_dates),
        "sr_item_sk": tables["store_sales"]["ss_item_sk"][sr_pick],
        "sr_customer_sk": tables["store_sales"]["ss_customer_sk"][sr_pick],
        "sr_cdemo_sk": rng.integers(1, n_cdemo + 1, n_sr),
        "sr_ticket_sk": tables["store_sales"]["ss_ticket_sk"][sr_pick],
        "sr_return_quantity": rng.integers(1, 50, n_sr),
        "sr_return_amt": (rng.random(n_sr) * 500).round(2),
        "sr_net_loss": (rng.random(n_sr) * 300).round(2)}

    n_wr = max(80, n_ws // 10)
    wr_pick = rng.choice(n_ws, n_wr, replace=False)
    tables["web_returns"] = {
        "wr_return_sk": np.arange(1, n_wr + 1),
        "wr_returned_date_sk": np.minimum(
            ws_sold[wr_pick] + rng.integers(1, 90, n_wr), n_dates),
        "wr_item_sk": tables["web_sales"]["ws_item_sk"][wr_pick],
        "wr_order_sk": tables["web_sales"]["ws_order_sk"][wr_pick],
        "wr_returning_customer_sk":
            tables["web_sales"]["ws_bill_customer_sk"][wr_pick],
        "wr_refunded_cdemo_sk": rng.integers(1, n_cdemo + 1, n_wr),
        "wr_return_quantity": rng.integers(1, 50, n_wr),
        "wr_return_amt": (rng.random(n_wr) * 500).round(2),
        "wr_fee": (rng.random(n_wr) * 40).round(2)}

    # weekly inventory snapshots per (item, warehouse)
    inv_dates = np.arange(1, n_dates + 1, 7)
    n_inv_items = min(n_item, 400)
    grid = np.array(np.meshgrid(inv_dates,
                                np.arange(1, n_inv_items + 1),
                                np.arange(1, n_wh + 1),
                                indexing="ij")).reshape(3, -1)
    n_inv = grid.shape[1]
    tables["inventory"] = {
        "inv_row_sk": np.arange(1, n_inv + 1),
        "inv_date_sk": grid[0],
        "inv_item_sk": grid[1],
        "inv_warehouse_sk": grid[2],
        "inv_quantity_on_hand": rng.integers(0, 1000, n_inv)}
    return tables


def load_tpcds(catalog, sf: float = 0.01, shards: int = 1,
               portion_rows: int = 1 << 20, seed: int = 20260730) -> dict:
    import pandas as pd

    from ydb_tpu_torch.storage.mvcc import WriteVersion
    tables = gen_tpcds(sf, seed)
    for name, (schema, pk) in SCHEMAS.items():
        t = catalog.create_table(name, schema, pk, shards=shards,
                                 portion_rows=portion_rows)
        t.bulk_upsert(pd.DataFrame(tables[name]), WriteVersion(1, 1))
    return tables
