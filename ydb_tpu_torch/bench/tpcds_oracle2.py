"""TPC-DS templates 47..99 extension (round 5: 46 → 73 shapes).

Same discipline as `tpcds_util.py`: standard TPC-DS query SHAPES over
the generated schema subset (reference templates:
`ydb/library/benchmarks/queries/tpcds/yql/`), each with an exact pandas
oracle. Shapes exercised here that the first 46 lacked: scalar-subquery
select lists (ds28/ds77), windowed CTEs with lag/lead (ds47/ds89),
rank-over CTE joins (ds44/ds70), CTE self-joins (ds74), composite-key
anti/left joins against returns (ds78/ds80/ds97), channel EXCEPT via
anti-IN (ds87), and NOT IN order-set semi-joins (ds94/ds95).
"""

from __future__ import annotations

import numpy as np
import pandas as pd

QUERIES2 = {
    # q6: states whose customers bought items priced 20% over the
    # category average (per-category average via CTE instead of the
    # correlated scalar subquery)
    "ds6": """
with capr as (
  select i_category_id as cid, avg(i_current_price) as ap
  from item group by i_category_id)
select ca.ca_state as state, count(*) as cnt
from customer_address ca
join customer c on c.c_current_addr_sk = ca.ca_address_sk
join store_sales ss on ss.ss_customer_sk = c.c_customer_sk
join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
join item i on i.i_item_sk = ss.ss_item_sk
join capr on capr.cid = i.i_category_id
where d.d_year = 2000 and d.d_moy = 1
  and i.i_current_price > 1.2 * capr.ap
group by ca.ca_state
having count(*) >= 10
order by cnt, state
limit 100""",
    # q8: store net profit for stores in a zip set
    "ds8": """
select s.s_store_name, sum(ss.ss_net_profit) as np
from store_sales ss
join store s on s.s_store_sk = ss.ss_store_sk
join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
where d.d_qoy = 2 and d.d_year = 1998
  and s.s_zip_num in (10001, 10005, 10011, 10017, 10023, 10029, 10035)
group by s.s_store_name
order by s.s_store_name""",
    # q28: bucketed list-price stats as a scalar-subquery select list
    "ds28": """
select
  (select avg(ss_list_price) from store_sales
    where ss_quantity between 0 and 5) as b1_avg,
  (select count(distinct ss_list_price) from store_sales
    where ss_quantity between 0 and 5) as b1_cntd,
  (select avg(ss_list_price) from store_sales
    where ss_quantity between 6 and 10) as b2_avg,
  (select count(distinct ss_list_price) from store_sales
    where ss_quantity between 6 and 10) as b2_cntd,
  (select avg(ss_list_price) from store_sales
    where ss_quantity between 11 and 15) as b3_avg,
  (select count(distinct ss_list_price) from store_sales
    where ss_quantity between 11 and 15) as b3_cntd""",
    # q35: demographics of customers active in store AND (web OR catalog)
    "ds35": """
select cd.cd_gender, cd.cd_marital_status, count(*) as cnt,
       avg(c.c_birth_year) as ab, max(c.c_birth_year) as mb
from customer c
join customer_demographics cd on cd.cd_demo_sk = c.c_current_cdemo_sk
where c.c_customer_sk in (select ss_customer_sk from store_sales)
  and (c.c_customer_sk in (select ws_bill_customer_sk from web_sales)
       or c.c_customer_sk in (select cs_bill_customer_sk
                              from catalog_sales))
group by cd.cd_gender, cd.cd_marital_status
order by cd.cd_gender, cd.cd_marital_status""",
    # q38: customers active in ALL THREE channels in one quarter
    # (INTERSECT shape as chained semi-joins)
    "ds38": """
with sc as (
  select distinct ss.ss_customer_sk as ck from store_sales ss
  join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
  where d.d_year = 2000 and d.d_qoy = 1),
wc as (
  select distinct ws.ws_bill_customer_sk as ck from web_sales ws
  join date_dim d on d.d_date_sk = ws.ws_sold_date_sk
  where d.d_year = 2000 and d.d_qoy = 1),
cc as (
  select distinct cs.cs_bill_customer_sk as ck from catalog_sales cs
  join date_dim d on d.d_date_sk = cs.cs_sold_date_sk
  where d.d_year = 2000 and d.d_qoy = 1)
select count(*) as cnt from sc
where ck in (select ck from wc) and ck in (select ck from cc)""",
    # q41: distinct manufacturers in an id range selling a category
    "ds41": """
select distinct i.i_manufact from item i
where i.i_manufact_id between 30 and 60
  and i.i_manufact in (select i2.i_manufact from item i2
                       where i2.i_category = 'Electronics')
order by i.i_manufact
limit 100""",
    # q44: best and worst items of one store by average profit rank
    "ds44": """
with v as (
  select ss_item_sk as item_sk, avg(ss_net_profit) as rank_col
  from store_sales where ss_store_sk = 4 group by ss_item_sk),
ar as (
  select item_sk, rank() over (order by rank_col) as rnk from v),
dr as (
  select item_sk, rank() over (order by rank_col desc) as rnk from v)
select ar.rnk as rnk, i1.i_item_id as best_performing,
       i2.i_item_id as worst_performing
from ar
join dr on dr.rnk = ar.rnk
join item i1 on i1.i_item_sk = ar.item_sk
join item i2 on i2.i_item_sk = dr.item_sk
where ar.rnk <= 10
order by ar.rnk""",
    # q47: brand monthly sales vs in-year average, with neighbours
    "ds47": """
with v1 as (
  select i.i_brand as i_brand, d.d_moy as d_moy,
         sum(ss.ss_sales_price) as sum_sales
  from store_sales ss
  join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
  join item i on i.i_item_sk = ss.ss_item_sk
  where d.d_year = 2000
  group by i.i_brand, d.d_moy),
v2 as (
  select i_brand, d_moy, sum_sales,
         avg(sum_sales) over (partition by i_brand) as avg_monthly,
         lag(sum_sales) over (partition by i_brand order by d_moy)
           as psum,
         lead(sum_sales) over (partition by i_brand order by d_moy)
           as nsum
  from v1)
select i_brand, d_moy, sum_sales, avg_monthly, psum, nsum
from v2
where sum_sales > 1.1 * avg_monthly
order by i_brand, d_moy
limit 100""",
    # q53: manufacturer quarterly sales beside the all-quarter average
    "ds53": """
with v as (
  select i.i_manufact_id as mid, d.d_qoy as qoy,
         sum(ss.ss_sales_price) as ssp
  from store_sales ss
  join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
  join item i on i.i_item_sk = ss.ss_item_sk
  where d.d_year = 1999 and i.i_category in ('Books', 'Electronics')
  group by i.i_manufact_id, d.d_qoy)
select mid, qoy, ssp, avg(ssp) over (partition by mid) as avg_q
from v
order by mid, qoy
limit 100""",
    # q56 family: one category's item sales across all three channels
    "ds56": """
with sa as (
  select i.i_item_id as item_id, sum(ss.ss_ext_sales_price) as total
  from store_sales ss
  join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
  join item i on i.i_item_sk = ss.ss_item_sk
  where i.i_category = 'Music' and d.d_year = 2000 and d.d_moy = 2
  group by i.i_item_id),
wa as (
  select i.i_item_id as item_id, sum(ws.ws_ext_sales_price) as total
  from web_sales ws
  join date_dim d on d.d_date_sk = ws.ws_sold_date_sk
  join item i on i.i_item_sk = ws.ws_item_sk
  where i.i_category = 'Music' and d.d_year = 2000 and d.d_moy = 2
  group by i.i_item_id),
ca as (
  select i.i_item_id as item_id, sum(cs.cs_ext_sales_price) as total
  from catalog_sales cs
  join date_dim d on d.d_date_sk = cs.cs_sold_date_sk
  join item i on i.i_item_sk = cs.cs_item_sk
  where i.i_category = 'Music' and d.d_year = 2000 and d.d_moy = 2
  group by i.i_item_id)
select item_id, sum(total) as total_sales from (
  select item_id, total from sa
  union all select item_id, total from wa
  union all select item_id, total from ca) u
group by item_id
order by total_sales desc, item_id
limit 100""",
    # q60 family: same union-reaggregation keyed by manufacturer
    "ds60": """
with sa as (
  select i.i_manufact_id as mid, sum(ss.ss_ext_sales_price) as total
  from store_sales ss
  join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
  join item i on i.i_item_sk = ss.ss_item_sk
  where i.i_category = 'Children' and d.d_year = 1999 and d.d_moy = 9
  group by i.i_manufact_id),
wa as (
  select i.i_manufact_id as mid, sum(ws.ws_ext_sales_price) as total
  from web_sales ws
  join date_dim d on d.d_date_sk = ws.ws_sold_date_sk
  join item i on i.i_item_sk = ws.ws_item_sk
  where i.i_category = 'Children' and d.d_year = 1999 and d.d_moy = 9
  group by i.i_manufact_id),
ca as (
  select i.i_manufact_id as mid, sum(cs.cs_ext_sales_price) as total
  from catalog_sales cs
  join date_dim d on d.d_date_sk = cs.cs_sold_date_sk
  join item i on i.i_item_sk = cs.cs_item_sk
  where i.i_category = 'Children' and d.d_year = 1999 and d.d_moy = 9
  group by i.i_manufact_id)
select mid, sum(total) as total_sales from (
  select mid, total from sa
  union all select mid, total from wa
  union all select mid, total from ca) u
group by mid
order by total_sales desc, mid
limit 100""",
    # q62: web shipping-latency buckets per warehouse
    "ds62": """
select w.w_warehouse_name,
  sum(case when ws.ws_ship_date_sk - ws.ws_sold_date_sk <= 30
      then 1 else 0 end) as d30,
  sum(case when ws.ws_ship_date_sk - ws.ws_sold_date_sk > 30
       and ws.ws_ship_date_sk - ws.ws_sold_date_sk <= 60
      then 1 else 0 end) as d60,
  sum(case when ws.ws_ship_date_sk - ws.ws_sold_date_sk > 60
      then 1 else 0 end) as dmore
from web_sales ws
join warehouse w on w.w_warehouse_sk = ws.ws_warehouse_sk
join date_dim d on d.d_date_sk = ws.ws_ship_date_sk
where d.d_year = 2000
group by w.w_warehouse_name
order by w.w_warehouse_name""",
    # q63: manager monthly sales beside the yearly average
    "ds63": """
with v as (
  select i.i_manager_id as mgr, d.d_moy as moy,
         sum(ss.ss_sales_price) as ssp
  from store_sales ss
  join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
  join item i on i.i_item_sk = ss.ss_item_sk
  where d.d_year = 2000 and i.i_manager_id between 1 and 20
  group by i.i_manager_id, d.d_moy)
select mgr, moy, ssp, avg(ssp) over (partition by mgr) as avg_m
from v
order by mgr, moy
limit 100""",
    # q66: warehouse web-sales by month as CASE columns
    "ds66": """
select w.w_warehouse_name, w.w_state,
  sum(case when d.d_moy = 1 then ws.ws_ext_sales_price else 0 end)
    as jan_sales,
  sum(case when d.d_moy = 2 then ws.ws_ext_sales_price else 0 end)
    as feb_sales,
  sum(case when d.d_moy = 3 then ws.ws_ext_sales_price else 0 end)
    as mar_sales,
  sum(case when d.d_moy = 4 then ws.ws_ext_sales_price else 0 end)
    as apr_sales
from web_sales ws
join warehouse w on w.w_warehouse_sk = ws.ws_warehouse_sk
join date_dim d on d.d_date_sk = ws.ws_sold_date_sk
where d.d_year = 2001
group by w.w_warehouse_name, w.w_state
order by w.w_warehouse_name""",
    # q68: per-ticket purchase totals for a household shape
    "ds68": """
with cs as (
  select ss.ss_ticket_sk as ticket, ss.ss_customer_sk as ck,
         sum(ss.ss_ext_sales_price) as extended_price,
         sum(ss.ss_ext_wholesale_cost) as ext_cost
  from store_sales ss
  join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
  join household_demographics hd on hd.hd_demo_sk = ss.ss_hdemo_sk
  where d.d_year = 1999 and hd.hd_dep_count = 4
  group by ss.ss_ticket_sk, ss.ss_customer_sk)
select c.c_last_name, c.c_first_name, cs.ticket, cs.extended_price,
       cs.ext_cost
from cs
join customer c on c.c_customer_sk = cs.ck
order by cs.extended_price desc, cs.ticket
limit 100""",
    # q70: state profit ranking
    "ds70": """
with t as (
  select s.s_state as s_state, sum(ss.ss_net_profit) as total
  from store_sales ss
  join store s on s.s_store_sk = ss.ss_store_sk
  join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
  where d.d_year = 2000
  group by s.s_state)
select s_state, total, rank() over (order by total desc) as rk
from t
order by rk, s_state""",
    # q72: catalog orders whose warehouse stock ran short that day
    "ds72": """
select w.w_warehouse_name, i.i_item_id, count(*) as low_stock
from catalog_sales cs
join item i on i.i_item_sk = cs.cs_item_sk
join warehouse w on w.w_warehouse_sk = cs.cs_warehouse_sk
join inventory inv on inv.inv_item_sk = cs.cs_item_sk
  and inv.inv_warehouse_sk = cs.cs_warehouse_sk
  and inv.inv_date_sk = cs.cs_sold_date_sk
where inv.inv_quantity_on_hand < cs.cs_quantity
group by w.w_warehouse_name, i.i_item_id
order by low_stock desc, w.w_warehouse_name, i.i_item_id
limit 100""",
    # q74: customer year-over-year store profit ratio (CTE self-join)
    "ds74": """
with ss_y as (
  select ss.ss_customer_sk as ck, d.d_year as yr,
         sum(ss.ss_net_profit) as tot
  from store_sales ss
  join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
  where d.d_year in (1999, 2000)
  group by ss.ss_customer_sk, d.d_year)
select a.ck as ck, b.tot / a.tot as ratio
from ss_y a
join ss_y b on b.ck = a.ck
where a.yr = 1999 and b.yr = 2000 and a.tot > 100
order by ratio desc, ck
limit 100""",
    # q77: channel totals as a scalar-subquery report row
    "ds77": """
select
  (select sum(ss_ext_sales_price) from store_sales) as store_sales,
  (select sum(sr_return_amt) from store_returns) as store_returns,
  (select sum(ws_ext_sales_price) from web_sales) as web_sales,
  (select sum(wr_return_amt) from web_returns) as web_returns,
  (select sum(cs_ext_sales_price) from catalog_sales) as catalog_sales""",
    # q78: per-customer-year quantities for sales NEVER returned,
    # store vs web
    "ds78": """
with ss2 as (
  select d.d_year as yr, ss.ss_customer_sk as ck,
         sum(ss.ss_quantity) as qty
  from store_sales ss
  join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
  where ss.ss_ticket_sk not in (select sr_ticket_sk from store_returns)
  group by d.d_year, ss.ss_customer_sk),
ws2 as (
  select d.d_year as yr, ws.ws_bill_customer_sk as ck,
         sum(ws.ws_quantity) as qty
  from web_sales ws
  join date_dim d on d.d_date_sk = ws.ws_sold_date_sk
  where ws.ws_order_sk not in (select wr_order_sk from web_returns)
  group by d.d_year, ws.ws_bill_customer_sk)
select ss2.yr as yr, ss2.ck as ck, ss2.qty as ss_qty, ws2.qty as ws_qty
from ss2
join ws2 on ws2.yr = ss2.yr and ws2.ck = ss2.ck
where ss2.yr = 2000
order by ss_qty desc, ws_qty desc, ck
limit 100""",
    # q80: store report with returns LEFT-joined on (ticket, item)
    "ds80": """
select s.s_store_name, sum(ss.ss_ext_sales_price) as sales,
       sum(sr.sr_return_amt) as returns_amt,
       sum(ss.ss_net_profit) as profit
from store_sales ss
left join store_returns sr on sr.sr_ticket_sk = ss.ss_ticket_sk
  and sr.sr_item_sk = ss.ss_item_sk
join store s on s.s_store_sk = ss.ss_store_sk
join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
where d.d_year = 2000
group by s.s_store_name
order by s.s_store_name""",
    # q87: store-quarter customers who never bought on the web that
    # quarter (EXCEPT as anti-IN)
    "ds87": """
with sc as (
  select distinct ss.ss_customer_sk as ck from store_sales ss
  join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
  where d.d_year = 2000 and d.d_qoy = 2),
wc as (
  select distinct ws.ws_bill_customer_sk as ck from web_sales ws
  join date_dim d on d.d_date_sk = ws.ws_sold_date_sk
  where d.d_year = 2000 and d.d_qoy = 2)
select count(*) as num from sc
where ck not in (select ck from wc)""",
    # q89: brand-store monthly sales 10% under the yearly average
    "ds89": """
with v as (
  select i.i_category as cat, i.i_brand as brand,
         s.s_store_name as store, d.d_moy as moy,
         sum(ss.ss_sales_price) as ssp
  from store_sales ss
  join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
  join item i on i.i_item_sk = ss.ss_item_sk
  join store s on s.s_store_sk = ss.ss_store_sk
  where d.d_year = 1999 and i.i_category in ('Books', 'Music')
  group by i.i_category, i.i_brand, s.s_store_name, d.d_moy),
v2 as (
  select cat, brand, store, moy, ssp,
         avg(ssp) over (partition by cat, brand, store) as avg_m
  from v)
select cat, brand, store, moy, ssp, avg_m
from v2
where ssp < 0.9 * avg_m
order by cat, brand, store, moy
limit 100""",
    # q94: web orders shipped in a year that were never returned
    "ds94": """
select count(distinct ws.ws_order_sk) as order_count,
       sum(ws.ws_ext_sales_price) as total_sales
from web_sales ws
join date_dim d on d.d_date_sk = ws.ws_ship_date_sk
where d.d_year = 2000
  and ws.ws_order_sk not in (select wr_order_sk from web_returns)""",
    # q95: the returned complement of q94
    "ds95": """
select count(distinct ws.ws_order_sk) as order_count,
       sum(ws.ws_ext_sales_price) as total_sales
from web_sales ws
join date_dim d on d.d_date_sk = ws.ws_ship_date_sk
where d.d_year = 2000
  and ws.ws_order_sk in (select wr_order_sk from web_returns)""",
    # q97: store/catalog customer-item overlap via LEFT-join marks
    "ds97": """
with ssci as (
  select distinct ss_customer_sk as ck, ss_item_sk as ik
  from store_sales),
csci as (
  select distinct cs_bill_customer_sk as ck, cs_item_sk as ik
  from catalog_sales)
select sum(case when csci.ck is null then 1 else 0 end) as store_only,
       sum(case when csci.ck is not null then 1 else 0 end)
         as store_and_catalog
from ssci
left join csci on csci.ck = ssci.ck and csci.ik = ssci.ik""",
    # q99: catalog shipping-latency buckets per warehouse
    "ds99": """
select w.w_warehouse_name,
  sum(case when cs.cs_ship_date_sk - cs.cs_sold_date_sk <= 30
      then 1 else 0 end) as d30,
  sum(case when cs.cs_ship_date_sk - cs.cs_sold_date_sk > 30
       and cs.cs_ship_date_sk - cs.cs_sold_date_sk <= 60
      then 1 else 0 end) as d60,
  sum(case when cs.cs_ship_date_sk - cs.cs_sold_date_sk > 60
      then 1 else 0 end) as dmore
from catalog_sales cs
join warehouse w on w.w_warehouse_sk = cs.cs_warehouse_sk
join date_dim d on d.d_date_sk = cs.cs_ship_date_sk
where d.d_year = 2000
group by w.w_warehouse_name
order by w.w_warehouse_name""",
}


def oracle2(name: str, f: dict) -> pd.DataFrame:
    ss, d, i, s = f["store_sales"], f["date_dim"], f["item"], f["store"]
    j = ss.merge(d, left_on="ss_sold_date_sk", right_on="d_date_sk") \
          .merge(i, left_on="ss_item_sk", right_on="i_item_sk")

    if name == "ds6":
        capr = i.groupby("i_category_id", as_index=False) \
                .i_current_price.mean() \
                .rename(columns={"i_category_id": "cid",
                                 "i_current_price": "ap"})
        ca, c = f["customer_address"], f["customer"]
        x = j.merge(c, left_on="ss_customer_sk",
                    right_on="c_customer_sk") \
             .merge(ca, left_on="c_current_addr_sk",
                    right_on="ca_address_sk") \
             .merge(capr, left_on="i_category_id", right_on="cid")
        x = x[(x.d_year == 2000) & (x.d_moy == 1)
              & (x.i_current_price > 1.2 * x.ap)]
        g = x.groupby("ca_state").size().reset_index(name="cnt")
        g = g[g.cnt >= 10].rename(columns={"ca_state": "state"})
        return g.sort_values(["cnt", "state"], kind="stable").head(100)

    if name == "ds8":
        zips = {10001, 10005, 10011, 10017, 10023, 10029, 10035}
        x = ss.merge(s, left_on="ss_store_sk", right_on="s_store_sk") \
              .merge(d, left_on="ss_sold_date_sk", right_on="d_date_sk")
        x = x[(x.d_qoy == 2) & (x.d_year == 1998)
              & (x.s_zip_num.isin(zips))]
        g = x.groupby("s_store_name", as_index=False).ss_net_profit.sum()
        return g.sort_values("s_store_name").rename(
            columns={"ss_net_profit": "np"})

    if name == "ds28":
        out = {}
        for k, (lo, hi) in enumerate([(0, 5), (6, 10), (11, 15)], 1):
            b = ss[(ss.ss_quantity >= lo) & (ss.ss_quantity <= hi)]
            out[f"b{k}_avg"] = [b.ss_list_price.mean()]
            out[f"b{k}_cntd"] = [b.ss_list_price.nunique()]
        return pd.DataFrame(out)

    if name == "ds35":
        c, cd = f["customer"], f["customer_demographics"]
        ws, cs = f["web_sales"], f["catalog_sales"]
        in_ss = c.c_customer_sk.isin(ss.ss_customer_sk)
        in_ws = c.c_customer_sk.isin(ws.ws_bill_customer_sk)
        in_cs = c.c_customer_sk.isin(cs.cs_bill_customer_sk)
        x = c[in_ss & (in_ws | in_cs)].merge(
            cd, left_on="c_current_cdemo_sk", right_on="cd_demo_sk")
        g = x.groupby(["cd_gender", "cd_marital_status"],
                      as_index=False).agg(
            cnt=("c_customer_sk", "size"), ab=("c_birth_year", "mean"),
            mb=("c_birth_year", "max"))
        return g.sort_values(["cd_gender", "cd_marital_status"])

    if name == "ds38":
        ws, cs = f["web_sales"], f["catalog_sales"]
        def chan(df, dk, ck):
            x = df.merge(d, left_on=dk, right_on="d_date_sk")
            x = x[(x.d_year == 2000) & (x.d_qoy == 1)]
            return set(x[ck])
        scs = chan(ss, "ss_sold_date_sk", "ss_customer_sk")
        wcs = chan(ws, "ws_sold_date_sk", "ws_bill_customer_sk")
        ccs = chan(cs, "cs_sold_date_sk", "cs_bill_customer_sk")
        return pd.DataFrame({"cnt": [len(scs & wcs & ccs)]})

    if name == "ds41":
        elec = set(i[i.i_category == "Electronics"].i_manufact)
        x = i[(i.i_manufact_id >= 30) & (i.i_manufact_id <= 60)
              & i.i_manufact.isin(elec)]
        out = sorted(set(x.i_manufact))[:100]
        return pd.DataFrame({"i_manufact": out})

    if name == "ds44":
        v = ss[ss.ss_store_sk == 4].groupby(
            "ss_item_sk", as_index=False).ss_net_profit.mean() \
            .rename(columns={"ss_item_sk": "item_sk",
                             "ss_net_profit": "rank_col"})
        v["rnk_a"] = v.rank_col.rank(method="min").astype(np.int64)
        v["rnk_d"] = v.rank_col.rank(method="min",
                                     ascending=False).astype(np.int64)
        a = v[v.rnk_a <= 10][["item_sk", "rnk_a"]] \
            .rename(columns={"rnk_a": "rnk"})
        b = v[["item_sk", "rnk_d"]].rename(columns={"rnk_d": "rnk"})
        m = a.merge(b, on="rnk", suffixes=("_a", "_d")) \
             .merge(i[["i_item_sk", "i_item_id"]],
                    left_on="item_sk_a", right_on="i_item_sk") \
             .rename(columns={"i_item_id": "best_performing"}) \
             .merge(i[["i_item_sk", "i_item_id"]],
                    left_on="item_sk_d", right_on="i_item_sk") \
             .rename(columns={"i_item_id": "worst_performing"})
        return m.sort_values("rnk")[
            ["rnk", "best_performing", "worst_performing"]]

    if name == "ds47":
        x = j[j.d_year == 2000]
        v1 = x.groupby(["i_brand", "d_moy"], as_index=False) \
              .ss_sales_price.sum() \
              .rename(columns={"ss_sales_price": "sum_sales"})
        v1 = v1.sort_values(["i_brand", "d_moy"], kind="stable")
        v1["avg_monthly"] = v1.groupby("i_brand") \
                              .sum_sales.transform("mean")
        v1["psum"] = v1.groupby("i_brand").sum_sales.shift(1)
        v1["nsum"] = v1.groupby("i_brand").sum_sales.shift(-1)
        out = v1[v1.sum_sales > 1.1 * v1.avg_monthly]
        return out.sort_values(["i_brand", "d_moy"],
                               kind="stable").head(100)

    if name in ("ds53", "ds63"):
        if name == "ds53":
            x = j[(j.d_year == 1999)
                  & (j.i_category.isin(["Books", "Electronics"]))]
            keys, kcol, vcol = ["i_manufact_id", "d_qoy"], \
                "i_manufact_id", "d_qoy"
            out_names = ["mid", "qoy"]
        else:
            x = j[(j.d_year == 2000) & (j.i_manager_id >= 1)
                  & (j.i_manager_id <= 20)]
            keys, kcol, vcol = ["i_manager_id", "d_moy"], \
                "i_manager_id", "d_moy"
            out_names = ["mgr", "moy"]
        v = x.groupby(keys, as_index=False).ss_sales_price.sum() \
             .rename(columns={keys[0]: out_names[0],
                              keys[1]: out_names[1],
                              "ss_sales_price": "ssp"})
        v["avg_col"] = v.groupby(out_names[0]).ssp.transform("mean")
        v = v.sort_values(out_names, kind="stable").head(100)
        v.columns = [*out_names, "ssp",
                     "avg_q" if name == "ds53" else "avg_m"]
        return v

    if name in ("ds56", "ds60"):
        ws, cs = f["web_sales"], f["catalog_sales"]
        if name == "ds56":
            cat, yr, moy, key = "Music", 2000, 2, "i_item_id"
        else:
            cat, yr, moy, key = "Children", 1999, 9, "i_manufact_id"
        def chan(df, dk, ik, vk):
            x = df.merge(d, left_on=dk, right_on="d_date_sk") \
                  .merge(i, left_on=ik, right_on="i_item_sk")
            x = x[(x.i_category == cat) & (x.d_year == yr)
                  & (x.d_moy == moy)]
            return x.groupby(key, as_index=False)[vk].sum() \
                    .rename(columns={vk: "total"})
        u = pd.concat([
            chan(ss, "ss_sold_date_sk", "ss_item_sk",
                 "ss_ext_sales_price"),
            chan(ws, "ws_sold_date_sk", "ws_item_sk",
                 "ws_ext_sales_price"),
            chan(cs, "cs_sold_date_sk", "cs_item_sk",
                 "cs_ext_sales_price")], ignore_index=True)
        g = u.groupby(key, as_index=False).total.sum() \
             .rename(columns={"total": "total_sales"})
        out_key = "item_id" if name == "ds56" else "mid"
        g = g.rename(columns={key: out_key})
        return g.sort_values(["total_sales", out_key],
                             ascending=[False, True],
                             kind="stable").head(100)

    if name in ("ds62", "ds99"):
        w = f["warehouse"]
        if name == "ds62":
            df, dk, sold, wkey = f["web_sales"], "ws_ship_date_sk", \
                "ws_sold_date_sk", "ws_warehouse_sk"
        else:
            df, dk, sold, wkey = f["catalog_sales"], "cs_ship_date_sk", \
                "cs_sold_date_sk", "cs_warehouse_sk"
        x = df.merge(w, left_on=wkey, right_on="w_warehouse_sk") \
              .merge(d, left_on=dk, right_on="d_date_sk")
        x = x[x.d_year == 2000]
        lat = x[dk] - x[sold]
        g = x.assign(
            d30=(lat <= 30).astype(np.int64),
            d60=((lat > 30) & (lat <= 60)).astype(np.int64),
            dmore=(lat > 60).astype(np.int64)) \
            .groupby("w_warehouse_name", as_index=False)[
            ["d30", "d60", "dmore"]].sum()
        return g.sort_values("w_warehouse_name")

    if name == "ds66":
        w, ws = f["warehouse"], f["web_sales"]
        x = ws.merge(w, left_on="ws_warehouse_sk",
                     right_on="w_warehouse_sk") \
              .merge(d, left_on="ws_sold_date_sk", right_on="d_date_sk")
        x = x[x.d_year == 2001]
        for m, nm in ((1, "jan_sales"), (2, "feb_sales"),
                      (3, "mar_sales"), (4, "apr_sales")):
            x[nm] = np.where(x.d_moy == m, x.ws_ext_sales_price, 0.0)
        g = x.groupby(["w_warehouse_name", "w_state"], as_index=False)[
            ["jan_sales", "feb_sales", "mar_sales", "apr_sales"]].sum()
        return g.sort_values("w_warehouse_name")

    if name == "ds68":
        hd, c = f["household_demographics"], f["customer"]
        x = ss.merge(d, left_on="ss_sold_date_sk", right_on="d_date_sk") \
              .merge(hd, left_on="ss_hdemo_sk", right_on="hd_demo_sk")
        x = x[(x.d_year == 1999) & (x.hd_dep_count == 4)]
        g = x.groupby(["ss_ticket_sk", "ss_customer_sk"],
                      as_index=False).agg(
            extended_price=("ss_ext_sales_price", "sum"),
            ext_cost=("ss_ext_wholesale_cost", "sum"))
        g = g.merge(c, left_on="ss_customer_sk",
                    right_on="c_customer_sk") \
             .rename(columns={"ss_ticket_sk": "ticket"})
        return g.sort_values(["extended_price", "ticket"],
                             ascending=[False, True],
                             kind="stable").head(100)[
            ["c_last_name", "c_first_name", "ticket", "extended_price",
             "ext_cost"]]

    if name == "ds70":
        x = ss.merge(s, left_on="ss_store_sk", right_on="s_store_sk") \
              .merge(d, left_on="ss_sold_date_sk", right_on="d_date_sk")
        x = x[x.d_year == 2000]
        g = x.groupby("s_state", as_index=False).ss_net_profit.sum() \
             .rename(columns={"ss_net_profit": "total"})
        g["rk"] = g.total.rank(method="min",
                               ascending=False).astype(np.int64)
        return g.sort_values(["rk", "s_state"], kind="stable")

    if name == "ds72":
        cs, inv, w = f["catalog_sales"], f["inventory"], f["warehouse"]
        x = cs.merge(i, left_on="cs_item_sk", right_on="i_item_sk") \
              .merge(w, left_on="cs_warehouse_sk",
                     right_on="w_warehouse_sk") \
              .merge(inv, left_on=["cs_item_sk", "cs_warehouse_sk",
                                   "cs_sold_date_sk"],
                     right_on=["inv_item_sk", "inv_warehouse_sk",
                               "inv_date_sk"])
        x = x[x.inv_quantity_on_hand < x.cs_quantity]
        g = x.groupby(["w_warehouse_name", "i_item_id"]).size() \
             .reset_index(name="low_stock")
        return g.sort_values(["low_stock", "w_warehouse_name",
                              "i_item_id"],
                             ascending=[False, True, True],
                             kind="stable").head(100)

    if name == "ds74":
        x = ss.merge(d, left_on="ss_sold_date_sk", right_on="d_date_sk")
        x = x[x.d_year.isin([1999, 2000])]
        g = x.groupby(["ss_customer_sk", "d_year"],
                      as_index=False).ss_net_profit.sum() \
             .rename(columns={"ss_customer_sk": "ck", "d_year": "yr",
                              "ss_net_profit": "tot"})
        a = g[(g.yr == 1999) & (g.tot > 100)]
        b = g[g.yr == 2000]
        m = a.merge(b, on="ck", suffixes=("_a", "_b"))
        m["ratio"] = m.tot_b / m.tot_a
        return m.sort_values(["ratio", "ck"], ascending=[False, True],
                             kind="stable").head(100)[["ck", "ratio"]]

    if name == "ds77":
        sr, ws, wr, cs = (f["store_returns"], f["web_sales"],
                          f["web_returns"], f["catalog_sales"])
        return pd.DataFrame({
            "store_sales": [ss.ss_ext_sales_price.sum()],
            "store_returns": [sr.sr_return_amt.sum()],
            "web_sales": [ws.ws_ext_sales_price.sum()],
            "web_returns": [wr.wr_return_amt.sum()],
            "catalog_sales": [cs.cs_ext_sales_price.sum()]})

    if name == "ds78":
        sr, ws, wr = f["store_returns"], f["web_sales"], f["web_returns"]
        ss_keep = ss[~ss.ss_ticket_sk.isin(sr.sr_ticket_sk)]
        ss2 = ss_keep.merge(d, left_on="ss_sold_date_sk",
                            right_on="d_date_sk") \
            .groupby(["d_year", "ss_customer_sk"], as_index=False) \
            .ss_quantity.sum() \
            .rename(columns={"d_year": "yr", "ss_customer_sk": "ck",
                             "ss_quantity": "ss_qty"})
        ws_keep = ws[~ws.ws_order_sk.isin(wr.wr_order_sk)]
        ws2 = ws_keep.merge(d, left_on="ws_sold_date_sk",
                            right_on="d_date_sk") \
            .groupby(["d_year", "ws_bill_customer_sk"],
                     as_index=False).ws_quantity.sum() \
            .rename(columns={"d_year": "yr",
                             "ws_bill_customer_sk": "ck",
                             "ws_quantity": "ws_qty"})
        m = ss2.merge(ws2, on=["yr", "ck"])
        m = m[m.yr == 2000]
        return m.sort_values(["ss_qty", "ws_qty", "ck"],
                             ascending=[False, False, True],
                             kind="stable").head(100)

    if name == "ds80":
        sr = f["store_returns"]
        x = ss.merge(sr[["sr_ticket_sk", "sr_item_sk", "sr_return_amt"]],
                     left_on=["ss_ticket_sk", "ss_item_sk"],
                     right_on=["sr_ticket_sk", "sr_item_sk"],
                     how="left") \
              .merge(s, left_on="ss_store_sk", right_on="s_store_sk") \
              .merge(d, left_on="ss_sold_date_sk", right_on="d_date_sk")
        x = x[x.d_year == 2000]
        g = x.groupby("s_store_name", as_index=False).agg(
            sales=("ss_ext_sales_price", "sum"),
            returns_amt=("sr_return_amt", "sum"),
            profit=("ss_net_profit", "sum"))
        return g.sort_values("s_store_name")

    if name == "ds87":
        ws = f["web_sales"]
        xs = ss.merge(d, left_on="ss_sold_date_sk", right_on="d_date_sk")
        xs = xs[(xs.d_year == 2000) & (xs.d_qoy == 2)]
        xw = ws.merge(d, left_on="ws_sold_date_sk", right_on="d_date_sk")
        xw = xw[(xw.d_year == 2000) & (xw.d_qoy == 2)]
        num = len(set(xs.ss_customer_sk) - set(xw.ws_bill_customer_sk))
        return pd.DataFrame({"num": [num]})

    if name == "ds89":
        x = j[(j.d_year == 1999) & (j.i_category.isin(["Books", "Music"]))]
        x = x.merge(s, left_on="ss_store_sk", right_on="s_store_sk")
        v = x.groupby(["i_category", "i_brand", "s_store_name", "d_moy"],
                      as_index=False).ss_sales_price.sum() \
             .rename(columns={"i_category": "cat", "i_brand": "brand",
                              "s_store_name": "store", "d_moy": "moy",
                              "ss_sales_price": "ssp"})
        v["avg_m"] = v.groupby(["cat", "brand", "store"]) \
                      .ssp.transform("mean")
        out = v[v.ssp < 0.9 * v.avg_m]
        return out.sort_values(["cat", "brand", "store", "moy"],
                               kind="stable").head(100)

    if name in ("ds94", "ds95"):
        ws, wr = f["web_sales"], f["web_returns"]
        x = ws.merge(d, left_on="ws_ship_date_sk", right_on="d_date_sk")
        x = x[x.d_year == 2000]
        ret = x.ws_order_sk.isin(wr.wr_order_sk)
        x = x[~ret] if name == "ds94" else x[ret]
        return pd.DataFrame({
            "order_count": [x.ws_order_sk.nunique()],
            "total_sales": [x.ws_ext_sales_price.sum()
                            if len(x) else None]})

    if name == "ds97":
        cs = f["catalog_sales"]
        ssci = ss[["ss_customer_sk", "ss_item_sk"]].drop_duplicates()
        csci = set(zip(cs.cs_bill_customer_sk, cs.cs_item_sk))
        both = sum((ck, ik) in csci for ck, ik in
                   zip(ssci.ss_customer_sk, ssci.ss_item_sk))
        return pd.DataFrame({"store_only": [len(ssci) - both],
                             "store_and_catalog": [both]})

    raise KeyError(name)
