"""TPC-DS query subset + pandas oracles.

Standard TPC-DS query shapes (the reference templates live in
`ydb/library/benchmarks/queries/tpcds/`): star joins over store_sales
with date/item/store dimensions, grouped reports with LIMIT, and the
rank-over-partition window pattern of the q67 family.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

QUERIES = {
    # q3: brand report for one manufacturer in December
    "ds3": """
select d.d_year, i.i_brand_id, i.i_brand, sum(ss.ss_ext_sales_price) as sum_agg
from store_sales ss
join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
join item i on i.i_item_sk = ss.ss_item_sk
where i.i_manufact_id = 28 and d.d_moy = 12
group by d.d_year, i.i_brand_id, i.i_brand
order by d.d_year, sum_agg desc, i.i_brand_id
limit 100""",
    # q42: category report for one year/month
    "ds42": """
select d.d_year, i.i_category_id, i.i_category, sum(ss.ss_ext_sales_price) as s
from store_sales ss
join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
join item i on i.i_item_sk = ss.ss_item_sk
where d.d_moy = 11 and d.d_year = 2000
group by d.d_year, i.i_category_id, i.i_category
order by s desc, d.d_year, i.i_category_id, i.i_category
limit 100""",
    # q52: brand report for one year/month
    "ds52": """
select d.d_year, i.i_brand_id, i.i_brand, sum(ss.ss_ext_sales_price) as ext_price
from store_sales ss
join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
join item i on i.i_item_sk = ss.ss_item_sk
where d.d_moy = 11 and d.d_year = 2000
group by d.d_year, i.i_brand_id, i.i_brand
order by d.d_year, ext_price desc, i.i_brand_id
limit 100""",
    # q55: brand revenue for one manager-month shape
    "ds55": """
select i.i_brand_id, i.i_brand, sum(ss.ss_ext_sales_price) as ext_price
from store_sales ss
join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
join item i on i.i_item_sk = ss.ss_item_sk
where d.d_moy = 11 and d.d_year = 1999 and i.i_manufact_id < 40
group by i.i_brand_id, i.i_brand
order by ext_price desc, i.i_brand_id
limit 100""",
    # q67 family: rank categories' sales within state via a windowed CTE
    "ds67": """
with sales as (
  select s.s_state as s_state, i.i_category as i_category,
         sum(ss.ss_net_profit) as profit
  from store_sales ss
  join store s on s.s_store_sk = ss.ss_store_sk
  join item i on i.i_item_sk = ss.ss_item_sk
  group by s.s_state, i.i_category
)
select s_state, i_category, profit,
       rank() over (partition by s_state order by profit desc) as rk
from sales
order by s_state, rk, i_category""",
    # q7: demographic/promotion average report (official form)
    "ds7": """
select i.i_item_id, avg(ss.ss_quantity) as agg1,
       avg(ss.ss_list_price) as agg2, avg(ss.ss_coupon_amt) as agg3,
       avg(ss.ss_sales_price) as agg4
from store_sales ss
join customer_demographics cd on cd.cd_demo_sk = ss.ss_cdemo_sk
join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
join item i on i.i_item_sk = ss.ss_item_sk
join promotion p on p.p_promo_sk = ss.ss_promo_sk
where cd.cd_gender = 'M' and cd.cd_marital_status = 'S'
  and cd.cd_education_status = 'College'
  and (p.p_channel_email = 'N' or p.p_channel_event = 'N')
  and d.d_year = 2000
group by i.i_item_id
order by i.i_item_id
limit 100""",
    # q19: brand report where the customer's zip differs from the store's
    # (zip prefixes carried as ints; the reference compares substr(zip,1,5))
    "ds19": """
select i.i_brand_id, i.i_brand, i.i_manufact_id, i.i_manufact,
       sum(ss.ss_ext_sales_price) as ext_price
from store_sales ss
join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
join item i on i.i_item_sk = ss.ss_item_sk
join customer c on c.c_customer_sk = ss.ss_customer_sk
join customer_address ca on ca.ca_address_sk = c.c_current_addr_sk
join store s on s.s_store_sk = ss.ss_store_sk
where d.d_moy = 11 and d.d_year = 1999 and i.i_manager_id = 8
  and ca.ca_zip_num <> s.s_zip_num
group by i.i_brand_id, i.i_brand, i.i_manufact_id, i.i_manufact
order by ext_price desc, i.i_brand_id, i.i_manufact_id
limit 100""",
    # q33 family: per-manufacturer category sales across channels,
    # UNION ALL re-aggregated (two channels in this schema subset)
    "ds33": """
with ssr as (
  select i.i_manufact_id as i_manufact_id,
         sum(ss.ss_ext_sales_price) as total_sales
  from store_sales ss
  join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
  join item i on i.i_item_sk = ss.ss_item_sk
  where i.i_category = 'Electronics' and d.d_year = 1998 and d.d_moy = 5
  group by i.i_manufact_id),
wsr as (
  select i.i_manufact_id as i_manufact_id,
         sum(ws.ws_ext_sales_price) as total_sales
  from web_sales ws
  join date_dim d on d.d_date_sk = ws.ws_sold_date_sk
  join item i on i.i_item_sk = ws.ws_item_sk
  where i.i_category = 'Electronics' and d.d_year = 1998 and d.d_moy = 5
  group by i.i_manufact_id)
select i_manufact_id, sum(total_sales) as total_sales
from (select * from ssr union all select * from wsr) as tmp
group by i_manufact_id
order by total_sales desc, i_manufact_id
limit 100""",
    # q59 family: week-over-week per-store day-of-week sales ratios
    # (CASE-pivoted weekly CTE self-joined at a 52-week offset)
    "ds59": """
with wss as (
  select d.d_week_seq as d_week_seq, ss.ss_store_sk as ss_store_sk,
         sum(case when d.d_day_name = 'Sunday'
             then ss.ss_sales_price end) as sun_sales,
         sum(case when d.d_day_name = 'Monday'
             then ss.ss_sales_price end) as mon_sales,
         sum(case when d.d_day_name = 'Friday'
             then ss.ss_sales_price end) as fri_sales
  from store_sales ss
  join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
  group by d.d_week_seq, ss.ss_store_sk)
select s.s_store_name, y.d_week_seq,
       y.sun_sales / x.sun_sales as r1,
       y.mon_sales / x.mon_sales as r2,
       y.fri_sales / x.fri_sales as r3
from wss y
join wss x on y.ss_store_sk = x.ss_store_sk
join store s on s.s_store_sk = y.ss_store_sk
where y.d_week_seq >= 20 and y.d_week_seq <= 25
  and x.d_week_seq = y.d_week_seq + 52
order by s.s_store_name, y.d_week_seq
limit 100""",
    # q65: items selling at <=10% of their store's average revenue
    "ds65": """
with sc as (
  select ss.ss_store_sk as ss_store_sk, ss.ss_item_sk as ss_item_sk,
         sum(ss.ss_sales_price) as revenue
  from store_sales ss group by ss.ss_store_sk, ss.ss_item_sk),
sb as (
  select sc.ss_store_sk as ss_store_sk, avg(sc.revenue) as ave
  from sc group by sc.ss_store_sk)
select s.s_store_name, i.i_item_id, sc.revenue
from sb
join sc on sc.ss_store_sk = sb.ss_store_sk
join store s on s.s_store_sk = sc.ss_store_sk
join item i on i.i_item_sk = sc.ss_item_sk
where sc.revenue <= 0.1 * sb.ave
order by s.s_store_name, i.i_item_id
limit 100""",
    # q88 family: store-hour traffic slots as scalar subqueries
    "ds88": """
select
 (select count(*) from store_sales ss
   join household_demographics hd on hd.hd_demo_sk = ss.ss_hdemo_sk
   join time_dim t on t.t_time_sk = ss.ss_sold_time_sk
   join store s on s.s_store_sk = ss.ss_store_sk
   where t.t_hour = 8 and t.t_minute >= 30 and hd.hd_dep_count = 4
     and s.s_store_name = 'store_1') as h8_30,
 (select count(*) from store_sales ss
   join household_demographics hd on hd.hd_demo_sk = ss.ss_hdemo_sk
   join time_dim t on t.t_time_sk = ss.ss_sold_time_sk
   join store s on s.s_store_sk = ss.ss_store_sk
   where t.t_hour = 9 and t.t_minute < 30 and hd.hd_dep_count = 4
     and s.s_store_name = 'store_1') as h9_00,
 (select count(*) from store_sales ss
   join household_demographics hd on hd.hd_demo_sk = ss.ss_hdemo_sk
   join time_dim t on t.t_time_sk = ss.ss_sold_time_sk
   join store s on s.s_store_sk = ss.ss_store_sk
   where t.t_hour = 9 and t.t_minute >= 30 and hd.hd_dep_count = 4
     and s.s_store_name = 'store_1') as h9_30,
 (select count(*) from store_sales ss
   join household_demographics hd on hd.hd_demo_sk = ss.ss_hdemo_sk
   join time_dim t on t.t_time_sk = ss.ss_sold_time_sk
   join store s on s.s_store_sk = ss.ss_store_sk
   where t.t_hour = 10 and t.t_minute < 30 and hd.hd_dep_count = 4
     and s.s_store_name = 'store_1') as h10_00""",
    # q96: half-hour store traffic count
    "ds96": """
select count(*) as cnt
from store_sales ss
join household_demographics hd on hd.hd_demo_sk = ss.ss_hdemo_sk
join time_dim t on t.t_time_sk = ss.ss_sold_time_sk
join store s on s.s_store_sk = ss.ss_store_sk
where t.t_hour = 20 and t.t_minute >= 30 and hd.hd_dep_count = 7
  and s.s_store_name = 'store_2'""",
    # q98: revenue share of each item within its class (the official
    # windowed-ratio form: the window sits inside the ratio expression)
    "ds98": """
with rev as (
  select i.i_item_id as i_item_id, i.i_class as i_class,
         i.i_category as i_category,
         sum(ss.ss_ext_sales_price) as itemrevenue
  from store_sales ss
  join item i on i.i_item_sk = ss.ss_item_sk
  join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
  where i.i_category in ('Sports', 'Books', 'Home') and d.d_year = 1999
    and d.d_moy >= 2 and d.d_moy <= 3
  group by i.i_item_id, i.i_class, i.i_category)
select i_item_id, i_class, i_category, itemrevenue,
       itemrevenue * 100 / sum(itemrevenue)
           over (partition by i_class) as revenueratio
from rev
order by i_category, i_class, i_item_id, itemrevenue, revenueratio
limit 100""",
    # q73 family: frequent buyers via a HAVING derived table joined back
    "ds73": """
select c.c_last_name, c.c_first_name, dj.cnt
from (
  select ss.ss_customer_sk as ss_customer_sk, count(*) as cnt
  from store_sales ss
  join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
  where d.d_year = 2000
  group by ss.ss_customer_sk
  having count(*) > 8
) as dj
join customer c on c.c_customer_sk = dj.ss_customer_sk
order by dj.cnt desc, c.c_last_name, c.c_first_name
limit 50""",
    # q9: quantity-band ratios as arithmetic over scalar subqueries
    "ds9": """
select
 (select avg(ss_ext_discount_amt) from store_sales
   where ss_quantity between 1 and 20)
 / (select avg(ss_net_profit) from store_sales
     where ss_quantity between 1 and 20) as r1,
 (select avg(ss_ext_discount_amt) from store_sales
   where ss_quantity between 21 and 40)
 / (select avg(ss_net_profit) from store_sales
     where ss_quantity between 21 and 40) as r2,
 (select count(*) from store_sales
   where ss_quantity between 41 and 60) as c3""",
    # q12: web item class revenue share over a two-month window
    "ds12": """
with rev as (
  select i.i_item_id as i_item_id, i.i_class as i_class,
         i.i_category as i_category,
         sum(ws.ws_ext_sales_price) as itemrevenue
  from web_sales ws
  join item i on i.i_item_sk = ws.ws_item_sk
  join date_dim d on d.d_date_sk = ws.ws_sold_date_sk
  where i.i_category in ('Sports', 'Books', 'Home') and d.d_year = 1999
    and d.d_moy >= 2 and d.d_moy <= 3
  group by i.i_item_id, i.i_class, i.i_category)
select i_item_id, i_class, i_category, itemrevenue,
       itemrevenue * 100 / sum(itemrevenue)
           over (partition by i_class) as revenueratio
from rev
order by i_category, i_class, i_item_id, itemrevenue, revenueratio
limit 100""",
    # q13: global averages under OR'd demographic/price bands
    "ds13": """
select avg(ss.ss_quantity) as a1, avg(ss.ss_ext_sales_price) as a2,
       avg(ss.ss_ext_wholesale_cost) as a3,
       sum(ss.ss_ext_wholesale_cost) as a4
from store_sales ss
join store s on s.s_store_sk = ss.ss_store_sk
join customer_demographics cd on cd.cd_demo_sk = ss.ss_cdemo_sk
join household_demographics hd on hd.hd_demo_sk = ss.ss_hdemo_sk
join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
where d.d_year = 2001
  and ((cd.cd_marital_status = 'M' and cd.cd_education_status = 'College'
        and ss.ss_sales_price between 100 and 150 and hd.hd_dep_count = 3)
    or (cd.cd_marital_status = 'S' and cd.cd_education_status = 'Primary'
        and ss.ss_sales_price between 50 and 100 and hd.hd_dep_count = 1)
    or (cd.cd_marital_status = 'W'
        and cd.cd_education_status = '2 yr Degree'
        and ss.ss_sales_price between 150 and 200
        and hd.hd_dep_count = 1))""",
    # q15: catalog sales by customer zip for one quarter
    "ds15": """
select ca.ca_zip_num, sum(cs.cs_sales_price) as s
from catalog_sales cs
join customer c on c.c_customer_sk = cs.cs_bill_customer_sk
join customer_address ca on ca.ca_address_sk = c.c_current_addr_sk
join date_dim d on d.d_date_sk = cs.cs_sold_date_sk
where (ca.ca_zip_num in (10001, 10005, 10010, 10017, 10025)
       or ca.ca_state in ('CA', 'WA', 'GA')
       or cs.cs_sales_price > 180)
  and d.d_qoy = 2 and d.d_year = 2001
group by ca.ca_zip_num
order by ca.ca_zip_num
limit 100""",
    # q18: catalog demographic averages incl. buyer birth year
    "ds18": """
select i.i_item_id, avg(cs.cs_quantity) as a1,
       avg(cs.cs_list_price) as a2, avg(cs.cs_coupon_amt) as a3,
       avg(cs.cs_sales_price) as a4, avg(c.c_birth_year) as a5
from catalog_sales cs
join customer_demographics cd on cd.cd_demo_sk = cs.cs_bill_cdemo_sk
join customer c on c.c_customer_sk = cs.cs_bill_customer_sk
join date_dim d on d.d_date_sk = cs.cs_sold_date_sk
join item i on i.i_item_sk = cs.cs_item_sk
where cd.cd_gender = 'F' and cd.cd_education_status = 'Unknown'
  and d.d_year = 1998
  and c.c_birth_year >= 1950 and c.c_birth_year <= 1970
group by i.i_item_id
order by i.i_item_id
limit 100""",
    # q20: catalog item class revenue share
    "ds20": """
with rev as (
  select i.i_item_id as i_item_id, i.i_class as i_class,
         i.i_category as i_category,
         sum(cs.cs_ext_sales_price) as itemrevenue
  from catalog_sales cs
  join item i on i.i_item_sk = cs.cs_item_sk
  join date_dim d on d.d_date_sk = cs.cs_sold_date_sk
  where i.i_category in ('Sports', 'Books', 'Home') and d.d_year = 1999
    and d.d_moy >= 2 and d.d_moy <= 3
  group by i.i_item_id, i.i_class, i.i_category)
select i_item_id, i_class, i_category, itemrevenue,
       itemrevenue * 100 / sum(itemrevenue)
           over (partition by i_class) as revenueratio
from rev
order by i_category, i_class, i_item_id, itemrevenue, revenueratio
limit 100""",
    # q21: warehouse inventory before/after a pivot date
    "ds21": """
select w.w_warehouse_name, i.i_item_id,
       sum(case when d.d_date_sk < 1095
           then inv.inv_quantity_on_hand else 0 end) as inv_before,
       sum(case when d.d_date_sk >= 1095
           then inv.inv_quantity_on_hand else 0 end) as inv_after
from inventory inv
join warehouse w on w.w_warehouse_sk = inv.inv_warehouse_sk
join item i on i.i_item_sk = inv.inv_item_sk
join date_dim d on d.d_date_sk = inv.inv_date_sk
where i.i_current_price between 40 and 60
  and d.d_date_sk between 1065 and 1125
group by w.w_warehouse_name, i.i_item_id
order by w.w_warehouse_name, i.i_item_id
limit 100""",
    # q22: average quantity on hand per item for one year
    "ds22": """
select i.i_item_id, avg(inv.inv_quantity_on_hand) as qoh
from inventory inv
join date_dim d on d.d_date_sk = inv.inv_date_sk
join item i on i.i_item_sk = inv.inv_item_sk
where d.d_year = 2000
group by i.i_item_id
order by qoh, i.i_item_id
limit 100""",
    # q25: store sale -> return -> catalog re-purchase profit chain
    "ds25": """
select i.i_item_id, s.s_store_name,
       sum(ss.ss_net_profit) as store_profit,
       sum(sr.sr_net_loss) as return_loss,
       sum(cs.cs_net_profit) as catalog_profit
from store_sales ss
join store_returns sr on sr.sr_ticket_sk = ss.ss_ticket_sk
join catalog_sales cs on cs.cs_bill_customer_sk = sr.sr_customer_sk
join store s on s.s_store_sk = ss.ss_store_sk
join item i on i.i_item_sk = ss.ss_item_sk
join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
where d.d_year = 2000 and d.d_moy = 4
group by i.i_item_id, s.s_store_name
order by i.i_item_id, s.s_store_name
limit 100""",
    # q26: catalog demographic/promotion averages
    "ds26": """
select i.i_item_id, avg(cs.cs_quantity) as agg1,
       avg(cs.cs_list_price) as agg2, avg(cs.cs_coupon_amt) as agg3,
       avg(cs.cs_sales_price) as agg4
from catalog_sales cs
join customer_demographics cd on cd.cd_demo_sk = cs.cs_bill_cdemo_sk
join date_dim d on d.d_date_sk = cs.cs_sold_date_sk
join item i on i.i_item_sk = cs.cs_item_sk
join promotion p on p.p_promo_sk = cs.cs_promo_sk
where cd.cd_gender = 'F' and cd.cd_marital_status = 'W'
  and cd.cd_education_status = 'Primary'
  and (p.p_channel_email = 'N' or p.p_channel_event = 'N')
  and d.d_year = 2000
group by i.i_item_id
order by i.i_item_id
limit 100""",
    # q27: store-state demographic averages (plain-group form of the
    # official rollup)
    "ds27": """
select i.i_item_id, s.s_state, avg(ss.ss_quantity) as agg1,
       avg(ss.ss_list_price) as agg2, avg(ss.ss_coupon_amt) as agg3,
       avg(ss.ss_sales_price) as agg4
from store_sales ss
join customer_demographics cd on cd.cd_demo_sk = ss.ss_cdemo_sk
join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
join store s on s.s_store_sk = ss.ss_store_sk
join item i on i.i_item_sk = ss.ss_item_sk
where cd.cd_gender = 'M' and cd.cd_marital_status = 'S'
  and cd.cd_education_status = 'College' and d.d_year = 2002
group by i.i_item_id, s.s_state
order by i.i_item_id, s.s_state
limit 100""",
    # q29: quantities along the sale -> return -> catalog chain
    "ds29": """
select i.i_item_id, s.s_store_name,
       sum(ss.ss_quantity) as store_qty,
       sum(sr.sr_return_quantity) as return_qty,
       sum(cs.cs_quantity) as catalog_qty
from store_sales ss
join store_returns sr on sr.sr_ticket_sk = ss.ss_ticket_sk
join catalog_sales cs on cs.cs_bill_customer_sk = sr.sr_customer_sk
join store s on s.s_store_sk = ss.ss_store_sk
join item i on i.i_item_sk = ss.ss_item_sk
join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
where d.d_year = 1999 and d.d_moy = 9
group by i.i_item_id, s.s_store_name
order by i.i_item_id, s.s_store_name
limit 100""",
    # q32: catalog excess discount vs 1.3x the item's window average
    "ds32": """
select sum(cs.cs_ext_discount_amt) as excess_discount
from catalog_sales cs
join item i on i.i_item_sk = cs.cs_item_sk
join date_dim d on d.d_date_sk = cs.cs_sold_date_sk
where i.i_manufact_id = 7 and d.d_year = 2000
  and cs.cs_ext_discount_amt > (
    select 1.3 * avg(cs2.cs_ext_discount_amt)
    from catalog_sales cs2
    join date_dim d2 on d2.d_date_sk = cs2.cs_sold_date_sk
    where cs2.cs_item_sk = cs.cs_item_sk and d2.d_year = 2000)""",
    # q34/q73 family: party-sized tickets joined back to buyers
    "ds34": """
select c.c_last_name, c.c_first_name, dj.cnt
from (
  select ss.ss_customer_sk as ss_customer_sk, count(*) as cnt
  from store_sales ss
  join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
  join household_demographics hd on hd.hd_demo_sk = ss.ss_hdemo_sk
  where d.d_year = 2000 and hd.hd_vehicle_count > 1
  group by ss.ss_customer_sk
  having count(*) >= 4
) as dj
join customer c on c.c_customer_sk = dj.ss_customer_sk
where dj.cnt <= 20
order by c.c_last_name, c.c_first_name, dj.cnt desc
limit 100""",
    # q37: catalog items with mid-range inventory in a date window
    "ds37": """
select i.i_item_id, i.i_current_price
from item i
join inventory inv on inv.inv_item_sk = i.i_item_sk
join date_dim d on d.d_date_sk = inv.inv_date_sk
where i.i_current_price between 20 and 50
  and inv.inv_quantity_on_hand between 100 and 500
  and d.d_date_sk between 1100 and 1160
  and i.i_item_sk in (select cs_item_sk from catalog_sales)
group by i.i_item_id, i.i_current_price
order by i.i_item_id
limit 100""",
    # q40 family: web sales net of returns before/after a pivot date
    "ds40": """
select w.w_state, i.i_item_id,
       sum(case when d.d_date_sk < 900
           then ws.ws_sales_price - coalesce(wr.wr_return_amt, 0)
           else 0 end) as sales_before,
       sum(case when d.d_date_sk >= 900
           then ws.ws_sales_price - coalesce(wr.wr_return_amt, 0)
           else 0 end) as sales_after
from web_sales ws
left join web_returns wr on wr.wr_order_sk = ws.ws_order_sk
join warehouse w on w.w_warehouse_sk = ws.ws_warehouse_sk
join item i on i.i_item_sk = ws.ws_item_sk
join date_dim d on d.d_date_sk = ws.ws_sold_date_sk
where d.d_date_sk between 840 and 960
group by w.w_state, i.i_item_id
order by w.w_state, i.i_item_id
limit 100""",
    # q43: store day-of-week sales pivot for one year
    "ds43": """
select s.s_store_name, s.s_store_sk,
       sum(case when d.d_day_name = 'Sunday'
           then ss.ss_sales_price else 0 end) as sun_sales,
       sum(case when d.d_day_name = 'Monday'
           then ss.ss_sales_price else 0 end) as mon_sales,
       sum(case when d.d_day_name = 'Wednesday'
           then ss.ss_sales_price else 0 end) as wed_sales,
       sum(case when d.d_day_name = 'Saturday'
           then ss.ss_sales_price else 0 end) as sat_sales
from date_dim d
join store_sales ss on d.d_date_sk = ss.ss_sold_date_sk
join store s on s.s_store_sk = ss.ss_store_sk
where d.d_year = 2000
group by s.s_store_name, s.s_store_sk
order by s.s_store_name, s.s_store_sk
limit 100""",
    # q45: web sales by customer zip subset for one quarter
    "ds45": """
select ca.ca_zip_num, sum(ws.ws_sales_price) as s
from web_sales ws
join customer c on c.c_customer_sk = ws.ws_bill_customer_sk
join customer_address ca on ca.ca_address_sk = c.c_current_addr_sk
join date_dim d on d.d_date_sk = ws.ws_sold_date_sk
where ca.ca_zip_num in (10001, 10005, 10010, 10015, 10020)
  and d.d_qoy = 2 and d.d_year = 2001
group by ca.ca_zip_num
order by ca.ca_zip_num""",
    # q46 family: per-buyer store profit for dependent-heavy households
    "ds46": """
select c.c_last_name, c.c_first_name, sum(ss.ss_coupon_amt) as amt,
       sum(ss.ss_net_profit) as profit
from store_sales ss
join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
join store s on s.s_store_sk = ss.ss_store_sk
join household_demographics hd on hd.hd_demo_sk = ss.ss_hdemo_sk
join customer c on c.c_customer_sk = ss.ss_customer_sk
where (hd.hd_dep_count = 5 or hd.hd_vehicle_count = 3)
  and d.d_dow in (6, 0) and d.d_year = 1999
group by c.c_last_name, c.c_first_name
order by c.c_last_name, c.c_first_name, profit
limit 100""",
    # q48: total quantity under OR'd demographic/price/state bands
    "ds48": """
select sum(ss.ss_quantity) as q
from store_sales ss
join store s on s.s_store_sk = ss.ss_store_sk
join customer_demographics cd on cd.cd_demo_sk = ss.ss_cdemo_sk
join customer c on c.c_customer_sk = ss.ss_customer_sk
join customer_address ca on ca.ca_address_sk = c.c_current_addr_sk
join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
where d.d_year = 2001
  and ((cd.cd_marital_status = 'M' and cd.cd_education_status = 'College'
        and ss.ss_sales_price between 100 and 150)
    or (cd.cd_marital_status = 'D'
        and cd.cd_education_status = 'Secondary'
        and ss.ss_sales_price between 50 and 100))
  and ca.ca_state in ('TX', 'OH', 'NY')""",
    # q50: return-lag day bands per store
    "ds50": """
select s.s_store_name,
       sum(case when sr.sr_returned_date_sk - ss.ss_sold_date_sk <= 30
           then 1 else 0 end) as d30,
       sum(case when sr.sr_returned_date_sk - ss.ss_sold_date_sk > 30
                 and sr.sr_returned_date_sk - ss.ss_sold_date_sk <= 60
           then 1 else 0 end) as d60,
       sum(case when sr.sr_returned_date_sk - ss.ss_sold_date_sk > 60
           then 1 else 0 end) as d90
from store_sales ss
join store_returns sr on sr.sr_ticket_sk = ss.ss_ticket_sk
join store s on s.s_store_sk = ss.ss_store_sk
join date_dim d on d.d_date_sk = sr.sr_returned_date_sk
where d.d_year = 2001 and d.d_moy = 8
group by s.s_store_name
order by s.s_store_name
limit 100""",
    # q58 family: items selling comparably across all three channels
    "ds58": """
with ssr as (
  select i.i_item_id as item_id, sum(ss.ss_ext_sales_price) as ss_rev
  from store_sales ss
  join item i on i.i_item_sk = ss.ss_item_sk
  join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
  where d.d_year = 2000 and d.d_moy = 6
  group by i.i_item_id),
csr as (
  select i.i_item_id as item_id, sum(cs.cs_ext_sales_price) as cs_rev
  from catalog_sales cs
  join item i on i.i_item_sk = cs.cs_item_sk
  join date_dim d on d.d_date_sk = cs.cs_sold_date_sk
  where d.d_year = 2000 and d.d_moy = 6
  group by i.i_item_id),
wsr as (
  select i.i_item_id as item_id, sum(ws.ws_ext_sales_price) as ws_rev
  from web_sales ws
  join item i on i.i_item_sk = ws.ws_item_sk
  join date_dim d on d.d_date_sk = ws.ws_sold_date_sk
  where d.d_year = 2000 and d.d_moy = 6
  group by i.i_item_id)
select ssr.item_id, ssr.ss_rev, csr.cs_rev, wsr.ws_rev,
       (ssr.ss_rev + csr.cs_rev + wsr.ws_rev) / 3 as average
from ssr
join csr on csr.item_id = ssr.item_id
join wsr on wsr.item_id = ssr.item_id
where ssr.ss_rev >= 0.5 * csr.cs_rev and ssr.ss_rev <= 2 * csr.cs_rev
  and ssr.ss_rev >= 0.5 * wsr.ws_rev and ssr.ss_rev <= 2 * wsr.ws_rev
order by ssr.item_id, ssr.ss_rev
limit 100""",
    # q61: promotional share of store revenue (ratio of two scalars)
    "ds61": """
select
 (select sum(ss.ss_ext_sales_price) from store_sales ss
   join promotion p on p.p_promo_sk = ss.ss_promo_sk
   join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
   where d.d_year = 1998 and d.d_moy = 11
     and (p.p_channel_email = 'Y' or p.p_channel_event = 'Y'))
 * 100 /
 (select sum(ss.ss_ext_sales_price) from store_sales ss
   join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
   where d.d_year = 1998 and d.d_moy = 11) as promo_pct""",
    # q69: demographic profile of store-only shoppers
    "ds69": """
select cd.cd_gender, cd.cd_marital_status, cd.cd_education_status,
       count(*) as cnt
from customer c
join customer_demographics cd on cd.cd_demo_sk = c.c_current_cdemo_sk
where exists (select * from store_sales ss
              where ss.ss_customer_sk = c.c_customer_sk)
  and not exists (select * from web_sales ws
                  where ws.ws_bill_customer_sk = c.c_customer_sk)
group by cd.cd_gender, cd.cd_marital_status, cd.cd_education_status
order by cd.cd_gender, cd.cd_marital_status, cd.cd_education_status
limit 100""",
    # q71: brand revenue by hour across all three channels
    "ds71": """
select i.i_brand_id, i.i_brand, t.t_hour, sum(tmp.ext_price) as ext_price
from (
  select ws.ws_ext_sales_price as ext_price,
         ws.ws_item_sk as sold_item_sk,
         ws.ws_sold_time_sk as time_sk
  from web_sales ws
  join date_dim d on d.d_date_sk = ws.ws_sold_date_sk
  where d.d_moy = 11 and d.d_year = 1999
  union all
  select cs.cs_ext_sales_price, cs.cs_item_sk, cs.cs_sold_time_sk
  from catalog_sales cs
  join date_dim d on d.d_date_sk = cs.cs_sold_date_sk
  where d.d_moy = 11 and d.d_year = 1999
  union all
  select ss.ss_ext_sales_price, ss.ss_item_sk, ss.ss_sold_time_sk
  from store_sales ss
  join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
  where d.d_moy = 11 and d.d_year = 1999
) as tmp
join item i on i.i_item_sk = tmp.sold_item_sk
join time_dim t on t.t_time_sk = tmp.time_sk
where i.i_manager_id = 1
group by i.i_brand_id, i.i_brand, t.t_hour
order by ext_price desc, i.i_brand_id, t.t_hour
limit 100""",
    # q76 family: channel/category revenue via a three-way UNION ALL
    "ds76": """
select tmp.chan, tmp.i_category, count(*) as cnt, sum(tmp.sales) as s
from (
  select 1 as chan, i.i_category as i_category,
         ss.ss_ext_sales_price as sales
  from store_sales ss
  join item i on i.i_item_sk = ss.ss_item_sk
  where ss.ss_hdemo_sk = 13
  union all
  select 2 as chan, i.i_category as i_category,
         ws.ws_ext_sales_price as sales
  from web_sales ws
  join item i on i.i_item_sk = ws.ws_item_sk
  where ws.ws_promo_sk = 7
  union all
  select 3 as chan, i.i_category as i_category,
         cs.cs_ext_sales_price as sales
  from catalog_sales cs
  join item i on i.i_item_sk = cs.cs_item_sk
  where cs.cs_warehouse_sk = 2
) as tmp
group by tmp.chan, tmp.i_category
order by tmp.chan, tmp.i_category
limit 100""",
    # q79: per-buyer store profit for large households
    "ds79": """
select c.c_last_name, c.c_first_name, s.s_store_name,
       sum(ss.ss_coupon_amt) as amt, sum(ss.ss_net_profit) as profit
from store_sales ss
join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
join store s on s.s_store_sk = ss.ss_store_sk
join household_demographics hd on hd.hd_demo_sk = ss.ss_hdemo_sk
join customer c on c.c_customer_sk = ss.ss_customer_sk
where (hd.hd_dep_count = 8 or hd.hd_vehicle_count > 3)
  and d.d_dow = 1 and d.d_year = 2000
group by c.c_last_name, c.c_first_name, s.s_store_name
order by c.c_last_name, c.c_first_name, s.s_store_name, profit
limit 100""",
    # q82: store items with mid-range inventory in a date window
    "ds82": """
select i.i_item_id, i.i_current_price
from item i
join inventory inv on inv.inv_item_sk = i.i_item_sk
join date_dim d on d.d_date_sk = inv.inv_date_sk
where i.i_current_price between 60 and 90
  and inv.inv_quantity_on_hand between 100 and 500
  and d.d_date_sk between 720 and 780
  and i.i_item_sk in (select ss_item_sk from store_sales)
group by i.i_item_id, i.i_current_price
order by i.i_item_id
limit 100""",
    # q85 family: web returns profiled by refunding demographics
    "ds85": """
select cd.cd_marital_status, cd.cd_education_status,
       avg(wr.wr_return_quantity) as q, avg(wr.wr_fee) as fee,
       avg(wr.wr_return_amt) as amt
from web_returns wr
join customer_demographics cd on cd.cd_demo_sk = wr.wr_refunded_cdemo_sk
join date_dim d on d.d_date_sk = wr.wr_returned_date_sk
where d.d_year = 2000
group by cd.cd_marital_status, cd.cd_education_status
order by cd.cd_marital_status, cd.cd_education_status
limit 100""",
    # q90: morning/evening web traffic ratio
    "ds90": """
select
 (select count(*) from web_sales ws
   join household_demographics hd
     on hd.hd_demo_sk = ws.ws_ship_hdemo_sk
   join time_dim t on t.t_time_sk = ws.ws_sold_time_sk
   where t.t_hour between 8 and 9 and hd.hd_dep_count = 6)
 as am_cnt,
 (select count(*) from web_sales ws
   join household_demographics hd
     on hd.hd_demo_sk = ws.ws_ship_hdemo_sk
   join time_dim t on t.t_time_sk = ws.ws_sold_time_sk
   where t.t_hour between 19 and 20 and hd.hd_dep_count = 6)
 as pm_cnt""",
    # q92: web excess discount vs 1.3x the item's window average
    "ds92": """
select sum(ws.ws_ext_discount_amt) as excess_discount
from web_sales ws
join item i on i.i_item_sk = ws.ws_item_sk
join date_dim d on d.d_date_sk = ws.ws_sold_date_sk
where i.i_manufact_id = 3 and d.d_year = 2000
  and ws.ws_ext_discount_amt > (
    select 1.3 * avg(ws2.ws_ext_discount_amt)
    from web_sales ws2
    join date_dim d2 on d2.d_date_sk = ws2.ws_sold_date_sk
    where ws2.ws_item_sk = ws.ws_item_sk and d2.d_year = 2000)""",
    # q93: store revenue net of returned quantities per customer
    "ds93": """
select dj.cust, sum(dj.act_sales) as sumsales
from (
  select ss.ss_customer_sk as cust,
         case when sr.sr_return_quantity is not null
              then (ss.ss_quantity - sr.sr_return_quantity)
                   * ss.ss_sales_price
              else ss.ss_quantity * ss.ss_sales_price end as act_sales
  from store_sales ss
  left join store_returns sr on sr.sr_ticket_sk = ss.ss_ticket_sk
) as dj
group by dj.cust
order by sumsales desc, dj.cust
limit 100""",
}


def _frames(raw):
    return {k: pd.DataFrame(v) for k, v in raw.items()}


def oracle(name: str, raw: dict) -> pd.DataFrame:
    f = _frames(raw)
    ss, d, i, s = f["store_sales"], f["date_dim"], f["item"], f["store"]
    j = ss.merge(d, left_on="ss_sold_date_sk", right_on="d_date_sk") \
          .merge(i, left_on="ss_item_sk", right_on="i_item_sk")
    if name == "ds3":
        x = j[(j.i_manufact_id == 28) & (j.d_moy == 12)]
        g = x.groupby(["d_year", "i_brand_id", "i_brand"],
                      as_index=False).ss_ext_sales_price.sum()
        g = g.rename(columns={"ss_ext_sales_price": "sum_agg"})
        return g.sort_values(["d_year", "sum_agg", "i_brand_id"],
                             ascending=[True, False, True],
                             kind="stable").head(100)
    if name in ("ds42", "ds52", "ds55"):
        if name == "ds55":
            x = j[(j.d_moy == 11) & (j.d_year == 1999)
                  & (j.i_manufact_id < 40)]
            g = x.groupby(["i_brand_id", "i_brand"],
                          as_index=False).ss_ext_sales_price.sum()
            return g.sort_values(["ss_ext_sales_price", "i_brand_id"],
                                 ascending=[False, True],
                                 kind="stable").head(100)
        x = j[(j.d_moy == 11) & (j.d_year == 2000)]
        if name == "ds42":
            g = x.groupby(["d_year", "i_category_id", "i_category"],
                          as_index=False).ss_ext_sales_price.sum()
            return g.sort_values(
                ["ss_ext_sales_price", "d_year", "i_category_id",
                 "i_category"], ascending=[False, True, True, True],
                kind="stable").head(100)[
                ["d_year", "i_category_id", "i_category",
                 "ss_ext_sales_price"]]
        g = x.groupby(["d_year", "i_brand_id", "i_brand"],
                      as_index=False).ss_ext_sales_price.sum()
        return g.sort_values(["d_year", "ss_ext_sales_price", "i_brand_id"],
                             ascending=[True, False, True],
                             kind="stable").head(100)
    if name == "ds67":
        js = ss.merge(s, left_on="ss_store_sk", right_on="s_store_sk") \
               .merge(i, left_on="ss_item_sk", right_on="i_item_sk")
        g = js.groupby(["s_state", "i_category"],
                       as_index=False).ss_net_profit.sum() \
              .rename(columns={"ss_net_profit": "profit"})
        g["rk"] = g.groupby("s_state").profit.rank(
            method="min", ascending=False).astype(np.int64)
        return g.sort_values(["s_state", "rk", "i_category"],
                             kind="stable")
    if name == "ds7":
        cd, p = f["customer_demographics"], f["promotion"]
        x = j.merge(cd, left_on="ss_cdemo_sk", right_on="cd_demo_sk") \
             .merge(p, left_on="ss_promo_sk", right_on="p_promo_sk")
        x = x[(x.cd_gender == "M") & (x.cd_marital_status == "S")
              & (x.cd_education_status == "College")
              & ((x.p_channel_email == "N") | (x.p_channel_event == "N"))
              & (x.d_year == 2000)]
        g = x.groupby("i_item_id", as_index=False).agg(
            agg1=("ss_quantity", "mean"), agg2=("ss_list_price", "mean"),
            agg3=("ss_coupon_amt", "mean"), agg4=("ss_sales_price", "mean"))
        return g.sort_values("i_item_id").head(100)
    if name == "ds19":
        c, ca = f["customer"], f["customer_address"]
        x = j.merge(c, left_on="ss_customer_sk", right_on="c_customer_sk") \
             .merge(ca, left_on="c_current_addr_sk",
                    right_on="ca_address_sk") \
             .merge(s, left_on="ss_store_sk", right_on="s_store_sk")
        x = x[(x.d_moy == 11) & (x.d_year == 1999) & (x.i_manager_id == 8)
              & (x.ca_zip_num != x.s_zip_num)]
        g = x.groupby(["i_brand_id", "i_brand", "i_manufact_id",
                       "i_manufact"], as_index=False) \
             .ss_ext_sales_price.sum() \
             .rename(columns={"ss_ext_sales_price": "ext_price"})
        return g.sort_values(["ext_price", "i_brand_id", "i_manufact_id"],
                             ascending=[False, True, True],
                             kind="stable").head(100)[
            ["i_brand_id", "i_brand", "i_manufact_id", "i_manufact",
             "ext_price"]]
    if name == "ds33":
        ws = f["web_sales"]
        xs = j[(j.i_category == "Electronics") & (j.d_year == 1998)
               & (j.d_moy == 5)]
        ssr = xs.groupby("i_manufact_id", as_index=False) \
                .ss_ext_sales_price.sum() \
                .rename(columns={"ss_ext_sales_price": "total_sales"})
        xw = ws.merge(d, left_on="ws_sold_date_sk", right_on="d_date_sk") \
               .merge(i, left_on="ws_item_sk", right_on="i_item_sk")
        xw = xw[(xw.i_category == "Electronics") & (xw.d_year == 1998)
                & (xw.d_moy == 5)]
        wsr = xw.groupby("i_manufact_id", as_index=False) \
                .ws_ext_sales_price.sum() \
                .rename(columns={"ws_ext_sales_price": "total_sales"})
        u = pd.concat([ssr, wsr], ignore_index=True)
        g = u.groupby("i_manufact_id", as_index=False).total_sales.sum()
        return g.sort_values(["total_sales", "i_manufact_id"],
                             ascending=[False, True],
                             kind="stable").head(100)
    if name == "ds59":
        x = ss.merge(d, left_on="ss_sold_date_sk", right_on="d_date_sk")
        def dow(day):
            v = x.ss_sales_price.where(x.d_day_name == day)
            return v
        x = x.assign(sun=dow("Sunday"), mon=dow("Monday"),
                     fri=dow("Friday"))
        wss = x.groupby(["d_week_seq", "ss_store_sk"], as_index=False) \
               .agg(sun_sales=("sun", "sum"), mon_sales=("mon", "sum"),
                    fri_sales=("fri", "sum"),
                    sun_n=("sun", "count"), mon_n=("mon", "count"),
                    fri_n=("fri", "count"))
        for col in ("sun", "mon", "fri"):
            wss[f"{col}_sales"] = wss[f"{col}_sales"] \
                .where(wss[f"{col}_n"] > 0)
        y = wss[(wss.d_week_seq >= 20) & (wss.d_week_seq <= 25)]
        xx = wss.copy()
        m = y.merge(xx, left_on=["ss_store_sk"], right_on=["ss_store_sk"],
                    suffixes=("_y", "_x"))
        m = m[m.d_week_seq_x == m.d_week_seq_y + 52]
        m = m.merge(s, left_on="ss_store_sk", right_on="s_store_sk")
        out = pd.DataFrame({
            "s_store_name": m.s_store_name,
            "d_week_seq": m.d_week_seq_y,
            "r1": m.sun_sales_y / m.sun_sales_x,
            "r2": m.mon_sales_y / m.mon_sales_x,
            "r3": m.fri_sales_y / m.fri_sales_x})
        return out.sort_values(["s_store_name", "d_week_seq"],
                               kind="stable").head(100)
    if name == "ds65":
        sc = ss.groupby(["ss_store_sk", "ss_item_sk"], as_index=False) \
               .ss_sales_price.sum() \
               .rename(columns={"ss_sales_price": "revenue"})
        sb = sc.groupby("ss_store_sk", as_index=False).revenue.mean() \
               .rename(columns={"revenue": "ave"})
        m = sc.merge(sb, on="ss_store_sk")
        m = m[m.revenue <= 0.1 * m.ave]
        m = m.merge(s, left_on="ss_store_sk", right_on="s_store_sk") \
             .merge(i, left_on="ss_item_sk", right_on="i_item_sk")
        return m.sort_values(["s_store_name", "i_item_id"],
                             kind="stable").head(100)[
            ["s_store_name", "i_item_id", "revenue"]]
    if name in ("ds88", "ds96"):
        hd, t = f["household_demographics"], f["time_dim"]
        x = ss.merge(hd, left_on="ss_hdemo_sk", right_on="hd_demo_sk") \
              .merge(t, left_on="ss_sold_time_sk", right_on="t_time_sk") \
              .merge(s, left_on="ss_store_sk", right_on="s_store_sk")
        if name == "ds96":
            n = len(x[(x.t_hour == 20) & (x.t_minute >= 30)
                      & (x.hd_dep_count == 7)
                      & (x.s_store_name == "store_2")])
            return pd.DataFrame({"cnt": [n]})
        base = x[(x.hd_dep_count == 4) & (x.s_store_name == "store_1")]
        def slot(h, half):
            mm = base[(base.t_hour == h)
                      & ((base.t_minute >= 30) if half
                         else (base.t_minute < 30))]
            return len(mm)
        return pd.DataFrame({"h8_30": [slot(8, True)],
                             "h9_00": [slot(9, False)],
                             "h9_30": [slot(9, True)],
                             "h10_00": [slot(10, False)]})
    if name == "ds98":
        x = j[j.i_category.isin(["Sports", "Books", "Home"])
              & (j.d_year == 1999) & (j.d_moy >= 2) & (j.d_moy <= 3)]
        g = x.groupby(["i_item_id", "i_class", "i_category"],
                      as_index=False).ss_ext_sales_price.sum() \
             .rename(columns={"ss_ext_sales_price": "itemrevenue"})
        g["classrevenue"] = g.groupby("i_class").itemrevenue \
                             .transform("sum")
        g["revenueratio"] = g.itemrevenue * 100 / g.classrevenue
        g = g.sort_values(["i_category", "i_class", "i_item_id",
                           "itemrevenue", "revenueratio"],
                          kind="stable").head(100)
        return g[["i_item_id", "i_class", "i_category", "itemrevenue",
                  "revenueratio"]]
    if name == "ds73":
        c = f["customer"]
        x = ss.merge(d, left_on="ss_sold_date_sk", right_on="d_date_sk")
        x = x[x.d_year == 2000]
        g = x.groupby("ss_customer_sk").size().reset_index(name="cnt")
        g = g[g.cnt > 8]
        m = g.merge(c, left_on="ss_customer_sk", right_on="c_customer_sk")
        m = m.sort_values(["cnt", "c_last_name", "c_first_name"],
                          ascending=[False, True, True],
                          kind="stable").head(50)
        return m[["c_last_name", "c_first_name", "cnt"]]
    if name == "ds9":
        def band(lo, hi):
            return ss[(ss.ss_quantity >= lo) & (ss.ss_quantity <= hi)]
        b1, b2 = band(1, 20), band(21, 40)
        return pd.DataFrame({
            "r1": [b1.ss_ext_discount_amt.mean() / b1.ss_net_profit.mean()],
            "r2": [b2.ss_ext_discount_amt.mean() / b2.ss_net_profit.mean()],
            "c3": [len(band(41, 60))]})
    if name in ("ds12", "ds20"):
        if name == "ds12":
            fact, dk, pk, val = f["web_sales"], "ws_sold_date_sk", \
                "ws_item_sk", "ws_ext_sales_price"
        else:
            fact, dk, pk, val = f["catalog_sales"], "cs_sold_date_sk", \
                "cs_item_sk", "cs_ext_sales_price"
        x = fact.merge(i, left_on=pk, right_on="i_item_sk") \
                .merge(d, left_on=dk, right_on="d_date_sk")
        x = x[x.i_category.isin(["Sports", "Books", "Home"])
              & (x.d_year == 1999) & (x.d_moy >= 2) & (x.d_moy <= 3)]
        g = x.groupby(["i_item_id", "i_class", "i_category"],
                      as_index=False)[val].sum() \
             .rename(columns={val: "itemrevenue"})
        g["revenueratio"] = g.itemrevenue * 100 \
            / g.groupby("i_class").itemrevenue.transform("sum")
        g = g.sort_values(["i_category", "i_class", "i_item_id",
                           "itemrevenue", "revenueratio"],
                          kind="stable").head(100)
        return g[["i_item_id", "i_class", "i_category", "itemrevenue",
                  "revenueratio"]]
    if name in ("ds13", "ds48"):
        cd, hd, c, ca = (f["customer_demographics"],
                         f["household_demographics"], f["customer"],
                         f["customer_address"])
        x = ss.merge(s, left_on="ss_store_sk", right_on="s_store_sk") \
              .merge(cd, left_on="ss_cdemo_sk", right_on="cd_demo_sk") \
              .merge(d, left_on="ss_sold_date_sk", right_on="d_date_sk")
        x = x[x.d_year == 2001]
        if name == "ds13":
            x = x.merge(hd, left_on="ss_hdemo_sk", right_on="hd_demo_sk")
            m1 = ((x.cd_marital_status == "M")
                  & (x.cd_education_status == "College")
                  & x.ss_sales_price.between(100, 150)
                  & (x.hd_dep_count == 3))
            m2 = ((x.cd_marital_status == "S")
                  & (x.cd_education_status == "Primary")
                  & x.ss_sales_price.between(50, 100)
                  & (x.hd_dep_count == 1))
            m3 = ((x.cd_marital_status == "W")
                  & (x.cd_education_status == "2 yr Degree")
                  & x.ss_sales_price.between(150, 200)
                  & (x.hd_dep_count == 1))
            x = x[m1 | m2 | m3]
            return pd.DataFrame({
                "a1": [x.ss_quantity.mean()],
                "a2": [x.ss_ext_sales_price.mean()],
                "a3": [x.ss_ext_wholesale_cost.mean()],
                "a4": [x.ss_ext_wholesale_cost.sum()]})
        x = x.merge(c, left_on="ss_customer_sk", right_on="c_customer_sk") \
             .merge(ca, left_on="c_current_addr_sk",
                    right_on="ca_address_sk")
        m1 = ((x.cd_marital_status == "M")
              & (x.cd_education_status == "College")
              & x.ss_sales_price.between(100, 150))
        m2 = ((x.cd_marital_status == "D")
              & (x.cd_education_status == "Secondary")
              & x.ss_sales_price.between(50, 100))
        x = x[(m1 | m2) & x.ca_state.isin(["TX", "OH", "NY"])]
        return pd.DataFrame({"q": [x.ss_quantity.sum()]})
    if name in ("ds15", "ds45"):
        c, ca = f["customer"], f["customer_address"]
        if name == "ds15":
            fact, ck, dk, val = f["catalog_sales"], "cs_bill_customer_sk", \
                "cs_sold_date_sk", "cs_sales_price"
        else:
            fact, ck, dk, val = f["web_sales"], "ws_bill_customer_sk", \
                "ws_sold_date_sk", "ws_sales_price"
        x = fact.merge(c, left_on=ck, right_on="c_customer_sk") \
                .merge(ca, left_on="c_current_addr_sk",
                       right_on="ca_address_sk") \
                .merge(d, left_on=dk, right_on="d_date_sk")
        if name == "ds15":
            x = x[(x.ca_zip_num.isin([10001, 10005, 10010, 10017, 10025])
                   | x.ca_state.isin(["CA", "WA", "GA"])
                   | (x[val] > 180))
                  & (x.d_qoy == 2) & (x.d_year == 2001)]
        else:
            x = x[x.ca_zip_num.isin([10001, 10005, 10010, 10015, 10020])
                  & (x.d_qoy == 2) & (x.d_year == 2001)]
        g = x.groupby("ca_zip_num", as_index=False)[val].sum() \
             .rename(columns={val: "s"})
        out = g.sort_values("ca_zip_num", kind="stable")
        return out.head(100) if name == "ds15" else out
    if name == "ds18":
        cs, cd, c = f["catalog_sales"], f["customer_demographics"], \
            f["customer"]
        x = cs.merge(cd, left_on="cs_bill_cdemo_sk", right_on="cd_demo_sk") \
              .merge(c, left_on="cs_bill_customer_sk",
                     right_on="c_customer_sk") \
              .merge(d, left_on="cs_sold_date_sk", right_on="d_date_sk") \
              .merge(i, left_on="cs_item_sk", right_on="i_item_sk")
        x = x[(x.cd_gender == "F") & (x.cd_education_status == "Unknown")
              & (x.d_year == 1998)
              & (x.c_birth_year >= 1950) & (x.c_birth_year <= 1970)]
        g = x.groupby("i_item_id", as_index=False).agg(
            a1=("cs_quantity", "mean"), a2=("cs_list_price", "mean"),
            a3=("cs_coupon_amt", "mean"), a4=("cs_sales_price", "mean"),
            a5=("c_birth_year", "mean"))
        return g.sort_values("i_item_id", kind="stable").head(100)
    if name in ("ds21", "ds22", "ds37", "ds82"):
        inv, w = f["inventory"], f["warehouse"]
        x = inv.merge(d, left_on="inv_date_sk", right_on="d_date_sk") \
               .merge(i, left_on="inv_item_sk", right_on="i_item_sk")
        if name == "ds21":
            x = x.merge(w, left_on="inv_warehouse_sk",
                        right_on="w_warehouse_sk")
            x = x[x.i_current_price.between(40, 60)
                  & x.d_date_sk.between(1065, 1125)]
            x = x.assign(
                before=np.where(x.d_date_sk < 1095,
                                x.inv_quantity_on_hand, 0),
                after=np.where(x.d_date_sk >= 1095,
                               x.inv_quantity_on_hand, 0))
            g = x.groupby(["w_warehouse_name", "i_item_id"],
                          as_index=False).agg(inv_before=("before", "sum"),
                                              inv_after=("after", "sum"))
            return g.sort_values(["w_warehouse_name", "i_item_id"],
                                 kind="stable").head(100)
        if name == "ds22":
            x = x[x.d_year == 2000]
            g = x.groupby("i_item_id", as_index=False) \
                 .inv_quantity_on_hand.mean() \
                 .rename(columns={"inv_quantity_on_hand": "qoh"})
            return g.sort_values(["qoh", "i_item_id"],
                                 kind="stable").head(100)
        lo, hi, dlo, dhi = (20, 50, 1100, 1160) if name == "ds37" \
            else (60, 90, 720, 780)
        fact_items = f["catalog_sales"].cs_item_sk if name == "ds37" \
            else ss.ss_item_sk
        x = x[x.i_current_price.between(lo, hi)
              & x.inv_quantity_on_hand.between(100, 500)
              & x.d_date_sk.between(dlo, dhi)
              & x.i_item_sk.isin(set(fact_items))]
        g = x.groupby(["i_item_id", "i_current_price"],
                      as_index=False).size()
        return g.sort_values("i_item_id", kind="stable").head(100)[
            ["i_item_id", "i_current_price"]]
    if name in ("ds25", "ds29"):
        sr, cs = f["store_returns"], f["catalog_sales"]
        yr, moy = (2000, 4) if name == "ds25" else (1999, 9)
        x = ss.merge(sr, left_on="ss_ticket_sk", right_on="sr_ticket_sk") \
              .merge(cs, left_on="sr_customer_sk",
                     right_on="cs_bill_customer_sk") \
              .merge(s, left_on="ss_store_sk", right_on="s_store_sk") \
              .merge(i, left_on="ss_item_sk", right_on="i_item_sk") \
              .merge(d, left_on="ss_sold_date_sk", right_on="d_date_sk")
        x = x[(x.d_year == yr) & (x.d_moy == moy)]
        if name == "ds25":
            g = x.groupby(["i_item_id", "s_store_name"],
                          as_index=False).agg(
                store_profit=("ss_net_profit", "sum"),
                return_loss=("sr_net_loss", "sum"),
                catalog_profit=("cs_net_profit", "sum"))
        else:
            g = x.groupby(["i_item_id", "s_store_name"],
                          as_index=False).agg(
                store_qty=("ss_quantity", "sum"),
                return_qty=("sr_return_quantity", "sum"),
                catalog_qty=("cs_quantity", "sum"))
        return g.sort_values(["i_item_id", "s_store_name"],
                             kind="stable").head(100)
    if name == "ds26":
        cs, cd, p = f["catalog_sales"], f["customer_demographics"], \
            f["promotion"]
        x = cs.merge(cd, left_on="cs_bill_cdemo_sk", right_on="cd_demo_sk") \
              .merge(d, left_on="cs_sold_date_sk", right_on="d_date_sk") \
              .merge(i, left_on="cs_item_sk", right_on="i_item_sk") \
              .merge(p, left_on="cs_promo_sk", right_on="p_promo_sk")
        x = x[(x.cd_gender == "F") & (x.cd_marital_status == "W")
              & (x.cd_education_status == "Primary")
              & ((x.p_channel_email == "N") | (x.p_channel_event == "N"))
              & (x.d_year == 2000)]
        g = x.groupby("i_item_id", as_index=False).agg(
            agg1=("cs_quantity", "mean"), agg2=("cs_list_price", "mean"),
            agg3=("cs_coupon_amt", "mean"), agg4=("cs_sales_price", "mean"))
        return g.sort_values("i_item_id", kind="stable").head(100)
    if name == "ds27":
        cd = f["customer_demographics"]
        x = j.merge(cd, left_on="ss_cdemo_sk", right_on="cd_demo_sk") \
             .merge(s, left_on="ss_store_sk", right_on="s_store_sk")
        x = x[(x.cd_gender == "M") & (x.cd_marital_status == "S")
              & (x.cd_education_status == "College") & (x.d_year == 2002)]
        g = x.groupby(["i_item_id", "s_state"], as_index=False).agg(
            agg1=("ss_quantity", "mean"), agg2=("ss_list_price", "mean"),
            agg3=("ss_coupon_amt", "mean"), agg4=("ss_sales_price", "mean"))
        return g.sort_values(["i_item_id", "s_state"],
                             kind="stable").head(100)
    if name in ("ds32", "ds92"):
        if name == "ds32":
            fact, ik, dk, val, mid = f["catalog_sales"], "cs_item_sk", \
                "cs_sold_date_sk", "cs_ext_discount_amt", 7
        else:
            fact, ik, dk, val, mid = f["web_sales"], "ws_item_sk", \
                "ws_sold_date_sk", "ws_ext_discount_amt", 3
        x = fact.merge(d, left_on=dk, right_on="d_date_sk")
        x = x[x.d_year == 2000]
        avg = x.groupby(ik)[val].mean().rename("avg_disc")
        x = x.merge(i, left_on=ik, right_on="i_item_sk")
        x = x[x.i_manufact_id == mid].join(avg, on=ik)
        x = x[x[val] > 1.3 * x.avg_disc]
        return pd.DataFrame({"excess_discount": [x[val].sum()]})
    if name == "ds34":
        c, hd = f["customer"], f["household_demographics"]
        x = ss.merge(d, left_on="ss_sold_date_sk", right_on="d_date_sk") \
              .merge(hd, left_on="ss_hdemo_sk", right_on="hd_demo_sk")
        x = x[(x.d_year == 2000) & (x.hd_vehicle_count > 1)]
        g = x.groupby("ss_customer_sk").size().reset_index(name="cnt")
        g = g[(g.cnt >= 4) & (g.cnt <= 20)]
        m = g.merge(c, left_on="ss_customer_sk", right_on="c_customer_sk")
        m = m.sort_values(["c_last_name", "c_first_name", "cnt"],
                          ascending=[True, True, False],
                          kind="stable").head(100)
        return m[["c_last_name", "c_first_name", "cnt"]]
    if name == "ds40":
        ws, wr, w = f["web_sales"], f["web_returns"], f["warehouse"]
        x = ws.merge(wr[["wr_order_sk", "wr_return_amt"]],
                     left_on="ws_order_sk", right_on="wr_order_sk",
                     how="left") \
              .merge(w, left_on="ws_warehouse_sk",
                     right_on="w_warehouse_sk") \
              .merge(i, left_on="ws_item_sk", right_on="i_item_sk") \
              .merge(d, left_on="ws_sold_date_sk", right_on="d_date_sk")
        x = x[x.d_date_sk.between(840, 960)]
        net = x.ws_sales_price - x.wr_return_amt.fillna(0)
        x = x.assign(before=np.where(x.d_date_sk < 900, net, 0),
                     after=np.where(x.d_date_sk >= 900, net, 0))
        g = x.groupby(["w_state", "i_item_id"], as_index=False).agg(
            sales_before=("before", "sum"), sales_after=("after", "sum"))
        return g.sort_values(["w_state", "i_item_id"],
                             kind="stable").head(100)
    if name == "ds43":
        x = ss.merge(d, left_on="ss_sold_date_sk", right_on="d_date_sk") \
              .merge(s, left_on="ss_store_sk", right_on="s_store_sk")
        x = x[x.d_year == 2000]
        def day(dayname):
            return np.where(x.d_day_name == dayname, x.ss_sales_price, 0)
        x = x.assign(sun=day("Sunday"), mon=day("Monday"),
                     wed=day("Wednesday"), sat=day("Saturday"))
        g = x.groupby(["s_store_name", "s_store_sk"], as_index=False).agg(
            sun_sales=("sun", "sum"), mon_sales=("mon", "sum"),
            wed_sales=("wed", "sum"), sat_sales=("sat", "sum"))
        return g.sort_values(["s_store_name", "s_store_sk"],
                             kind="stable").head(100)
    if name in ("ds46", "ds79"):
        c, hd = f["customer"], f["household_demographics"]
        x = ss.merge(d, left_on="ss_sold_date_sk", right_on="d_date_sk") \
              .merge(s, left_on="ss_store_sk", right_on="s_store_sk") \
              .merge(hd, left_on="ss_hdemo_sk", right_on="hd_demo_sk") \
              .merge(c, left_on="ss_customer_sk", right_on="c_customer_sk")
        if name == "ds46":
            x = x[((x.hd_dep_count == 5) | (x.hd_vehicle_count == 3))
                  & x.d_dow.isin([6, 0]) & (x.d_year == 1999)]
            g = x.groupby(["c_last_name", "c_first_name"],
                          as_index=False).agg(amt=("ss_coupon_amt", "sum"),
                                              profit=("ss_net_profit",
                                                      "sum"))
            return g.sort_values(["c_last_name", "c_first_name", "profit"],
                                 kind="stable").head(100)
        x = x[((x.hd_dep_count == 8) | (x.hd_vehicle_count > 3))
              & (x.d_dow == 1) & (x.d_year == 2000)]
        g = x.groupby(["c_last_name", "c_first_name", "s_store_name"],
                      as_index=False).agg(amt=("ss_coupon_amt", "sum"),
                                          profit=("ss_net_profit", "sum"))
        return g.sort_values(["c_last_name", "c_first_name",
                              "s_store_name", "profit"],
                             kind="stable").head(100)
    if name == "ds50":
        sr = f["store_returns"]
        x = ss.merge(sr, left_on="ss_ticket_sk", right_on="sr_ticket_sk") \
              .merge(s, left_on="ss_store_sk", right_on="s_store_sk") \
              .merge(d, left_on="sr_returned_date_sk",
                     right_on="d_date_sk")
        x = x[(x.d_year == 2001) & (x.d_moy == 8)]
        lag = x.sr_returned_date_sk - x.ss_sold_date_sk
        x = x.assign(d30=(lag <= 30).astype(int),
                     d60=((lag > 30) & (lag <= 60)).astype(int),
                     d90=(lag > 60).astype(int))
        g = x.groupby("s_store_name", as_index=False).agg(
            d30=("d30", "sum"), d60=("d60", "sum"), d90=("d90", "sum"))
        return g.sort_values("s_store_name", kind="stable").head(100)
    if name == "ds58":
        def chan(fact, ik, dk, val, out):
            x = fact.merge(i, left_on=ik, right_on="i_item_sk") \
                    .merge(d, left_on=dk, right_on="d_date_sk")
            x = x[(x.d_year == 2000) & (x.d_moy == 6)]
            return x.groupby("i_item_id", as_index=False)[val].sum() \
                    .rename(columns={val: out, "i_item_id": "item_id"})
        ssr = chan(ss, "ss_item_sk", "ss_sold_date_sk",
                   "ss_ext_sales_price", "ss_rev")
        csr = chan(f["catalog_sales"], "cs_item_sk", "cs_sold_date_sk",
                   "cs_ext_sales_price", "cs_rev")
        wsr = chan(f["web_sales"], "ws_item_sk", "ws_sold_date_sk",
                   "ws_ext_sales_price", "ws_rev")
        m = ssr.merge(csr, on="item_id").merge(wsr, on="item_id")
        m = m[(m.ss_rev >= 0.5 * m.cs_rev) & (m.ss_rev <= 2 * m.cs_rev)
              & (m.ss_rev >= 0.5 * m.ws_rev) & (m.ss_rev <= 2 * m.ws_rev)]
        m = m.assign(average=(m.ss_rev + m.cs_rev + m.ws_rev) / 3)
        return m.sort_values(["item_id", "ss_rev"], kind="stable").head(100)
    if name == "ds61":
        p = f["promotion"]
        x = ss.merge(d, left_on="ss_sold_date_sk", right_on="d_date_sk")
        x = x[(x.d_year == 1998) & (x.d_moy == 11)]
        xp = x.merge(p, left_on="ss_promo_sk", right_on="p_promo_sk")
        xp = xp[(xp.p_channel_email == "Y") | (xp.p_channel_event == "Y")]
        return pd.DataFrame({
            "promo_pct": [xp.ss_ext_sales_price.sum() * 100
                          / x.ss_ext_sales_price.sum()]})
    if name == "ds69":
        c, cd, ws = f["customer"], f["customer_demographics"], \
            f["web_sales"]
        x = c.merge(cd, left_on="c_current_cdemo_sk",
                    right_on="cd_demo_sk")
        x = x[x.c_customer_sk.isin(set(ss.ss_customer_sk))
              & ~x.c_customer_sk.isin(set(ws.ws_bill_customer_sk))]
        g = x.groupby(["cd_gender", "cd_marital_status",
                       "cd_education_status"]).size() \
             .reset_index(name="cnt")
        return g.sort_values(["cd_gender", "cd_marital_status",
                              "cd_education_status"],
                             kind="stable").head(100)
    if name == "ds71":
        t, cs, ws = f["time_dim"], f["catalog_sales"], f["web_sales"]
        def arm(fact, dk, ik, tk, val):
            x = fact.merge(d, left_on=dk, right_on="d_date_sk")
            x = x[(x.d_moy == 11) & (x.d_year == 1999)]
            return pd.DataFrame({"ext_price": x[val],
                                 "sold_item_sk": x[ik],
                                 "time_sk": x[tk]})
        u = pd.concat([
            arm(ws, "ws_sold_date_sk", "ws_item_sk", "ws_sold_time_sk",
                "ws_ext_sales_price"),
            arm(cs, "cs_sold_date_sk", "cs_item_sk", "cs_sold_time_sk",
                "cs_ext_sales_price"),
            arm(ss, "ss_sold_date_sk", "ss_item_sk", "ss_sold_time_sk",
                "ss_ext_sales_price")], ignore_index=True)
        x = u.merge(i, left_on="sold_item_sk", right_on="i_item_sk") \
             .merge(t, left_on="time_sk", right_on="t_time_sk")
        x = x[x.i_manager_id == 1]
        g = x.groupby(["i_brand_id", "i_brand", "t_hour"],
                      as_index=False).ext_price.sum()
        return g.sort_values(["ext_price", "i_brand_id", "t_hour"],
                             ascending=[False, True, True],
                             kind="stable").head(100)[
            ["i_brand_id", "i_brand", "t_hour", "ext_price"]]
    if name == "ds76":
        cs, ws = f["catalog_sales"], f["web_sales"]
        a1 = ss[ss.ss_hdemo_sk == 13].merge(
            i, left_on="ss_item_sk", right_on="i_item_sk")
        a1 = pd.DataFrame({"chan": 1, "i_category": a1.i_category,
                           "sales": a1.ss_ext_sales_price})
        a2 = ws[ws.ws_promo_sk == 7].merge(
            i, left_on="ws_item_sk", right_on="i_item_sk")
        a2 = pd.DataFrame({"chan": 2, "i_category": a2.i_category,
                           "sales": a2.ws_ext_sales_price})
        a3 = cs[cs.cs_warehouse_sk == 2].merge(
            i, left_on="cs_item_sk", right_on="i_item_sk")
        a3 = pd.DataFrame({"chan": 3, "i_category": a3.i_category,
                           "sales": a3.cs_ext_sales_price})
        u = pd.concat([a1, a2, a3], ignore_index=True)
        g = u.groupby(["chan", "i_category"], as_index=False).agg(
            cnt=("sales", "size"), s=("sales", "sum"))
        return g.sort_values(["chan", "i_category"],
                             kind="stable").head(100)
    if name == "ds85":
        wr, cd = f["web_returns"], f["customer_demographics"]
        x = wr.merge(cd, left_on="wr_refunded_cdemo_sk",
                     right_on="cd_demo_sk") \
              .merge(d, left_on="wr_returned_date_sk",
                     right_on="d_date_sk")
        x = x[x.d_year == 2000]
        g = x.groupby(["cd_marital_status", "cd_education_status"],
                      as_index=False).agg(q=("wr_return_quantity", "mean"),
                                          fee=("wr_fee", "mean"),
                                          amt=("wr_return_amt", "mean"))
        return g.sort_values(["cd_marital_status", "cd_education_status"],
                             kind="stable").head(100)
    if name == "ds90":
        ws, hd, t = f["web_sales"], f["household_demographics"], \
            f["time_dim"]
        x = ws.merge(hd, left_on="ws_ship_hdemo_sk",
                     right_on="hd_demo_sk") \
              .merge(t, left_on="ws_sold_time_sk", right_on="t_time_sk")
        x = x[x.hd_dep_count == 6]
        am = len(x[x.t_hour.between(8, 9)])
        pm = len(x[x.t_hour.between(19, 20)])
        return pd.DataFrame({"am_cnt": [am], "pm_cnt": [pm]})
    if name == "ds93":
        sr = f["store_returns"]
        x = ss.merge(sr[["sr_ticket_sk", "sr_return_quantity"]],
                     left_on="ss_ticket_sk", right_on="sr_ticket_sk",
                     how="left")
        act = np.where(x.sr_return_quantity.notna(),
                       (x.ss_quantity - x.sr_return_quantity)
                       * x.ss_sales_price,
                       x.ss_quantity * x.ss_sales_price)
        x = x.assign(act_sales=act)
        g = x.groupby("ss_customer_sk", as_index=False).act_sales.sum() \
             .rename(columns={"ss_customer_sk": "cust",
                              "act_sales": "sumsales"})
        return g.sort_values(["sumsales", "cust"],
                             ascending=[False, True],
                             kind="stable").head(100)
    from ydb_tpu_torch.bench.tpcds_oracle2 import QUERIES2, oracle2
    if name in QUERIES2:
        return oracle2(name, f)
    raise KeyError(name)


def _merge_round5_templates():
    from ydb_tpu_torch.bench.tpcds_oracle2 import QUERIES2
    QUERIES.update(QUERIES2)


_merge_round5_templates()

