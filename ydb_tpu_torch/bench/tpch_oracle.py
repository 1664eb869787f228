"""TPC-H query texts + pandas oracle helpers for tests and bench.

The oracle role: what Arrow-compute is to the reference's SSA executor
(`ydb/core/formats/arrow/program.cpp`), pandas is here — an independent
CPU evaluation of the same query over the same generated data.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from ydb_tpu_torch.bench.tpch_gen import TpchData, date32


_FRAMES_MEMO: list = []   # [(data, frames)] — strong ref pins the dataset


def frames(data: TpchData) -> dict[str, pd.DataFrame]:
    """DataFrame views of the generated tables, memoized per dataset —
    at SF≥1 the conversion itself costs tens of seconds and every oracle
    call needs the same frames. Identity-checked against the live object
    (an id()-keyed map would alias a recycled address)."""
    if _FRAMES_MEMO and _FRAMES_MEMO[0][0] is data:
        return _FRAMES_MEMO[0][1]
    got = {name: pd.DataFrame(cols) for name, cols in data.tables.items()}
    _FRAMES_MEMO.clear()              # one dataset at a time (SF10 ~ 10GB)
    _FRAMES_MEMO.append((data, got))
    return got


QUERIES: dict[str, str] = {
    "q1": """
select l_returnflag, l_linestatus,
  sum(l_quantity) as sum_qty,
  sum(l_extendedprice) as sum_base_price,
  sum(l_extendedprice*(1-l_discount)) as sum_disc_price,
  sum(l_extendedprice*(1-l_discount)*(1+l_tax)) as sum_charge,
  avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price,
  avg(l_discount) as avg_disc, count(*) as count_order
from lineitem
where l_shipdate <= date '1998-12-01' - interval '90' day
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus""",
    "q2": """
select s_acctbal, s_name, n_name, p_partkey, p_mfgr, s_address, s_phone,
  s_comment
from part, supplier, partsupp, nation, region
where p_partkey = ps_partkey and s_suppkey = ps_suppkey and p_size = 15
  and p_type like '%BRASS' and s_nationkey = n_nationkey
  and n_regionkey = r_regionkey and r_name = 'EUROPE'
  and ps_supplycost = (
    select min(ps_supplycost) from partsupp, supplier, nation, region
    where p_partkey = ps_partkey and s_suppkey = ps_suppkey
      and s_nationkey = n_nationkey and n_regionkey = r_regionkey
      and r_name = 'EUROPE')
order by s_acctbal desc, n_name, s_name, p_partkey
limit 100""",
    "q4": """
select o_orderpriority, count(*) as order_count
from orders
where o_orderdate >= date '1993-07-01'
  and o_orderdate < date '1993-07-01' + interval '3' month
  and exists (select * from lineitem
              where l_orderkey = o_orderkey and l_commitdate < l_receiptdate)
group by o_orderpriority
order by o_orderpriority""",
    "q3": """
select l_orderkey, sum(l_extendedprice*(1-l_discount)) as revenue,
  o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = 'BUILDING' and c_custkey = o_custkey
  and l_orderkey = o_orderkey
  and o_orderdate < date '1995-03-15' and l_shipdate > date '1995-03-15'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate
limit 10""",
    "q5": """
select n_name, sum(l_extendedprice*(1-l_discount)) as revenue
from customer, orders, lineitem, supplier, nation, region
where c_custkey = o_custkey and l_orderkey = o_orderkey
  and l_suppkey = s_suppkey and c_nationkey = s_nationkey
  and s_nationkey = n_nationkey and n_regionkey = r_regionkey
  and r_name = 'ASIA'
  and o_orderdate >= date '1994-01-01'
  and o_orderdate < date '1994-01-01' + interval '1' year
group by n_name
order by revenue desc""",
    "q6": """
select sum(l_extendedprice*l_discount) as revenue
from lineitem
where l_shipdate >= date '1994-01-01'
  and l_shipdate < date '1994-01-01' + interval '1' year
  and l_discount between 0.05 and 0.07
  and l_quantity < 24""",
    "q7": """
select n1.n_name as supp_nation, n2.n_name as cust_nation,
  year(l_shipdate) as l_year,
  sum(l_extendedprice * (1 - l_discount)) as revenue
from supplier, lineitem, orders, customer, nation n1, nation n2
where s_suppkey = l_suppkey and o_orderkey = l_orderkey
  and c_custkey = o_custkey and s_nationkey = n1.n_nationkey
  and c_nationkey = n2.n_nationkey
  and ((n1.n_name = 'FRANCE' and n2.n_name = 'GERMANY')
    or (n1.n_name = 'GERMANY' and n2.n_name = 'FRANCE'))
  and l_shipdate between date '1995-01-01' and date '1996-12-31'
group by supp_nation, cust_nation, l_year
order by supp_nation, cust_nation, l_year""",
    "q8": """
select year(o_orderdate) as o_year,
  sum(case when n2.n_name = 'BRAZIL'
      then l_extendedprice * (1 - l_discount) else 0 end)
    / sum(l_extendedprice * (1 - l_discount)) as mkt_share
from part, supplier, lineitem, orders, customer, nation n1, nation n2, region
where p_partkey = l_partkey and s_suppkey = l_suppkey
  and l_orderkey = o_orderkey and o_custkey = c_custkey
  and c_nationkey = n1.n_nationkey and n1.n_regionkey = r_regionkey
  and r_name = 'AMERICA' and s_nationkey = n2.n_nationkey
  and o_orderdate between date '1995-01-01' and date '1996-12-31'
  and p_type = 'ECONOMY ANODIZED STEEL'
group by o_year
order by o_year""",
    "q20": """
select s_name, s_address from supplier, nation
where s_suppkey in (
    select ps_suppkey from partsupp
    where ps_partkey in (select p_partkey from part
                         where p_name like 'forest%')
      and ps_availqty > (select 0.5 * sum(l_quantity) from lineitem
                         where l_partkey = ps_partkey
                           and l_suppkey = ps_suppkey
                           and l_shipdate >= date '1994-01-01'
                           and l_shipdate < date '1994-01-01' + interval '1' year))
  and s_nationkey = n_nationkey and n_name = 'CANADA'
order by s_name""",
    "q9": """
select n_name, year(o_orderdate) as o_year,
  sum(l_extendedprice*(1-l_discount) - ps_supplycost*l_quantity) as sum_profit
from part, supplier, lineitem, partsupp, orders, nation
where s_suppkey = l_suppkey and ps_suppkey = l_suppkey
  and ps_partkey = l_partkey and p_partkey = l_partkey
  and o_orderkey = l_orderkey and s_nationkey = n_nationkey
  and p_name like '%green%'
group by n_name, o_year
order by n_name, o_year desc""",
    "q10": """
select c_custkey, c_name, sum(l_extendedprice*(1-l_discount)) as revenue,
  c_acctbal, n_name, c_address, c_phone, c_comment
from customer, orders, lineitem, nation
where c_custkey = o_custkey and l_orderkey = o_orderkey
  and o_orderdate >= date '1993-10-01'
  and o_orderdate < date '1993-10-01' + interval '3' month
  and l_returnflag = 'R' and c_nationkey = n_nationkey
group by c_custkey, c_name, c_acctbal, c_phone, n_name, c_address, c_comment
order by revenue desc
limit 20""",
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
order by value desc""",
    "q17": """
select sum(l_extendedprice) / 7.0 as avg_yearly
from lineitem, part
where p_partkey = l_partkey and p_brand = 'Brand#23'
  and p_container = 'MED BOX'
  and l_quantity < (select 0.2 * avg(l_quantity) from lineitem
                    where l_partkey = p_partkey)""",
    "q18": """
select c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
  sum(l_quantity) as total_qty
from customer, orders, lineitem
where o_orderkey in (select l_orderkey from lineitem
                     group by l_orderkey having sum(l_quantity) > 250)
  and c_custkey = o_custkey and o_orderkey = l_orderkey
group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
order by o_totalprice desc, o_orderdate
limit 100""",
    "q22": """
select substring(c_phone from 1 for 2) as cntrycode, count(*) as numcust,
  sum(c_acctbal) as totacctbal
from customer
where substring(c_phone from 1 for 2) in
      ('13', '31', '23', '29', '30', '18', '17')
  and c_acctbal > (select avg(c_acctbal) from customer
                   where c_acctbal > 0.00
                     and substring(c_phone from 1 for 2) in
                         ('13', '31', '23', '29', '30', '18', '17'))
  and not exists (select * from orders where o_custkey = c_custkey)
group by cntrycode
order by cntrycode""",
    "q12": """
select l_shipmode,
  sum(case when o_orderpriority = '1-URGENT' or o_orderpriority = '2-HIGH'
      then 1 else 0 end) as high_line_count,
  sum(case when o_orderpriority <> '1-URGENT' and o_orderpriority <> '2-HIGH'
      then 1 else 0 end) as low_line_count
from orders, lineitem
where o_orderkey = l_orderkey and l_shipmode in ('MAIL', 'SHIP')
  and l_commitdate < l_receiptdate and l_shipdate < l_commitdate
  and l_receiptdate >= date '1994-01-01'
  and l_receiptdate < date '1994-01-01' + interval '1' year
group by l_shipmode
order by l_shipmode""",
    "q14": """
select 100.00 * sum(case when p_type like 'PROMO%'
    then l_extendedprice*(1-l_discount) else 0 end)
  / sum(l_extendedprice*(1-l_discount)) as promo_revenue
from lineitem, part
where l_partkey = p_partkey
  and l_shipdate >= date '1995-09-01'
  and l_shipdate < date '1995-09-01' + interval '1' month""",
    "q19": """
select sum(l_extendedprice*(1-l_discount)) as revenue
from lineitem, part
where (p_partkey = l_partkey and p_brand = 'Brand#12'
   and p_container in ('SM CASE','SM BOX','SM PACK','SM PKG')
   and l_quantity >= 1 and l_quantity <= 11 and p_size between 1 and 5
   and l_shipmode in ('AIR','AIR REG') and l_shipinstruct = 'DELIVER IN PERSON')
or (p_partkey = l_partkey and p_brand = 'Brand#23'
   and p_container in ('MED BAG','MED BOX','MED PKG','MED PACK')
   and l_quantity >= 10 and l_quantity <= 20 and p_size between 1 and 10
   and l_shipmode in ('AIR','AIR REG') and l_shipinstruct = 'DELIVER IN PERSON')
or (p_partkey = l_partkey and p_brand = 'Brand#34'
   and p_container in ('LG CASE','LG BOX','LG PACK','LG PKG')
   and l_quantity >= 20 and l_quantity <= 30 and p_size between 1 and 15
   and l_shipmode in ('AIR','AIR REG') and l_shipinstruct = 'DELIVER IN PERSON')""",
    "q13": """
select c_count, count(*) as custdist from (
  select c.c_custkey as c_custkey, count(o.o_orderkey) as c_count
  from customer c left join orders o
    on c.c_custkey = o.o_custkey and o.o_comment not like '%special%requests%'
  group by c.c_custkey
) as c_orders
group by c_count
order by custdist desc, c_count desc""",
    "q15": """
with revenue as (
  select l_suppkey as supplier_no,
         sum(l_extendedprice * (1 - l_discount)) as total_revenue
  from lineitem
  where l_shipdate >= date '1996-01-01' and l_shipdate < date '1996-04-01'
  group by l_suppkey
)
select s.s_suppkey, s.s_name, s.s_address, s.s_phone, r.total_revenue
from supplier s join revenue r on s.s_suppkey = r.supplier_no
where r.total_revenue = (select max(total_revenue) from revenue)
order by s.s_suppkey""",
    "q16": """
select p.p_brand, p.p_type, p.p_size,
       count(distinct ps.ps_suppkey) as supplier_cnt
from partsupp ps join part p on p.p_partkey = ps.ps_partkey
where p.p_brand <> 'Brand#45'
  and p.p_type not like 'MEDIUM POLISHED%'
  and p.p_size in (49, 14, 23, 45, 19, 3, 36, 9)
  and ps.ps_suppkey not in (
    select s_suppkey from supplier where s_comment like '%Customer%Complaints%'
  )
group by p.p_brand, p.p_type, p.p_size
order by supplier_cnt desc, p.p_brand, p.p_type, p.p_size""",
    "q21": """
select s.s_name, count(*) as numwait
from supplier s
join lineitem l1 on s.s_suppkey = l1.l_suppkey
join orders o on o.o_orderkey = l1.l_orderkey
join nation n on s.s_nationkey = n.n_nationkey
where o.o_orderstatus = 'F'
  and l1.l_receiptdate > l1.l_commitdate
  and exists (select 1 from lineitem l2
              where l2.l_orderkey = l1.l_orderkey
                and l2.l_suppkey <> l1.l_suppkey)
  and not exists (select 1 from lineitem l3
                  where l3.l_orderkey = l1.l_orderkey
                    and l3.l_suppkey <> l1.l_suppkey
                    and l3.l_receiptdate > l3.l_commitdate)
  and n.n_name = 'SAUDI ARABIA'
group by s.s_name
order by numwait desc, s.s_name""",
}


def oracle(name: str, data: TpchData) -> pd.DataFrame:
    f = frames(data)
    li, od, cu = f["lineitem"], f["orders"], f["customer"]
    if name == "q1":
        d = li[li.l_shipdate <= date32(1998, 12, 1) - 90]
        disc = d.l_extendedprice * (1 - d.l_discount)
        d = d.assign(dp=disc, ch=disc * (1 + d.l_tax))
        g = d.groupby(["l_returnflag", "l_linestatus"], sort=True).agg(
            sum_qty=("l_quantity", "sum"), sum_base_price=("l_extendedprice", "sum"),
            sum_disc_price=("dp", "sum"), sum_charge=("ch", "sum"),
            avg_qty=("l_quantity", "mean"), avg_price=("l_extendedprice", "mean"),
            avg_disc=("l_discount", "mean"), count_order=("l_orderkey", "count"),
        ).reset_index()
        return g
    if name == "q3":
        c = cu[cu.c_mktsegment == "BUILDING"]
        o = od[od.o_orderdate < date32(1995, 3, 15)]
        l = li[li.l_shipdate > date32(1995, 3, 15)]
        j = l.merge(o, left_on="l_orderkey", right_on="o_orderkey") \
             .merge(c, left_on="o_custkey", right_on="c_custkey")
        j = j.assign(rev=j.l_extendedprice * (1 - j.l_discount))
        g = j.groupby(["l_orderkey", "o_orderdate", "o_shippriority"]).rev.sum() \
             .reset_index().rename(columns={"rev": "revenue"})
        g = g.sort_values(["revenue", "o_orderdate"],
                          ascending=[False, True], kind="stable").head(10)
        return g[["l_orderkey", "revenue", "o_orderdate", "o_shippriority"]]
    if name == "q5":
        na, re_, su = f["nation"], f["region"], f["supplier"]
        r = re_[re_.r_name == "ASIA"]
        n = na.merge(r, left_on="n_regionkey", right_on="r_regionkey")
        o = od[(od.o_orderdate >= date32(1994, 1, 1))
               & (od.o_orderdate < date32(1995, 1, 1))]
        j = li.merge(o, left_on="l_orderkey", right_on="o_orderkey") \
              .merge(cu, left_on="o_custkey", right_on="c_custkey") \
              .merge(su, left_on="l_suppkey", right_on="s_suppkey") \
              .merge(n, left_on="s_nationkey", right_on="n_nationkey")
        j = j[j.c_nationkey == j.s_nationkey]
        j = j.assign(rev=j.l_extendedprice * (1 - j.l_discount))
        g = j.groupby("n_name").rev.sum().reset_index() \
             .rename(columns={"rev": "revenue"})
        return g.sort_values("revenue", ascending=False, kind="stable")
    if name == "q6":
        d = li[(li.l_shipdate >= date32(1994, 1, 1))
               & (li.l_shipdate < date32(1995, 1, 1))
               & (li.l_discount >= 0.05 - 1e-12) & (li.l_discount <= 0.07 + 1e-12)
               & (li.l_quantity < 24)]
        return pd.DataFrame({"revenue": [(d.l_extendedprice * d.l_discount).sum()]})
    if name == "q2":
        pa, su, ps, na, re_ = f["part"], f["supplier"], f["partsupp"], \
            f["nation"], f["region"]
        eu = na.merge(re_[re_.r_name == "EUROPE"], left_on="n_regionkey",
                      right_on="r_regionkey")
        s_eu = su.merge(eu, left_on="s_nationkey", right_on="n_nationkey")
        ps_eu = ps.merge(s_eu, left_on="ps_suppkey", right_on="s_suppkey")
        min_cost = ps_eu.groupby("ps_partkey").ps_supplycost.min() \
            .rename("min_cost").reset_index()
        p = pa[(pa.p_size == 15) & pa.p_type.str.endswith("BRASS")]
        j = p.merge(ps_eu, left_on="p_partkey", right_on="ps_partkey") \
             .merge(min_cost, on="ps_partkey")
        j = j[j.ps_supplycost == j.min_cost]
        j = j.sort_values(["s_acctbal", "n_name", "s_name", "p_partkey"],
                          ascending=[False, True, True, True],
                          kind="stable").head(100)
        return j[["s_acctbal", "s_name", "n_name", "p_partkey", "p_mfgr",
                  "s_address", "s_phone", "s_comment"]]
    if name == "q4":
        o = od[(od.o_orderdate >= date32(1993, 7, 1))
               & (od.o_orderdate < date32(1993, 10, 1))]
        late = li[li.l_commitdate < li.l_receiptdate].l_orderkey.unique()
        o = o[o.o_orderkey.isin(late)]
        g = o.groupby("o_orderpriority").size().reset_index(name="order_count")
        return g.sort_values("o_orderpriority")
    if name == "q11":
        ps, su, na = f["partsupp"], f["supplier"], f["nation"]
        g_na = na[na.n_name == "GERMANY"]
        j = ps.merge(su, left_on="ps_suppkey", right_on="s_suppkey") \
              .merge(g_na, left_on="s_nationkey", right_on="n_nationkey")
        j = j.assign(v=j.ps_supplycost * j.ps_availqty)
        total = j.v.sum() * 0.0001
        g = j.groupby("ps_partkey").v.sum().reset_index() \
             .rename(columns={"v": "value"})
        g = g[g.value > total]
        return g.sort_values("value", ascending=False, kind="stable")
    if name == "q17":
        pa = f["part"]
        p = pa[(pa.p_brand == "Brand#23") & (pa.p_container == "MED BOX")]
        j = li.merge(p, left_on="l_partkey", right_on="p_partkey")
        avg_q = li.groupby("l_partkey").l_quantity.mean() \
            .rename("avg_q").reset_index()
        j = j.merge(avg_q, on="l_partkey")
        j = j[j.l_quantity < 0.2 * j.avg_q]
        s = j.l_extendedprice.sum() / 7.0 if len(j) else np.nan
        return pd.DataFrame({"avg_yearly": [s]})
    if name == "q18":
        big = li.groupby("l_orderkey").l_quantity.sum()
        big = big[big > 250].index
        o = od[od.o_orderkey.isin(big)]
        j = li.merge(o, left_on="l_orderkey", right_on="o_orderkey") \
              .merge(cu, left_on="o_custkey", right_on="c_custkey")
        g = j.groupby(["c_name", "c_custkey", "o_orderkey", "o_orderdate",
                       "o_totalprice"]).l_quantity.sum().reset_index() \
             .rename(columns={"l_quantity": "total_qty"})
        g = g.sort_values(["o_totalprice", "o_orderdate"],
                          ascending=[False, True], kind="stable").head(100)
        return g
    if name == "q22":
        codes = ["13", "31", "23", "29", "30", "18", "17"]
        cc = cu.c_phone.str[:2]
        sel = cu[cc.isin(codes)]
        avg_bal = sel[sel.c_acctbal > 0].c_acctbal.mean()
        sel = sel[sel.c_acctbal > avg_bal]
        sel = sel[~sel.c_custkey.isin(od.o_custkey.unique())]
        sel = sel.assign(cntrycode=sel.c_phone.str[:2])
        g = sel.groupby("cntrycode").agg(
            numcust=("c_custkey", "count"),
            totacctbal=("c_acctbal", "sum")).reset_index()
        return g.sort_values("cntrycode")
    if name == "q7":
        su, na = f["supplier"], f["nation"]
        j = li.merge(su, left_on="l_suppkey", right_on="s_suppkey") \
              .merge(od, left_on="l_orderkey", right_on="o_orderkey") \
              .merge(cu, left_on="o_custkey", right_on="c_custkey") \
              .merge(na.add_suffix("_1"), left_on="s_nationkey",
                     right_on="n_nationkey_1") \
              .merge(na.add_suffix("_2"), left_on="c_nationkey",
                     right_on="n_nationkey_2")
        m = (((j.n_name_1 == "FRANCE") & (j.n_name_2 == "GERMANY"))
             | ((j.n_name_1 == "GERMANY") & (j.n_name_2 == "FRANCE")))
        j = j[m & (j.l_shipdate >= date32(1995, 1, 1))
              & (j.l_shipdate <= date32(1996, 12, 31))]
        yr = (pd.to_datetime(j.l_shipdate, unit="D", origin="unix")
              .dt.year.astype(np.int64))
        j = j.assign(l_year=yr, vol=j.l_extendedprice * (1 - j.l_discount))
        g = j.groupby(["n_name_1", "n_name_2", "l_year"]).vol.sum() \
             .reset_index()
        g.columns = ["supp_nation", "cust_nation", "l_year", "revenue"]
        return g.sort_values(["supp_nation", "cust_nation", "l_year"])
    if name == "q8":
        pa, su, na, re_ = f["part"], f["supplier"], f["nation"], f["region"]
        am = na.merge(re_[re_.r_name == "AMERICA"], left_on="n_regionkey",
                      right_on="r_regionkey")
        p = pa[pa.p_type == "ECONOMY ANODIZED STEEL"]
        j = li.merge(p, left_on="l_partkey", right_on="p_partkey") \
              .merge(su, left_on="l_suppkey", right_on="s_suppkey") \
              .merge(od, left_on="l_orderkey", right_on="o_orderkey") \
              .merge(cu, left_on="o_custkey", right_on="c_custkey") \
              .merge(am, left_on="c_nationkey", right_on="n_nationkey") \
              .merge(na.add_suffix("_s"), left_on="s_nationkey",
                     right_on="n_nationkey_s")
        j = j[(j.o_orderdate >= date32(1995, 1, 1))
              & (j.o_orderdate <= date32(1996, 12, 31))]
        yr = (pd.to_datetime(j.o_orderdate, unit="D", origin="unix")
              .dt.year.astype(np.int64))
        vol = j.l_extendedprice * (1 - j.l_discount)
        br = vol.where(j.n_name_s == "BRAZIL", 0.0)
        j = j.assign(o_year=yr, vol=vol, br=br)
        g = j.groupby("o_year").agg(b=("br", "sum"), v=("vol", "sum"))
        g = g.reset_index()
        g["mkt_share"] = g.b / g.v
        return g[["o_year", "mkt_share"]].sort_values("o_year")
    if name == "q20":
        pa, su, ps, na = f["part"], f["supplier"], f["partsupp"], f["nation"]
        forest = pa[pa.p_name.str.startswith("forest")].p_partkey
        l = li[(li.l_shipdate >= date32(1994, 1, 1))
               & (li.l_shipdate < date32(1995, 1, 1))]
        half = l.groupby(["l_partkey", "l_suppkey"]).l_quantity.sum() * 0.5
        half = half.rename("half").reset_index()
        p2 = ps[ps.ps_partkey.isin(forest)]
        p2 = p2.merge(half, left_on=["ps_partkey", "ps_suppkey"],
                      right_on=["l_partkey", "l_suppkey"])
        p2 = p2[p2.ps_availqty > p2.half]
        sk = p2.ps_suppkey.unique()
        ca = na[na.n_name == "CANADA"]
        s = su[su.s_suppkey.isin(sk)].merge(
            ca, left_on="s_nationkey", right_on="n_nationkey")
        s = s.sort_values("s_name")
        return s[["s_name", "s_address"]]
    if name == "q9":
        pa, su, ps, na = f["part"], f["supplier"], f["partsupp"], f["nation"]
        p = pa[pa.p_name.str.contains("green")]
        j = li.merge(p, left_on="l_partkey", right_on="p_partkey") \
              .merge(su, left_on="l_suppkey", right_on="s_suppkey") \
              .merge(ps, left_on=["l_partkey", "l_suppkey"],
                     right_on=["ps_partkey", "ps_suppkey"]) \
              .merge(od, left_on="l_orderkey", right_on="o_orderkey") \
              .merge(na, left_on="s_nationkey", right_on="n_nationkey")
        oy = (pd.to_datetime(j.o_orderdate, unit="D", origin="unix")
              .dt.year.astype(np.int64))
        amount = j.l_extendedprice * (1 - j.l_discount) \
            - j.ps_supplycost * j.l_quantity
        j = j.assign(o_year=oy, amount=amount)
        g = j.groupby(["n_name", "o_year"]).amount.sum().reset_index() \
             .rename(columns={"amount": "sum_profit"})
        return g.sort_values(["n_name", "o_year"],
                             ascending=[True, False], kind="stable")
    if name == "q10":
        na = f["nation"]
        o = od[(od.o_orderdate >= date32(1993, 10, 1))
               & (od.o_orderdate < date32(1994, 1, 1))]
        l = li[li.l_returnflag == "R"]
        j = l.merge(o, left_on="l_orderkey", right_on="o_orderkey") \
             .merge(cu, left_on="o_custkey", right_on="c_custkey") \
             .merge(na, left_on="c_nationkey", right_on="n_nationkey")
        j = j.assign(rev=j.l_extendedprice * (1 - j.l_discount))
        g = j.groupby(["c_custkey", "c_name", "c_acctbal", "c_phone",
                       "n_name", "c_address", "c_comment"]).rev.sum() \
             .reset_index().rename(columns={"rev": "revenue"})
        g = g.sort_values("revenue", ascending=False, kind="stable").head(20)
        return g[["c_custkey", "c_name", "revenue", "c_acctbal", "n_name",
                  "c_address", "c_phone", "c_comment"]]
    if name == "q12":
        l = li[li.l_shipmode.isin(["MAIL", "SHIP"])
               & (li.l_commitdate < li.l_receiptdate)
               & (li.l_shipdate < li.l_commitdate)
               & (li.l_receiptdate >= date32(1994, 1, 1))
               & (li.l_receiptdate < date32(1995, 1, 1))]
        j = l.merge(od, left_on="l_orderkey", right_on="o_orderkey")
        hi = j.o_orderpriority.isin(["1-URGENT", "2-HIGH"])
        j = j.assign(h=hi.astype(np.int64), lo=(~hi).astype(np.int64))
        g = j.groupby("l_shipmode").agg(high_line_count=("h", "sum"),
                                        low_line_count=("lo", "sum")).reset_index()
        return g.sort_values("l_shipmode")
    if name == "q14":
        pa = f["part"]
        l = li[(li.l_shipdate >= date32(1995, 9, 1))
               & (li.l_shipdate < date32(1995, 10, 1))]
        j = l.merge(pa, left_on="l_partkey", right_on="p_partkey")
        rev = j.l_extendedprice * (1 - j.l_discount)
        promo = rev.where(j.p_type.str.startswith("PROMO"), 0.0)
        return pd.DataFrame({"promo_revenue":
                             [100.0 * promo.sum() / rev.sum()]})
    if name == "q19":
        pa = f["part"]
        j = li.merge(pa, left_on="l_partkey", right_on="p_partkey")
        ship = j.l_shipmode.isin(["AIR", "AIR REG"]) & \
            (j.l_shipinstruct == "DELIVER IN PERSON")
        c1 = (j.p_brand == "Brand#12") \
            & j.p_container.isin(["SM CASE", "SM BOX", "SM PACK", "SM PKG"]) \
            & (j.l_quantity >= 1) & (j.l_quantity <= 11) \
            & (j.p_size >= 1) & (j.p_size <= 5) & ship
        c2 = (j.p_brand == "Brand#23") \
            & j.p_container.isin(["MED BAG", "MED BOX", "MED PKG", "MED PACK"]) \
            & (j.l_quantity >= 10) & (j.l_quantity <= 20) \
            & (j.p_size >= 1) & (j.p_size <= 10) & ship
        c3 = (j.p_brand == "Brand#34") \
            & j.p_container.isin(["LG CASE", "LG BOX", "LG PACK", "LG PKG"]) \
            & (j.l_quantity >= 20) & (j.l_quantity <= 30) \
            & (j.p_size >= 1) & (j.p_size <= 15) & ship
        d = j[c1 | c2 | c3]
        rev = (d.l_extendedprice * (1 - d.l_discount)).sum() if len(d) \
            else np.nan   # SQL: SUM over empty set is NULL
        return pd.DataFrame({"revenue": [rev]})
    if name == "q13":
        o = od[~od.o_comment.str.match(r".*special.*requests.*")]
        j = cu.merge(o, left_on="c_custkey", right_on="o_custkey", how="left")
        per_cust = j.groupby("c_custkey").o_orderkey.count() \
            .reset_index(name="c_count")
        g = per_cust.groupby("c_count").size().reset_index(name="custdist")
        return g.sort_values(["custdist", "c_count"], ascending=[False, False],
                             kind="stable")
    if name == "q15":
        su = f["supplier"]
        l = li[(li.l_shipdate >= date32(1996, 1, 1))
               & (li.l_shipdate < date32(1996, 4, 1))]
        rev = (l.assign(r=l.l_extendedprice * (1 - l.l_discount))
               .groupby("l_suppkey").r.sum().reset_index(name="total_revenue"))
        top = rev[rev.total_revenue == rev.total_revenue.max()]
        j = su.merge(top, left_on="s_suppkey", right_on="l_suppkey")
        j = j.sort_values("s_suppkey")
        return j[["s_suppkey", "s_name", "s_address", "s_phone",
                  "total_revenue"]]
    if name == "q16":
        pa, ps, su = f["part"], f["partsupp"], f["supplier"]
        bad = su[su.s_comment.str.match(r".*Customer.*Complaints.*")].s_suppkey
        p = pa[(pa.p_brand != "Brand#45")
               & ~pa.p_type.str.startswith("MEDIUM POLISHED")
               & pa.p_size.isin([49, 14, 23, 45, 19, 3, 36, 9])]
        j = ps.merge(p, left_on="ps_partkey", right_on="p_partkey")
        j = j[~j.ps_suppkey.isin(bad)]
        g = j.groupby(["p_brand", "p_type", "p_size"]).ps_suppkey.nunique() \
             .reset_index(name="supplier_cnt")
        return g.sort_values(["supplier_cnt", "p_brand", "p_type", "p_size"],
                             ascending=[False, True, True, True],
                             kind="stable")
    if name == "q21":
        su, na = f["supplier"], f["nation"]
        multi = li.groupby("l_orderkey").l_suppkey.nunique()
        late = li[li.l_receiptdate > li.l_commitdate]
        late_multi = late.groupby("l_orderkey").l_suppkey.nunique()
        j = late.merge(su, left_on="l_suppkey", right_on="s_suppkey") \
                .merge(od, left_on="l_orderkey", right_on="o_orderkey") \
                .merge(na, left_on="s_nationkey", right_on="n_nationkey")
        j = j[(j.o_orderstatus == "F") & (j.n_name == "SAUDI ARABIA")]
        # exists: another supplier on the order; not exists: another LATE one
        j = j[j.l_orderkey.map(multi).fillna(0) > 1]
        j = j[j.l_orderkey.map(late_multi).fillna(0) == 1]
        g = j.groupby("s_name").size().reset_index(name="numwait")
        return g.sort_values(["numwait", "s_name"], ascending=[False, True],
                             kind="stable")
    raise KeyError(name)


def assert_frames_match(got: pd.DataFrame, want: pd.DataFrame,
                        ordered: bool, rtol: float = 1e-9):
    assert list(got.columns) == list(want.columns), \
        f"columns {list(got.columns)} != {list(want.columns)}"
    assert len(got) == len(want), f"rows {len(got)} != {len(want)}"
    g, w = got.reset_index(drop=True), want.reset_index(drop=True)
    if not ordered and len(g):
        cols = list(g.columns)
        g = g.sort_values(cols, kind="stable").reset_index(drop=True)
        w = w.sort_values(cols, kind="stable").reset_index(drop=True)
    for col in g.columns:
        gv, wv = g[col].to_numpy(), w[col].to_numpy()
        if gv.dtype == object or wv.dtype == object:
            try:
                gf = np.array([np.nan if x is None else float(x) for x in gv])
                wf = np.array([np.nan if x is None else float(x) for x in wv])
            except (TypeError, ValueError):
                assert list(gv) == list(wv), f"column {col} differs"
                continue
            np.testing.assert_allclose(gf, wf, rtol=rtol, err_msg=f"column {col}")
        elif np.issubdtype(np.asarray(wv).dtype, np.floating):
            np.testing.assert_allclose(gv.astype(np.float64),
                                       wv.astype(np.float64), rtol=rtol,
                                       err_msg=f"column {col}")
        else:
            np.testing.assert_array_equal(gv.astype(np.int64),
                                          wv.astype(np.int64),
                                          err_msg=f"column {col}")
