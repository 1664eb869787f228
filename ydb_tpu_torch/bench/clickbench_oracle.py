"""ClickBench: the full 43-query suite + pandas oracles.

The standard public ClickBench queries (the reference carries all 43 in
`ydb/public/lib/ydb_cli/commands/click_bench_queries.sql`), adapted only
where the public text is nondeterministic or scale-bound:
  * deterministic tie-breaker sort keys added so results pin exactly
    (the reference pins canonical *result rows* the same way,
    `click_bench_canonical/`);
  * HAVING thresholds / OFFSETs scaled to the generated table size
    (the public texts assume the 100M-row hits dataset);
  * `GROUP BY 1, URL` (Q34) written as a constant select item;
    `DATE_TRUNC('minute', EventTime)` (Q42) written as the equivalent
    seconds arithmetic.
Query shapes — filters, aggregate sets, string functions, regex,
CASE-over-strings, OFFSET pagination — are the originals.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from ydb_tpu_torch.bench.clickbench_gen import content_hash

# point-filter constants: content-addressed hashes of the most common
# generated URL / Referer (see clickbench_gen.gen_hits)
_URLHASH = content_hash("http://example.com/google")
_REFHASH = content_hash("https://google.com/google")

_Q29_SUMS = ", ".join(
    f"sum(ResolutionWidth + {k}) as s{k}" for k in range(90))

_Q36_FILTER = ("CounterID = 62 and EventDate >= date '2023-06-22' "
               "and EventDate <= date '2023-07-22' ")

QUERIES = {
    "c0": "select count(*) as c from hits",
    "c1": "select count(*) as c from hits where AdvEngineID <> 0",
    "c2": ("select sum(AdvEngineID) as s, count(*) as c, "
           "avg(ResolutionWidth) as a from hits"),
    "c3": "select avg(UserID) as a from hits",
    "c4": "select count(distinct UserID) as u from hits",
    "c5": "select count(distinct SearchPhrase) as p from hits",
    "c6": "select min(EventDate) as mn, max(EventDate) as mx from hits",
    "c7": ("select AdvEngineID, count(*) as c from hits "
           "where AdvEngineID <> 0 group by AdvEngineID "
           "order by c desc, AdvEngineID"),
    "c8": ("select RegionID, count(distinct UserID) as u from hits "
           "group by RegionID order by u desc, RegionID limit 10"),
    "c9": ("select RegionID, sum(AdvEngineID) as s, count(*) as c, "
           "avg(ResolutionWidth) as a, count(distinct UserID) as u "
           "from hits group by RegionID order by c desc, RegionID limit 10"),
    "c10": ("select MobilePhoneModel, count(distinct UserID) as u from hits "
            "where MobilePhoneModel <> '' group by MobilePhoneModel "
            "order by u desc, MobilePhoneModel limit 10"),
    "c11": ("select MobilePhone, MobilePhoneModel, "
            "count(distinct UserID) as u "
            "from hits where MobilePhoneModel <> '' "
            "group by MobilePhone, MobilePhoneModel "
            "order by u desc, MobilePhone, MobilePhoneModel limit 10"),
    "c12": ("select SearchPhrase, count(*) as c from hits "
            "where SearchPhrase <> '' group by SearchPhrase "
            "order by c desc, SearchPhrase limit 10"),
    "c13": ("select SearchPhrase, count(distinct UserID) as u from hits "
            "where SearchPhrase <> '' group by SearchPhrase "
            "order by u desc, SearchPhrase limit 10"),
    "c14": ("select SearchEngineID, SearchPhrase, count(*) as c from hits "
            "where SearchPhrase <> '' group by SearchEngineID, SearchPhrase "
            "order by c desc, SearchEngineID, SearchPhrase limit 10"),
    "c15": ("select UserID, count(*) as c from hits group by UserID "
            "order by c desc, UserID limit 10"),
    "c16": ("select UserID, SearchPhrase, count(*) as c from hits "
            "group by UserID, SearchPhrase "
            "order by c desc, UserID, SearchPhrase limit 10"),
    "c17": ("select UserID, SearchPhrase, count(*) as c from hits "
            "group by UserID, SearchPhrase "
            "order by UserID, SearchPhrase limit 10"),
    "c18": ("select UserID, minute(EventTime) as m, SearchPhrase, "
            "count(*) as c from hits "
            "group by UserID, minute(EventTime), SearchPhrase "
            "order by c desc, UserID, m, SearchPhrase limit 10"),
    "c19": "select UserID from hits where UserID = 1000",
    "c20": "select count(*) as c from hits where URL like '%google%'",
    "c21": ("select SearchPhrase, min(URL) as mu, count(*) as c from hits "
            "where URL like '%google%' and SearchPhrase <> '' "
            "group by SearchPhrase order by c desc, SearchPhrase limit 10"),
    "c22": ("select SearchPhrase, min(URL) as mu, min(Title) as mt, "
            "count(*) as c, count(distinct UserID) as u from hits "
            "where Title like '%Google%' and URL not like '%.google.%' "
            "and SearchPhrase <> '' group by SearchPhrase "
            "order by c desc, SearchPhrase limit 10"),
    "c23": ("select * from hits where URL like '%google%' "
            "order by EventTime, WatchID limit 10"),
    "c24": ("select SearchPhrase from hits where SearchPhrase <> '' "
            "order by EventTime, WatchID limit 10"),
    "c25": ("select SearchPhrase from hits where SearchPhrase <> '' "
            "order by SearchPhrase limit 10"),
    "c26": ("select SearchPhrase from hits where SearchPhrase <> '' "
            "order by EventTime, SearchPhrase, WatchID limit 10"),
    "c27": ("select CounterID, avg(length(URL)) as l, count(*) as c "
            "from hits where URL <> '' group by CounterID "
            "having count(*) > 25 order by l desc, CounterID limit 25"),
    "c28": (r"select regexp_replace(Referer, "
            r"'^https?://(?:www\.)?([^/]+)/.*$', '\1') as k, "
            "avg(length(Referer)) as l, count(*) as c, min(Referer) as mr "
            "from hits where Referer <> '' group by k "
            "having count(*) > 25 order by l desc, k limit 25"),
    "c29": f"select {_Q29_SUMS} from hits",
    "c30": ("select SearchEngineID, ClientIP, count(*) as c, "
            "sum(IsRefresh) as r, avg(ResolutionWidth) as a from hits "
            "where SearchPhrase <> '' group by SearchEngineID, ClientIP "
            "order by c desc, SearchEngineID, ClientIP limit 10"),
    "c31": ("select WatchID, ClientIP, count(*) as c, sum(IsRefresh) as r, "
            "avg(ResolutionWidth) as a from hits "
            "where SearchPhrase <> '' group by WatchID, ClientIP "
            "order by c desc, WatchID, ClientIP limit 10"),
    "c32": ("select WatchID, ClientIP, count(*) as c, sum(IsRefresh) as r, "
            "avg(ResolutionWidth) as a from hits "
            "group by WatchID, ClientIP "
            "order by c desc, WatchID, ClientIP limit 10"),
    "c33": ("select URL, count(*) as c from hits group by URL "
            "order by c desc, URL limit 10"),
    "c34": ("select 1 as one, URL, count(*) as c from hits group by URL "
            "order by c desc, URL limit 10"),
    "c35": ("select ClientIP, ClientIP - 1 as m1, ClientIP - 2 as m2, "
            "ClientIP - 3 as m3, count(*) as c from hits "
            "group by ClientIP, ClientIP - 1, ClientIP - 2, ClientIP - 3 "
            "order by c desc, ClientIP limit 10"),
    "c36": ("select URL, count(*) as PageViews from hits "
            f"where {_Q36_FILTER} and DontCountHits = 0 and IsRefresh = 0 "
            "and URL <> '' group by URL "
            "order by PageViews desc, URL limit 10"),
    "c37": ("select Title, count(*) as PageViews from hits "
            f"where {_Q36_FILTER} and DontCountHits = 0 and IsRefresh = 0 "
            "and Title <> '' group by Title "
            "order by PageViews desc, Title limit 10"),
    "c38": ("select URL, count(*) as PageViews from hits "
            f"where {_Q36_FILTER} and IsRefresh = 0 and IsLink <> 0 "
            "and IsDownload = 0 group by URL "
            "order by PageViews desc, URL limit 10 offset 2"),
    "c39": ("select TraficSourceID, SearchEngineID, AdvEngineID, "
            "case when SearchEngineID = 0 and AdvEngineID = 0 "
            "then Referer else '' end as Src, URL as Dst, "
            "count(*) as PageViews from hits "
            f"where {_Q36_FILTER} and IsRefresh = 0 "
            "group by TraficSourceID, SearchEngineID, AdvEngineID, "
            "Src, URL "
            "order by PageViews desc, TraficSourceID, SearchEngineID, "
            "AdvEngineID, Src, Dst limit 10 offset 2"),
    "c40": ("select URLHash, EventDate, count(*) as PageViews from hits "
            f"where {_Q36_FILTER} and IsRefresh = 0 "
            "and TraficSourceID in (-1, 6) "
            f"and RefererHash = {_REFHASH} "
            "group by URLHash, EventDate "
            "order by PageViews desc, URLHash, EventDate limit 10"),
    "c41": ("select WindowClientWidth, WindowClientHeight, "
            "count(*) as PageViews from hits "
            f"where {_Q36_FILTER} and IsRefresh = 0 and DontCountHits = 0 "
            f"and URLHash = {_URLHASH} "
            "group by WindowClientWidth, WindowClientHeight "
            "order by PageViews desc, WindowClientWidth, "
            "WindowClientHeight limit 10"),
    "c42": ("select EventTime - (EventTime % 60) as M, "
            "count(*) as PageViews from hits "
            "where CounterID = 62 and EventDate >= date '2023-06-22' "
            "and EventDate <= date '2023-06-24' "
            "and IsRefresh = 0 and DontCountHits = 0 "
            "group by EventTime - (EventTime % 60) "
            "order by M limit 10 offset 2"),
}


def _top(g: pd.DataFrame, by: list, asc: list, n: int = 10,
         off: int = 0) -> pd.DataFrame:
    return g.sort_values(by, ascending=asc).iloc[off:off + n]


def oracle(name: str, raw: dict) -> pd.DataFrame:
    df = pd.DataFrame(raw)
    if name == "c0":
        return pd.DataFrame({"c": [len(df)]})
    if name == "c1":
        return pd.DataFrame({"c": [int((df.AdvEngineID != 0).sum())]})
    if name == "c2":
        return pd.DataFrame({"s": [df.AdvEngineID.sum()], "c": [len(df)],
                             "a": [df.ResolutionWidth.mean()]})
    if name == "c3":
        return pd.DataFrame({"a": [df.UserID.mean()]})
    if name == "c4":
        return pd.DataFrame({"u": [df.UserID.nunique()]})
    if name == "c5":
        return pd.DataFrame({"p": [df.SearchPhrase.nunique()]})
    if name == "c6":
        return pd.DataFrame({"mn": [df.EventDate.min()],
                             "mx": [df.EventDate.max()]})
    if name == "c7":
        g = df[df.AdvEngineID != 0].groupby("AdvEngineID").size() \
            .reset_index(name="c")
        return g.sort_values(["c", "AdvEngineID"], ascending=[False, True])
    if name == "c8":
        g = df.groupby("RegionID").UserID.nunique().reset_index(name="u")
        return _top(g, ["u", "RegionID"], [False, True])
    if name == "c9":
        g = df.groupby("RegionID").agg(
            s=("AdvEngineID", "sum"), c=("AdvEngineID", "size"),
            a=("ResolutionWidth", "mean"),
            u=("UserID", "nunique")).reset_index()
        return _top(g, ["c", "RegionID"], [False, True])
    if name == "c10":
        d = df[df.MobilePhoneModel != ""]
        g = d.groupby("MobilePhoneModel").UserID.nunique() \
            .reset_index(name="u")
        return _top(g, ["u", "MobilePhoneModel"], [False, True])
    if name == "c11":
        d = df[df.MobilePhoneModel != ""]
        g = d.groupby(["MobilePhone", "MobilePhoneModel"]) \
            .UserID.nunique().reset_index(name="u")
        return _top(g, ["u", "MobilePhone", "MobilePhoneModel"],
                    [False, True, True])
    if name == "c12":
        d = df[df.SearchPhrase != ""]
        g = d.groupby("SearchPhrase").size().reset_index(name="c")
        return _top(g, ["c", "SearchPhrase"], [False, True])
    if name == "c13":
        d = df[df.SearchPhrase != ""]
        g = d.groupby("SearchPhrase").UserID.nunique().reset_index(name="u")
        return _top(g, ["u", "SearchPhrase"], [False, True])
    if name == "c14":
        d = df[df.SearchPhrase != ""]
        g = d.groupby(["SearchEngineID", "SearchPhrase"]).size() \
            .reset_index(name="c")
        return _top(g, ["c", "SearchEngineID", "SearchPhrase"],
                    [False, True, True])
    if name == "c15":
        g = df.groupby("UserID").size().reset_index(name="c")
        return _top(g, ["c", "UserID"], [False, True])
    if name == "c16":
        g = df.groupby(["UserID", "SearchPhrase"]).size() \
            .reset_index(name="c")
        return _top(g, ["c", "UserID", "SearchPhrase"],
                    [False, True, True])
    if name == "c17":
        g = df.groupby(["UserID", "SearchPhrase"]).size() \
            .reset_index(name="c")
        return _top(g, ["UserID", "SearchPhrase"], [True, True])
    if name == "c18":
        d = df.assign(m=(df.EventTime // 60) % 60)
        g = d.groupby(["UserID", "m", "SearchPhrase"]).size() \
            .reset_index(name="c")
        return _top(g, ["c", "UserID", "m", "SearchPhrase"],
                    [False, True, True, True])
    if name == "c19":
        return df[df.UserID == 1000][["UserID"]]
    if name == "c20":
        return pd.DataFrame(
            {"c": [int(df.URL.str.contains("google").sum())]})
    if name == "c21":
        d = df[df.URL.str.contains("google") & (df.SearchPhrase != "")]
        g = d.groupby("SearchPhrase").agg(
            mu=("URL", "min"), c=("URL", "size")).reset_index()
        return _top(g, ["c", "SearchPhrase"], [False, True])
    if name == "c22":
        d = df[df.Title.str.contains("Google")
               & ~df.URL.str.contains(".google.", regex=False)
               & (df.SearchPhrase != "")]
        g = d.groupby("SearchPhrase").agg(
            mu=("URL", "min"), mt=("Title", "min"), c=("URL", "size"),
            u=("UserID", "nunique")).reset_index()
        return _top(g, ["c", "SearchPhrase"], [False, True])
    if name == "c23":
        d = df[df.URL.str.contains("google")]
        return _top(d, ["EventTime", "WatchID"], [True, True])
    if name == "c24":
        d = df[df.SearchPhrase != ""]
        return _top(d, ["EventTime", "WatchID"],
                    [True, True])[["SearchPhrase"]]
    if name == "c25":
        d = df[df.SearchPhrase != ""]
        return _top(d, ["SearchPhrase"], [True])[["SearchPhrase"]]
    if name == "c26":
        d = df[df.SearchPhrase != ""]
        return _top(d, ["EventTime", "SearchPhrase", "WatchID"],
                    [True, True, True])[["SearchPhrase"]]
    if name == "c27":
        d = df[df.URL != ""].assign(ulen=df.URL.str.len())
        g = d.groupby("CounterID").agg(
            l=("ulen", "mean"), c=("ulen", "size")).reset_index()
        g = g[g.c > 25]
        return _top(g, ["l", "CounterID"], [False, True], 25)
    if name == "c28":
        d = df[df.Referer != ""]
        k = d.Referer.str.replace(
            r"^https?://(?:www\.)?([^/]+)/.*$", r"\1", regex=True)
        d = d.assign(k=k, rlen=d.Referer.str.len())
        g = d.groupby("k").agg(
            l=("rlen", "mean"), c=("rlen", "size"),
            mr=("Referer", "min")).reset_index()
        g = g[g.c > 25]
        return _top(g, ["l", "k"], [False, True], 25)
    if name == "c29":
        return pd.DataFrame({f"s{k}": [int((df.ResolutionWidth + k).sum())]
                             for k in range(90)})
    if name == "c30":
        d = df[df.SearchPhrase != ""]
        g = d.groupby(["SearchEngineID", "ClientIP"]).agg(
            c=("IsRefresh", "size"), r=("IsRefresh", "sum"),
            a=("ResolutionWidth", "mean")).reset_index()
        return _top(g, ["c", "SearchEngineID", "ClientIP"],
                    [False, True, True])
    if name in ("c31", "c32"):
        d = df[df.SearchPhrase != ""] if name == "c31" else df
        g = d.groupby(["WatchID", "ClientIP"]).agg(
            c=("IsRefresh", "size"), r=("IsRefresh", "sum"),
            a=("ResolutionWidth", "mean")).reset_index()
        return _top(g, ["c", "WatchID", "ClientIP"], [False, True, True])
    if name == "c33":
        g = df.groupby("URL").size().reset_index(name="c")
        return _top(g, ["c", "URL"], [False, True])
    if name == "c34":
        g = df.groupby("URL").size().reset_index(name="c")
        g.insert(0, "one", 1)
        return _top(g, ["c", "URL"], [False, True])
    if name == "c35":
        g = df.groupby("ClientIP").size().reset_index(name="c")
        g["m1"], g["m2"], g["m3"] = \
            g.ClientIP - 1, g.ClientIP - 2, g.ClientIP - 3
        g = g[["ClientIP", "m1", "m2", "m3", "c"]]
        return _top(g, ["c", "ClientIP"], [False, True])
    base = df[(df.CounterID == 62)
              & (df.EventDate >= 19530) & (df.EventDate <= 19560)]
    if name == "c36":
        d = base[(base.DontCountHits == 0) & (base.IsRefresh == 0)
                 & (base.URL != "")]
        g = d.groupby("URL").size().reset_index(name="PageViews")
        return _top(g, ["PageViews", "URL"], [False, True])
    if name == "c37":
        d = base[(base.DontCountHits == 0) & (base.IsRefresh == 0)
                 & (base.Title != "")]
        g = d.groupby("Title").size().reset_index(name="PageViews")
        return _top(g, ["PageViews", "Title"], [False, True])
    if name == "c38":
        d = base[(base.IsRefresh == 0) & (base.IsLink != 0)
                 & (base.IsDownload == 0)]
        g = d.groupby("URL").size().reset_index(name="PageViews")
        return _top(g, ["PageViews", "URL"], [False, True], 10, 2)
    if name == "c39":
        d = base[base.IsRefresh == 0]
        src = np.where((d.SearchEngineID == 0) & (d.AdvEngineID == 0),
                       d.Referer, "")
        d = d.assign(Src=src, Dst=d.URL)
        g = d.groupby(["TraficSourceID", "SearchEngineID", "AdvEngineID",
                       "Src", "Dst"]).size().reset_index(name="PageViews")
        return _top(g, ["PageViews", "TraficSourceID", "SearchEngineID",
                        "AdvEngineID", "Src", "Dst"],
                    [False, True, True, True, True, True], 10, 2)
    if name == "c40":
        d = base[(base.IsRefresh == 0)
                 & base.TraficSourceID.isin([-1, 6])
                 & (base.RefererHash == _REFHASH)]
        g = d.groupby(["URLHash", "EventDate"]).size() \
            .reset_index(name="PageViews")
        return _top(g, ["PageViews", "URLHash", "EventDate"],
                    [False, True, True])
    if name == "c41":
        d = base[(base.IsRefresh == 0) & (base.DontCountHits == 0)
                 & (base.URLHash == _URLHASH)]
        g = d.groupby(["WindowClientWidth", "WindowClientHeight"]).size() \
            .reset_index(name="PageViews")
        return _top(g, ["PageViews", "WindowClientWidth",
                        "WindowClientHeight"], [False, True, True])
    if name == "c42":
        d = df[(df.CounterID == 62)
               & (df.EventDate >= 19530) & (df.EventDate <= 19532)
               & (df.IsRefresh == 0) & (df.DontCountHits == 0)]
        g = d.assign(M=d.EventTime - (d.EventTime % 60)) \
            .groupby("M").size().reset_index(name="PageViews")
        return _top(g, ["M"], [True], 10, 2)
    raise KeyError(name)
