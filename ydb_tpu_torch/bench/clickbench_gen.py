"""ClickBench-style `hits` table generator (BASELINE config #5).

The reference ships the 43-query ClickBench suite with canonical results
(`ydb/public/lib/ydb_cli/commands/click_bench_queries.sql`,
`click_bench_canonical/`). The public dataset is a 100M-row web-analytics
log; this generator produces a statistically similar table (the column
subset the query suite touches): high-cardinality ids, skewed categorical
ids, zipfian search phrases/URLs, timestamps over a month.

Deterministic (seeded) — oracle results are reproducible.
"""

from __future__ import annotations

import numpy as np

from ydb_tpu_torch.core import dtypes as dt
from ydb_tpu_torch.core.schema import Column, Schema

HITS_SCHEMA = Schema([
    Column("WatchID", dt.DType(dt.Kind.INT64, False)),
    Column("JavaEnable", dt.DType(dt.Kind.INT64, False)),
    Column("EventTime", dt.DType(dt.Kind.INT64, False)),   # unix seconds
    Column("EventDate", dt.DType(dt.Kind.DATE32, False)),
    Column("CounterID", dt.DType(dt.Kind.INT64, False)),
    Column("ClientIP", dt.DType(dt.Kind.INT64, False)),
    Column("RegionID", dt.DType(dt.Kind.INT64, False)),
    Column("UserID", dt.DType(dt.Kind.INT64, False)),
    Column("OS", dt.DType(dt.Kind.INT64, False)),
    Column("AdvEngineID", dt.DType(dt.Kind.INT64, False)),
    Column("IsRefresh", dt.DType(dt.Kind.INT64, False)),
    Column("ResolutionWidth", dt.DType(dt.Kind.INT64, False)),
    Column("IsLink", dt.DType(dt.Kind.INT64, False)),
    Column("IsDownload", dt.DType(dt.Kind.INT64, False)),
    Column("SearchEngineID", dt.DType(dt.Kind.INT64, False)),
    Column("SearchPhrase", dt.DType(dt.Kind.STRING, False)),
    Column("MobilePhone", dt.DType(dt.Kind.INT64, False)),
    Column("MobilePhoneModel", dt.DType(dt.Kind.STRING, False)),
    Column("URL", dt.DType(dt.Kind.STRING, False)),
    Column("Title", dt.DType(dt.Kind.STRING, False)),
    Column("Referer", dt.DType(dt.Kind.STRING, False)),
    Column("UserAgent", dt.DType(dt.Kind.INT64, False)),
    Column("TraficSourceID", dt.DType(dt.Kind.INT64, False)),
    Column("DontCountHits", dt.DType(dt.Kind.INT64, False)),
    Column("URLHash", dt.DType(dt.Kind.INT64, False)),
    Column("RefererHash", dt.DType(dt.Kind.INT64, False)),
    Column("WindowClientWidth", dt.DType(dt.Kind.INT64, False)),
    Column("WindowClientHeight", dt.DType(dt.Kind.INT64, False)),
])

_WORDS = np.array(["google", "yandex", "weather", "news", "cars", "phones",
                   "games", "music", "maps", "cinema", "travel", "recipes",
                   "football", "crypto", "python", "shoes", "hotels", ""])
_MODELS = np.array(["", "", "", "iPhone", "Galaxy", "Pixel", "Nokia"])
_REF_HOSTS = np.array(["google.com", "www.yandex.ru", "news.site",
                       "example.com", "forum.example.org", "blog.io"])


def content_hash(s: str) -> int:
    """Deterministic content-addressed 63-bit string hash (URLHash /
    RefererHash columns — the real dataset carries precomputed sipHash-like
    url hashes; content addressing keeps query constants stable)."""
    import hashlib
    return int.from_bytes(hashlib.sha1(s.encode()).digest()[:8],
                          "little") >> 1


def gen_hits(n_rows: int, seed: int = 20260729,
             url_cardinality: int = 0) -> dict:
    """`url_cardinality` > 0: URL and Referer gain random path suffixes
    drawn from that many values (distinct combinations multiply with the
    word pools) — the real dataset's URL column is near-unique, the
    dictionary-degeneracy case the string lane must survive (VERDICT r3
    item 6)."""
    rng = np.random.default_rng(seed)
    n = n_rows
    zipf = lambda k, size: np.minimum(  # noqa: E731
        rng.zipf(1.5, size), k) - 1
    day0 = 19530                       # 2023-06-22
    date = day0 + rng.integers(0, 31, n)
    phrase_ix = zipf(len(_WORDS), n)
    # ~60% empty search phrases, like the real data
    phrase_ix = np.where(rng.random(n) < 0.6, len(_WORDS) - 1, phrase_ix)
    phrases = _WORDS[phrase_ix]
    two = _WORDS[zipf(len(_WORDS) - 1, n)]
    phrases = np.where(
        (phrases != "") & (rng.random(n) < 0.4),
        np.char.add(np.char.add(phrases.astype(str), " "), two.astype(str)),
        phrases)
    urls = np.char.add("http://example.com/",
                       _WORDS[zipf(len(_WORDS) - 1, n)].astype(str))
    if url_cardinality:
        suffix = (rng.integers(0, url_cardinality, n)).astype("U10")
        urls = np.char.add(np.char.add(urls, "/p"), suffix)
    titles = np.char.add(np.char.capitalize(
        _WORDS[zipf(len(_WORDS) - 1, n)].astype(str)), " page")
    ref_host = _REF_HOSTS[zipf(len(_REF_HOSTS), n)]
    ref_path = _WORDS[zipf(len(_WORDS) - 1, n)]
    referers = np.char.add(np.char.add(np.char.add(
        "https://", ref_host.astype(str)), "/"), ref_path.astype(str))
    if url_cardinality:
        rsuf = (rng.integers(0, url_cardinality, n)).astype("U10")
        referers = np.char.add(np.char.add(referers, "/r"), rsuf)
    referers = np.where(rng.random(n) < 0.4, "", referers)
    def _hashes(arr):
        uniq, inv = np.unique(arr, return_inverse=True)
        return np.array([content_hash(u) for u in uniq],
                        dtype=np.int64)[inv]
    url_hashes = _hashes(urls)
    ref_hashes = _hashes(referers)
    return {
        "WatchID": rng.integers(1, 1 << 60, n),
        "JavaEnable": rng.integers(0, 2, n),
        "EventTime": (date.astype(np.int64) * 86400
                      + rng.integers(0, 86400, n)),
        "EventDate": date.astype(np.int32),
        "CounterID": zipf(8000, n) + 1,
        "ClientIP": rng.integers(0, 1 << 31, n),
        "RegionID": zipf(5000, n) + 1,
        "UserID": rng.integers(1, n // 3 + 2, n),
        "OS": zipf(80, n),
        "AdvEngineID": np.where(rng.random(n) < 0.95, 0, zipf(60, n) + 1),
        "IsRefresh": (rng.random(n) < 0.13).astype(np.int64),
        "ResolutionWidth": rng.choice(
            [0, 1024, 1280, 1366, 1440, 1536, 1600, 1920, 2560], n),
        "IsLink": (rng.random(n) < 0.07).astype(np.int64),
        "IsDownload": (rng.random(n) < 0.02).astype(np.int64),
        "SearchEngineID": np.where(phrases == "", 0, zipf(90, n) + 1),
        "SearchPhrase": phrases.astype(object),
        "MobilePhone": zipf(9, n),
        "MobilePhoneModel": _MODELS[zipf(len(_MODELS), n)].astype(object),
        "URL": urls.astype(object),
        "Title": titles.astype(object),
        "Referer": referers.astype(object),
        "UserAgent": zipf(80, n) + 1,
        "TraficSourceID": rng.integers(-1, 10, n),
        "DontCountHits": (rng.random(n) < 0.05).astype(np.int64),
        "URLHash": url_hashes,
        "RefererHash": ref_hashes,
        "WindowClientWidth": rng.choice(
            [0, 1024, 1280, 1366, 1440, 1920], n),
        "WindowClientHeight": rng.choice([0, 600, 720, 768, 900, 1080], n),
    }


def load_hits(catalog, n_rows: int = 100_000, shards: int = 1,
              portion_rows: int = 1 << 20, seed: int = 20260729,
              url_cardinality: int = 0) -> dict:
    """Create and fill the `hits` table; returns the raw numpy arrays."""
    import pandas as pd

    from ydb_tpu_torch.storage.mvcc import WriteVersion
    raw = gen_hits(n_rows, seed, url_cardinality=url_cardinality)
    table = catalog.create_table("hits", HITS_SCHEMA, ["WatchID"],
                                 shards=shards, portion_rows=portion_rows)
    table.bulk_upsert(pd.DataFrame(raw), WriteVersion(1, 1))
    return raw
