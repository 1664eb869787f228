"""Deterministic TPC-H data generator (numpy, scale-factor parametrized).

Plays the role of the reference's `ydb workload tpch init --scale N` data
population (`ydb/public/lib/ydb_cli/commands/tpch.h:9-66`,
`ydb/library/workload/tpch/`): all eight tables with the standard row-count
scaling, spec-shaped value domains (dates 1992-01-01..1998-12-01, the Q1
returnflag/linestatus alphabet, per-column distributions close enough that
the benchmark queries exercise the same selectivities), and referential
integrity between keys. Decimals are Double, matching the reference's own
TPC-H schema choice (`tpch_schema.sql:4`).

Not a bit-exact dbgen: query *results* are validated against a pandas
oracle over the same generated data, and canonical-result pinning happens
at that layer (analog of `click_bench_canonical/`).
"""

from __future__ import annotations

import numpy as np

from ydb_tpu_torch.core import dtypes as dt
from ydb_tpu_torch.core.schema import Column, Schema

EPOCH_1992 = 8035     # days from 1970-01-01 to 1992-01-01
EPOCH_1998_08 = 10439  # days to 1998-08-01
DATE_SPAN = 2526      # 1992-01-01 .. 1998-12-01


def date32(y: int, m: int, d: int) -> int:
    """Civil date → days since epoch (host-side mirror of ops/kernels _civil)."""
    yy = y - (1 if m <= 2 else 0)
    era = (yy if yy >= 0 else yy - 399) // 400
    yoe = yy - era * 400
    mp = m + (9 if m <= 2 else -3)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


_S = lambda: dt.DType(dt.Kind.STRING, nullable=False)  # noqa: E731
_I64 = dt.DType(dt.Kind.INT64, nullable=False)
_I32 = dt.DType(dt.Kind.INT32, nullable=False)
_F64 = dt.DType(dt.Kind.FLOAT64, nullable=False)
_D32 = dt.DType(dt.Kind.DATE32, nullable=False)


TPCH_SCHEMAS: dict[str, tuple[Schema, list[str]]] = {
    "lineitem": (Schema([
        Column("l_orderkey", _I64), Column("l_partkey", _I64),
        Column("l_suppkey", _I64), Column("l_linenumber", _I32),
        Column("l_quantity", _F64), Column("l_extendedprice", _F64),
        Column("l_discount", _F64), Column("l_tax", _F64),
        Column("l_returnflag", _S()), Column("l_linestatus", _S()),
        Column("l_shipdate", _D32), Column("l_commitdate", _D32),
        Column("l_receiptdate", _D32), Column("l_shipinstruct", _S()),
        Column("l_shipmode", _S()), Column("l_comment", _S()),
    ]), ["l_orderkey", "l_linenumber"]),
    "orders": (Schema([
        Column("o_orderkey", _I64), Column("o_custkey", _I64),
        Column("o_orderstatus", _S()), Column("o_totalprice", _F64),
        Column("o_orderdate", _D32), Column("o_orderpriority", _S()),
        Column("o_clerk", _S()), Column("o_shippriority", _I32),
        Column("o_comment", _S()),
    ]), ["o_orderkey"]),
    "customer": (Schema([
        Column("c_custkey", _I64), Column("c_name", _S()),
        Column("c_address", _S()), Column("c_nationkey", _I64),
        Column("c_phone", _S()), Column("c_acctbal", _F64),
        Column("c_mktsegment", _S()), Column("c_comment", _S()),
    ]), ["c_custkey"]),
    "part": (Schema([
        Column("p_partkey", _I64), Column("p_name", _S()),
        Column("p_mfgr", _S()), Column("p_brand", _S()),
        Column("p_type", _S()), Column("p_size", _I32),
        Column("p_container", _S()), Column("p_retailprice", _F64),
        Column("p_comment", _S()),
    ]), ["p_partkey"]),
    "supplier": (Schema([
        Column("s_suppkey", _I64), Column("s_name", _S()),
        Column("s_address", _S()), Column("s_nationkey", _I64),
        Column("s_phone", _S()), Column("s_acctbal", _F64),
        Column("s_comment", _S()),
    ]), ["s_suppkey"]),
    "partsupp": (Schema([
        Column("ps_partkey", _I64), Column("ps_suppkey", _I64),
        Column("ps_availqty", _I32), Column("ps_supplycost", _F64),
        Column("ps_comment", _S()),
    ]), ["ps_partkey", "ps_suppkey"]),
    "nation": (Schema([
        Column("n_nationkey", _I64), Column("n_name", _S()),
        Column("n_regionkey", _I64), Column("n_comment", _S()),
    ]), ["n_nationkey"]),
    "region": (Schema([
        Column("r_regionkey", _I64), Column("r_name", _S()),
        Column("r_comment", _S()),
    ]), ["r_regionkey"]),
}

NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
INSTRUCTS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
CONTAINERS = [f"{a} {b}" for a in ["SM", "LG", "MED", "JUMBO", "WRAP"]
              for b in ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]]
TYPE_1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
P_NAME_WORDS = ["almond", "antique", "aquamarine", "azure", "beige", "bisque",
                "black", "blanched", "blue", "blush", "brown", "burlywood",
                "burnished", "chartreuse", "chiffon", "chocolate", "coral",
                "cornflower", "cornsilk", "cream", "cyan", "dark", "deep",
                "dim", "dodger", "drab", "firebrick", "floral", "forest",
                "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey",
                "honeydew", "hot", "hotpink", "indian", "ivory", "khaki",
                "lace", "lavender", "lawn", "lemon", "light", "lime", "linen"]
COMMENT_WORDS = np.array([
    "carefully", "quickly", "furiously", "slyly", "blithely", "ironic",
    "final", "pending", "regular", "express", "special", "bold", "even",
    "silent", "unusual", "deposits", "requests", "packages", "accounts",
    "instructions", "theodolites", "pinto", "beans", "foxes", "ideas",
    "platelets", "dependencies", "excuses", "asymptotes"], dtype=object)


class TpchData:
    """Generated tables as dicts of numpy arrays (strings = object arrays).

    `fast_strings` (auto-on at sf >= 0.5): per-row Python string building
    is replaced by indexing into pre-built pools (comments, clerks, part
    names) and vectorized np.char construction (phones, entity names) —
    the difference between minutes and hours at SF10+. Value domains and
    query selectivities keep the same shape; oracles recompute over the
    same data either way."""

    def __init__(self, sf: float, seed: int = 19920101,
                 fast_strings: bool | None = None):
        self.sf = sf
        self.fast = (sf >= 0.5) if fast_strings is None else fast_strings
        self.rng = np.random.default_rng(seed)
        self.tables: dict[str, dict[str, np.ndarray]] = {}
        self._generate()

    # -- helpers -----------------------------------------------------------

    def _comment_exact(self, n: int, lo: int, hi: int) -> np.ndarray:
        k = self.rng.integers(lo, hi, n)
        idx = self.rng.integers(0, len(COMMENT_WORDS), (n, hi))
        words = COMMENT_WORDS[idx]
        return np.array([" ".join(words[i, :k[i]]) for i in range(n)], dtype=object)

    def _comment(self, n: int, lo: int = 2, hi: int = 6) -> np.ndarray:
        if not self.fast or n <= 4096:
            return self._comment_exact(n, lo, hi)
        pool = self._comment_exact(4096, lo, hi)
        return pool[self.rng.integers(0, len(pool), n)]

    def _choice(self, options: list[str], n: int) -> np.ndarray:
        return np.array(options, dtype=object)[self.rng.integers(0, len(options), n)]

    def _phone(self, nk: np.ndarray) -> np.ndarray:
        r = self.rng
        a = r.integers(100, 1000, len(nk))
        b = r.integers(100, 1000, len(nk))
        c = r.integers(1000, 10000, len(nk))
        if self.fast:
            parts = [(10 + nk).astype("U2"), a.astype("U3"),
                     b.astype("U3"), c.astype("U4")]
            out = parts[0]
            for p in parts[1:]:
                out = np.char.add(np.char.add(out, "-"), p)
            return out.astype(object)
        return np.array([f"{10 + k}-{x}-{y}-{z}"
                         for k, x, y, z in zip(nk, a, b, c)], dtype=object)

    def _numbered(self, prefix: str, ids: np.ndarray) -> np.ndarray:
        """'Prefix#000000001'-style names, vectorized in fast mode."""
        if self.fast:
            digits = np.char.zfill(ids.astype(np.int64).astype("U10"), 9)
            return np.char.add(prefix + "#", digits).astype(object)
        return np.array([f"{prefix}#{i:09d}" for i in ids], dtype=object)

    # -- generation --------------------------------------------------------

    def _generate(self):
        sf, rng = self.sf, self.rng
        n_part = max(1, int(200_000 * sf))
        n_supp = max(1, int(10_000 * sf))
        n_cust = max(1, int(150_000 * sf))
        n_ord = max(1, int(1_500_000 * sf))

        # region / nation
        self.tables["region"] = {
            "r_regionkey": np.arange(5, dtype=np.int64),
            "r_name": np.array(REGIONS, dtype=object),
            "r_comment": self._comment(5),
        }
        nk = np.arange(len(NATIONS), dtype=np.int64)
        self.tables["nation"] = {
            "n_nationkey": nk,
            "n_name": np.array([n for n, _ in NATIONS], dtype=object),
            "n_regionkey": np.array([r for _, r in NATIONS], dtype=np.int64),
            "n_comment": self._comment(len(NATIONS)),
        }

        # supplier
        s_nation = rng.integers(0, len(NATIONS), n_supp).astype(np.int64)
        self.tables["supplier"] = {
            "s_suppkey": np.arange(1, n_supp + 1, dtype=np.int64),
            "s_name": self._numbered("Supplier",
                                     np.arange(1, n_supp + 1)),
            "s_address": self._comment(n_supp, 1, 3),
            "s_nationkey": s_nation,
            "s_phone": self._phone(s_nation),
            "s_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_supp), 2),
            "s_comment": self._comment(n_supp),
        }

        # part
        pn1 = self._choice(TYPE_1, n_part)
        pn2 = self._choice(TYPE_2, n_part)
        pn3 = self._choice(TYPE_3, n_part)
        p_type = np.array([f"{a} {b} {c}" for a, b, c in zip(pn1, pn2, pn3)],
                          dtype=object)
        brand_m = rng.integers(1, 6, n_part)
        brand_n = rng.integers(1, 6, n_part)
        if self.fast and n_part > (1 << 16):
            pool_idx = rng.integers(0, len(P_NAME_WORDS), (1 << 16, 5))
            pool = np.array(
                [" ".join(P_NAME_WORDS[j] for j in pool_idx[i])
                 for i in range(1 << 16)], dtype=object)
            p_name = pool[rng.integers(0, len(pool), n_part)]
        else:
            name_idx = rng.integers(0, len(P_NAME_WORDS), (n_part, 5))
            p_name = np.array(
                [" ".join(P_NAME_WORDS[j] for j in name_idx[i])
                 for i in range(n_part)], dtype=object)
        self.tables["part"] = {
            "p_partkey": np.arange(1, n_part + 1, dtype=np.int64),
            "p_name": p_name,
            "p_mfgr": np.array([f"Manufacturer#{m}" for m in brand_m], dtype=object),
            "p_brand": np.array([f"Brand#{m}{n}" for m, n in zip(brand_m, brand_n)],
                                dtype=object),
            "p_type": p_type,
            "p_size": rng.integers(1, 51, n_part).astype(np.int32),
            "p_container": self._choice(CONTAINERS, n_part),
            "p_retailprice": np.round(
                900 + (np.arange(1, n_part + 1) % 1000) / 10
                + 100 * (np.arange(1, n_part + 1) % 10), 2),
            "p_comment": self._comment(n_part, 1, 3),
        }

        # partsupp: 4 suppliers per part
        ps_part = np.repeat(np.arange(1, n_part + 1, dtype=np.int64), 4)
        ps_supp = np.empty(4 * n_part, dtype=np.int64)
        for j in range(4):
            ps_supp[j::4] = 1 + (np.arange(n_part) + j * (n_supp // 4 + 1)) % n_supp
        self.tables["partsupp"] = {
            "ps_partkey": ps_part,
            "ps_suppkey": ps_supp,
            "ps_availqty": rng.integers(1, 10_000, 4 * n_part).astype(np.int32),
            "ps_supplycost": np.round(rng.uniform(1.0, 1000.0, 4 * n_part), 2),
            "ps_comment": self._comment(4 * n_part),
        }

        # customer
        c_nation = rng.integers(0, len(NATIONS), n_cust).astype(np.int64)
        self.tables["customer"] = {
            "c_custkey": np.arange(1, n_cust + 1, dtype=np.int64),
            "c_name": self._numbered("Customer",
                                     np.arange(1, n_cust + 1)),
            "c_address": self._comment(n_cust, 1, 3),
            "c_nationkey": c_nation,
            "c_phone": self._phone(c_nation),
            "c_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_cust), 2),
            "c_mktsegment": self._choice(SEGMENTS, n_cust),
            "c_comment": self._comment(n_cust),
        }

        # orders (1/3 of customers have no orders, per spec)
        cust_pool = np.arange(1, n_cust + 1, dtype=np.int64)
        cust_pool = cust_pool[cust_pool % 3 != 0] if n_cust >= 3 else cust_pool
        o_cust = cust_pool[rng.integers(0, len(cust_pool), n_ord)]
        o_date = (EPOCH_1992 + rng.integers(0, DATE_SPAN - 151, n_ord)).astype(np.int32)
        self.tables["orders"] = {
            "o_orderkey": np.arange(1, n_ord + 1, dtype=np.int64),
            "o_custkey": o_cust,
            "o_orderstatus": np.full(n_ord, "O", dtype=object),  # fixed below
            "o_totalprice": np.zeros(n_ord),                     # fixed below
            "o_orderdate": o_date,
            "o_orderpriority": self._choice(PRIORITIES, n_ord),
            "o_clerk": self._numbered(
                "Clerk", rng.integers(1, max(2, int(1000 * sf)), n_ord)),
            "o_shippriority": np.zeros(n_ord, dtype=np.int32),
            "o_comment": self._comment(n_ord),
        }

        # lineitem: 1-7 lines per order
        lines_per = rng.integers(1, 8, n_ord)
        n_li = int(lines_per.sum())
        l_order = np.repeat(self.tables["orders"]["o_orderkey"], lines_per)
        l_odate = np.repeat(o_date, lines_per)
        starts = np.concatenate([[0], np.cumsum(lines_per)[:-1]])
        l_lineno = (np.arange(n_li) - np.repeat(starts, lines_per) + 1).astype(np.int32)

        l_part = rng.integers(1, n_part + 1, n_li).astype(np.int64)
        # supplier chosen among the 4 for the part (referential integrity)
        which = rng.integers(0, 4, n_li)
        l_supp = 1 + ((l_part - 1) + which * (n_supp // 4 + 1)) % n_supp
        qty = rng.integers(1, 51, n_li).astype(np.float64)
        retail = self.tables["part"]["p_retailprice"][l_part - 1]
        eprice = np.round(qty * retail, 2)
        disc = rng.integers(0, 11, n_li) / 100.0
        tax = rng.integers(0, 9, n_li) / 100.0
        ship = (l_odate + rng.integers(1, 122, n_li)).astype(np.int32)
        commit = (l_odate + rng.integers(30, 91, n_li)).astype(np.int32)
        receipt = (ship + rng.integers(1, 31, n_li)).astype(np.int32)
        cutoff = date32(1995, 6, 17)
        rflag = np.where(receipt <= cutoff,
                         np.where(rng.random(n_li) < 0.5, "R", "A"), "N").astype(object)
        lstatus = np.where(ship > cutoff, "O", "F").astype(object)
        self.tables["lineitem"] = {
            "l_orderkey": l_order,
            "l_partkey": l_part,
            "l_suppkey": l_supp,
            "l_linenumber": l_lineno,
            "l_quantity": qty,
            "l_extendedprice": eprice,
            "l_discount": disc,
            "l_tax": tax,
            "l_returnflag": rflag,
            "l_linestatus": lstatus,
            "l_shipdate": ship,
            "l_commitdate": commit,
            "l_receiptdate": receipt,
            "l_shipinstruct": self._choice(INSTRUCTS, n_li),
            "l_shipmode": self._choice(SHIPMODES, n_li),
            "l_comment": self._comment(n_li),
        }

        # back-fill order status/totalprice from lineitems
        gross = eprice * (1 - disc) * (1 + tax)
        totals = np.zeros(n_ord + 1)
        np.add.at(totals, l_order, gross)
        self.tables["orders"]["o_totalprice"] = np.round(totals[1:], 2)
        all_f = np.ones(n_ord + 1, dtype=bool)
        any_f = np.zeros(n_ord + 1, dtype=bool)
        lf = lstatus == "F"
        np.logical_and.at(all_f, l_order, lf)
        np.logical_or.at(any_f, l_order, lf)
        st = np.where(all_f[1:], "F", np.where(any_f[1:], "P", "O")).astype(object)
        self.tables["orders"]["o_orderstatus"] = st


def load_tpch(catalog, sf: float = 0.01, shards: int = 1, seed: int = 19920101,
              portion_rows: int = 1 << 20):
    """Generate TPC-H data and load it into a catalog of ColumnTables."""
    from ydb_tpu_torch.core.block import HostBlock
    from ydb_tpu_torch.storage.mvcc import WriteVersion

    data = TpchData(sf, seed)
    for tname, (schema, keys) in TPCH_SCHEMAS.items():
        small = tname in ("nation", "region")
        table = catalog.create_table(
            tname, schema, keys, shards=1 if small else shards,
            portion_rows=portion_rows)
        arrays = data.tables[tname]
        n = len(arrays[schema.names[0]])
        enc = {}
        for c in schema:
            a = arrays[c.name]
            if c.dtype.is_string:
                enc[c.name] = table.dictionaries[c.name].encode_bulk(
                    np.asarray(a, dtype=object))
            else:
                enc[c.name] = np.asarray(a, dtype=c.dtype.np)
        block = HostBlock.from_arrays(schema, enc,
                                      dictionaries=dict(table.dictionaries))
        writes = table.write(block)
        table.commit(writes, WriteVersion(1, 1))
        table.indexate()
    return data
