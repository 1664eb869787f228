"""Query templates for the batched serving lane: many clients sending
the same statement shape with their own literals.

Each template is a query of the repo's suites (its text is the
validation instance, whose answer the oracles know) and a rule that
draws new substitution parameters from a seeded generator. TPC-H
parameters follow the TPC-H specification's qgen rules (clause 2.4,
revision 3.0.1): Q1 DELTA in [60, 120] days; Q3 SEGMENT one of the five
segments and DATE a day of March 1995; Q6 DATE the first of January of
1993–1997, DISCOUNT in [0.02, 0.09] and QUANTITY in [24, 25]; Q12
SHIPMODE1/2 two different modes and DATE the first of January of
1993–1997; Q14 DATE the first of a month of 1993–1997; Q19 BRAND1/2
Brand#MN with M, N in [1, 5] and QUANTITY1 in [1, 10]. The ClickBench
dashboard queries (c36, c37, c40, c42) vary the counter (CounterID, one
of the 100 busiest under the generator's Zipf law) and the EventDate
window inside the generated month. `point_variants` draws order keys
for the point lookup over `orders`.

`variants(name, n, seed)` returns n distinct texts: the validation
text first, then n - 1 draws."""

from __future__ import annotations

import datetime

import numpy as np

from ydb_tpu_torch.bench import clickbench_oracle, tpch_oracle

POINT_SQL = ("select o_orderkey, o_totalprice, o_orderdate from orders "
             "where o_orderkey = {key}")

_SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY",
             "HOUSEHOLD")
_MODES = ("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB")


def _date(d: datetime.date) -> str:
    return f"date '{d.isoformat()}'"


def _q1(rng):
    return {"interval '90' day": f"interval '{rng.integers(60, 121)}' day"}


def _q3(rng):
    day = datetime.date(1995, 3, 1) + datetime.timedelta(
        days=int(rng.integers(0, 31)))
    return {"'BUILDING'": f"'{_SEGMENTS[rng.integers(0, 5)]}'",
            "date '1995-03-15'": _date(day)}


def _q6(rng):
    d = int(rng.integers(2, 10))
    return {"date '1994-01-01'":
            _date(datetime.date(int(rng.integers(1993, 1998)), 1, 1)),
            "between 0.05 and 0.07":
            f"between 0.0{d - 1} and {(d + 1) / 100:.2f}",
            "l_quantity < 24": f"l_quantity < {rng.integers(24, 26)}"}


def _q12(rng):
    m1, m2 = rng.choice(len(_MODES), 2, replace=False)
    return {"('MAIL', 'SHIP')": f"('{_MODES[m1]}', '{_MODES[m2]}')",
            "date '1994-01-01'":
            _date(datetime.date(int(rng.integers(1993, 1998)), 1, 1))}


def _q14(rng):
    m = int(rng.integers(0, 60))
    return {"date '1995-09-01'":
            _date(datetime.date(1993 + m // 12, m % 12 + 1, 1))}


def _brand(rng) -> str:
    return f"'Brand#{rng.integers(1, 6)}{rng.integers(1, 6)}'"


def _q19(rng):
    q = int(rng.integers(1, 11))
    return {"'Brand#12'": _brand(rng), "'Brand#23'": _brand(rng),
            "l_quantity >= 1 and l_quantity <= 11":
            f"l_quantity >= {q} and l_quantity <= {q + 10}"}


_DAY0 = datetime.date(2023, 6, 22)       # the generated month's first day


def _window(rng, short: bool):
    if short:                              # c42: a three-day window
        lo = int(rng.integers(0, 29))
        hi = lo + 2
        old = "EventDate >= date '2023-06-22' and EventDate <= " \
              "date '2023-06-24'"
    else:
        lo = int(rng.integers(0, 16))
        hi = min(lo + int(rng.integers(7, 31)), 30)
        old = "EventDate >= date '2023-06-22' and EventDate <= " \
              "date '2023-07-22'"
    new = (f"EventDate >= {_date(_DAY0 + datetime.timedelta(days=lo))} "
           f"and EventDate <= {_date(_DAY0 + datetime.timedelta(days=hi))}")
    return {"CounterID = 62": f"CounterID = {rng.integers(1, 101)}",
            old: new}


TEMPLATES = {
    "q1": (tpch_oracle.QUERIES["q1"], _q1),
    "q3": (tpch_oracle.QUERIES["q3"], _q3),
    "q6": (tpch_oracle.QUERIES["q6"], _q6),
    "q12": (tpch_oracle.QUERIES["q12"], _q12),
    "q14": (tpch_oracle.QUERIES["q14"], _q14),
    "q19": (tpch_oracle.QUERIES["q19"], _q19),
    "c36": (clickbench_oracle.QUERIES["c36"], lambda r: _window(r, False)),
    "c37": (clickbench_oracle.QUERIES["c37"], lambda r: _window(r, False)),
    "c40": (clickbench_oracle.QUERIES["c40"], lambda r: _window(r, False)),
    "c42": (clickbench_oracle.QUERIES["c42"], lambda r: _window(r, True)),
}


def substitute(text: str, subs: dict) -> str:
    for old, new in subs.items():
        if old not in text:
            raise KeyError(f"template literal {old!r} not in the query")
        text = text.replace(old, new)
    return text


def variants(name: str, n: int, seed: int) -> list:
    """n distinct texts of template `name`: the validation text, then
    draws of its parameters (a draw that repeats an earlier text is
    drawn again)."""
    text, draw = TEMPLATES[name]
    rng = np.random.default_rng([seed, sorted(TEMPLATES).index(name)])
    out = [text]
    for _ in range(100 * n):
        if len(out) == n:
            return out
        t = substitute(text, draw(rng))
        if t not in out:
            out.append(t)
    raise ValueError(f"{name}: fewer than {n} distinct parameter sets")


def point_variants(keys: np.ndarray, n: int, seed: int) -> list:
    """n point lookups of `orders` at order keys drawn from `keys`."""
    rng = np.random.default_rng([seed, 1 << 20])
    return [POINT_SQL.format(key=int(k))
            for k in rng.choice(np.asarray(keys), n, replace=False)]
