"""User-defined functions over dictionary-encoded strings.

The reference ships a 151k-LoC common UDF library (string/url/re2/
hyperscan/ip/json — `ydb/library/yql/udfs/common/`) behind a loadable
C ABI. The TPU-native seat for scalar string compute is the dictionary
LUT: a UDF evaluates ONCE per DISTINCT value on the host (vectorized
where possible), and the device gathers the result through an int32/
bool/typed LUT — URL-cardinality columns cost O(distinct), not O(rows),
and the hot path stays a single fused gather (`query/binder.py`'s
LIKE/startswith machinery generalized to arbitrary Python scalars).

Contract v1: `fn(str_or_None, *literal_args) -> result_or_None`; the
first argument is a string expression of one dictionary column, the
rest fold to literals at bind time. Returns: string (derived
dictionary), int64 / float64 (value LUT + validity LUT), bool
(predicate LUT). NULL in → NULL out unless the function handles None.

Registration: `engine.register_udf(name, fn, returns=...)`; the
standard library below installs at engine construction (regexp, case
folding, trim/pad, URL parts, JSON extraction, IP normalization — the
string/url/re2/json/ip udf seats)."""

from __future__ import annotations

import ipaddress
import json as _json
import re
from typing import Callable
from urllib.parse import urlsplit

RETURNS = ("string", "int64", "float64", "bool")


class Udf:
    __slots__ = ("name", "fn", "returns", "min_args", "max_args")

    def __init__(self, name: str, fn: Callable, returns: str,
                 min_args: int = 1, max_args: int = 8):
        if returns not in RETURNS:
            raise ValueError(f"udf returns must be one of {RETURNS}")
        self.name = name
        self.fn = fn
        self.returns = returns
        self.min_args = min_args
        self.max_args = max_args


class UdfRegistry:
    def __init__(self, with_builtins: bool = True):
        self._udfs: dict = {}
        if with_builtins:
            install_builtins(self)

    def register(self, name: str, fn: Callable, returns: str = "string",
                 min_args: int = 1, max_args: int = 8) -> None:
        self._udfs[name.lower()] = Udf(name.lower(), fn, returns,
                                       min_args, max_args)

    def get(self, name: str):
        return self._udfs.get(name.lower())

    def __contains__(self, name: str) -> bool:
        return name.lower() in self._udfs

    def names(self) -> list:
        return sorted(self._udfs)


# -- standard library -------------------------------------------------------


def _wrap_null(f):
    def g(s, *args):
        if s is None:
            return None
        return f(s, *args)
    return g


def _re_cache(pat: str):
    return re.compile(pat)


def install_builtins(reg: UdfRegistry) -> None:
    # re2/hyperscan seat
    reg.register("regexp_like",
                 _wrap_null(lambda s, p: _re_cache(p).search(s)
                            is not None), "bool", 2, 2)
    reg.register("regexp_extract", _wrap_null(
        lambda s, p, g=0: (lambda m: m.group(int(g)) if m else None)(
            _re_cache(p).search(s))), "string", 2, 3)
    reg.register("regexp_count", _wrap_null(
        lambda s, p: len(_re_cache(p).findall(s))), "int64", 2, 2)
    # string_udf seat (upper/lower/trim/ltrim/rtrim live in the binder's
    # _STR_UNARY table — the single source of truth for those five)
    reg.register("reverse", _wrap_null(lambda s: s[::-1]), "string", 1, 1)
    reg.register("lpad", _wrap_null(
        lambda s, n, c=" ": s.rjust(int(n), str(c)[:1] or " ")),
        "string", 2, 3)
    reg.register("rpad", _wrap_null(
        lambda s, n, c=" ": s.ljust(int(n), str(c)[:1] or " ")),
        "string", 2, 3)
    reg.register("split_part", _wrap_null(_split_part), "string", 3, 3)
    reg.register("find_position", _wrap_null(
        lambda s, sub: s.find(str(sub)) + 1), "int64", 2, 2)
    # url_udf seat
    reg.register("url_host", _wrap_null(
        lambda s: urlsplit(s).hostname), "string", 1, 1)
    reg.register("url_path", _wrap_null(
        lambda s: urlsplit(s).path or None), "string", 1, 1)
    reg.register("url_query", _wrap_null(
        lambda s: urlsplit(s).query or None), "string", 1, 1)
    reg.register("url_domain", _wrap_null(_cut_www), "string", 1, 1)
    # json_udf seat (json_extract('{"a":{"b":1}}', '$.a.b'))
    reg.register("json_extract", _wrap_null(_json_extract), "string", 2, 2)
    reg.register("json_extract_int", _wrap_null(
        lambda s, p: _as_int(_json_value(s, p))), "int64", 2, 2)
    reg.register("json_extract_double", _wrap_null(
        lambda s, p: _as_float(_json_value(s, p))), "float64", 2, 2)
    # ip_udf seat
    reg.register("ip_to_canonical", _wrap_null(_ip_canon), "string", 1, 1)
    reg.register("ip_is_private", _wrap_null(_ip_private), "bool", 1, 1)


def _split_part(s: str, sep, i):
    parts = s.split(str(sep))
    i = int(i)
    return parts[i - 1] if 1 <= i <= len(parts) else None


def _cut_www(s: str):
    h = urlsplit(s).hostname
    if h is None:
        return None
    return h[4:] if h.startswith("www.") else h


def _json_value(s: str, path: str):
    try:
        v = _json.loads(s)
    except (ValueError, TypeError):
        return None
    if not path.startswith("$"):
        return None
    for part in [p for p in re.split(r"\.|\[|\]", path[1:]) if p]:
        if isinstance(v, dict):
            v = v.get(part)
        elif isinstance(v, list):
            try:
                v = v[int(part)]
            except (ValueError, IndexError):
                return None
        else:
            return None
        if v is None:
            return None
    return v


def _json_extract(s: str, path: str):
    v = _json_value(s, path)
    if v is None:
        return None
    if isinstance(v, str):
        return v
    return _json.dumps(v)


def _as_int(v):
    try:
        return None if v is None else int(v)
    except (ValueError, TypeError):
        return None


def _as_float(v):
    try:
        return None if v is None else float(v)
    except (ValueError, TypeError):
        return None


def _ip_canon(s: str):
    try:
        ip = ipaddress.ip_address(s.strip())
    except ValueError:
        return None
    # IPv4-mapped addresses render dotted (`::ffff:10.0.0.1`) on every
    # Python only from 3.13 (cpython gh-87799); pin the dotted form
    v4 = getattr(ip, "ipv4_mapped", None)
    if v4 is not None:
        return f"::ffff:{v4}"
    return str(ip)


def _ip_private(s: str):
    try:
        return ipaddress.ip_address(s.strip()).is_private
    except ValueError:
        return None
