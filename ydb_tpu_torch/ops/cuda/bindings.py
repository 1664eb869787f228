"""ctypes bindings of the CUDA kernels, each beside its plain PyTorch
version.

Every wrapper takes the plain version only for tensors that lie on the
CPU (the tests run there); for CUDA tensors it launches its kernel on
``torch.cuda.current_stream()`` or raises. Wrappers allocate every
output and scratch buffer with torch, check device, dtype, shape and
contiguity, and add one to ``LAUNCHES[name]`` per kernel launch (and
nowhere else) — the count a run reads to show that its path went
through the kernel. The C entry points return ``cudaGetLastError()``;
a non-zero code raises.

| kernel       | replaces (ydb_tpu)                                        |
|--------------|-----------------------------------------------------------|
| bucket_agg   | ops/xla_exec.py _groupby_global, _groupby_small_domain    |
| compact      | ops/xla_exec.py compress, compact_env                     |
| probe        | ops/join.py probe_lut_traced, bsearch_traced,             |
|              | _select_and_gather                                        |
| sort         | ops/sort.py _sort_impl (the lax.sort of the operands)     |
| segment_agg  | ops/xla_exec.py _trace_group_by_sorted (boundaries, group |
|              | starts, per-group folds), _groupby_medium_domain          |
| hash64       | utils/hashing.py splitmix64, hash_combine (device side)   |

What bounds each on the H100 and what its design does about it is at the
top of its source in ``csrc/``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from ydb_tpu_torch.ops.cuda import build

LAUNCHES = {name: 0 for name in build.KERNELS}

_LIBS: dict = {}
_MU = threading.Lock()

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_PI64 = ctypes.POINTER(ctypes.c_int64)
_PI32 = ctypes.POINTER(ctypes.c_int32)

_SIGS = {
    "bucket_agg": ("bucket_agg_launch",
                   [_I64, _I32, _P, _P, _I32, _PI64, _PI64, _PI32, _PI32,
                    _I64, _I32, _P, _P, _P, _P, _P, _P, _P]),
    "compact": ("compact_launch",
                [_I64, _P, _P, _I64, _P, _P, _P, _P, _P, _I32, _PI64, _PI64,
                 _PI32, _I32, _P]),
    "probe": ("probe_launch",
              [_I64, _P, _I32, _P, _P, _I32, _P, _I64, _I64, _P, _I64, _I64,
               _I64, _I32, _I32, _I32, _P, _P, _P, _I32, _PI64, _PI64, _PI64,
               _PI64, _PI32, _P]),
    "sort": ("sort_launch", [_I64, _I32, _PI64, _P, _P, _P]),
    "segment_agg": ("segment_agg_launch",
                    [_I64, _P, _I32, _PI64, _P, _I32, _PI64, _PI64, _PI32,
                     _PI32, _I64, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _P, _P, _P, _P, _I32, _P]),
    "hash64": ("hash64_launch", [_I64, _I32, _PI64, _PI32, _P, _P]),
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _fn(name: str):
    """The kernel's C entry point, building the library on first use."""
    with _MU:
        lib = _LIBS.get(name)
        if lib is None:
            path = build.build_all((name,))[name]["path"]
            lib = ctypes.CDLL(path)
            sym, argtypes = _SIGS[name]
            getattr(lib, sym).argtypes = argtypes
            getattr(lib, sym).restype = ctypes.c_int
            _LIBS[name] = lib
    return getattr(lib, _SIGS[name][0])


def _launch(name: str, *args) -> None:
    rc = _fn(name)(*args)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {rc}")
    LAUNCHES[name] += 1


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _arr(ctype, vals):
    return (ctype * max(len(vals), 1))(*vals)


def _check(t: torch.Tensor, what: str, device, n: Optional[int] = None,
           dtypes=None) -> None:
    if t.device.type != device.type or (
            device.index is not None and t.device.index != device.index):
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.dim() != 1 or (n is not None and t.shape[0] != n):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected ({n},)")
    if not t.is_contiguous():
        raise ValueError(f"{what}: not contiguous")
    if dtypes is not None and t.dtype not in dtypes:
        raise ValueError(f"{what}: dtype {t.dtype} not in {dtypes}")


# --------------------------------------------------------------------------
# bucket_agg
# --------------------------------------------------------------------------

AGG_FUNCS = {"count": 0, "sum": 1, "min": 2, "max": 3, "first": 4}
_MAX_AGGS = 16
_MAX_BUCKETS = 512               # the small-domain lane's bound
_PARTIAL_BLOCKS = 528            # fixed: the fold order is part of the result


def bucket_agg(kid: Optional[torch.Tensor], nb: int, active: torch.Tensor,
               aggs: list):
    """Per-bucket aggregation of the active rows.

    kid: int32 bucket id per row, or None for the one keyless bucket.
    active: bool per row. aggs: [(func, data, valid, unsigned)] with func
    in AGG_FUNCS; data is a float64 or int64 column (None for count and
    first); valid a bool column or None; unsigned marks int64 storage of
    uint64 values (min/max compare unsigned).

    Returns (vals, cnts, present): per aggregate a (nb,) value — float64
    for float columns, int64 otherwise; the row count for count; the
    first matching row index (n when none) for first; min/max are 0 where
    no row counted — and the (nb,) int64 count of rows that fed it, plus
    the (nb,) int64 count of active rows per bucket."""
    n = active.shape[0]
    dev = active.device
    if dev.type != "cuda":
        return bucket_agg_plain(kid, nb, active, aggs)
    _check(active, "active", dev, n, (torch.bool,))
    if kid is not None:
        _check(kid, "kid", dev, n, (torch.int32,))
    elif nb != 1:
        raise ValueError("keyless aggregation has one bucket")
    if not 1 <= nb <= _MAX_BUCKETS:
        raise ValueError(f"{nb} buckets (at most {_MAX_BUCKETS})")
    for func, data, valid, _u in aggs:
        if func not in AGG_FUNCS:
            raise ValueError(func)
        if data is not None:
            _check(data, f"{func} data", dev, n,
                   (torch.float64, torch.int64))
        elif func in ("sum", "min", "max"):
            raise ValueError(f"{func} needs data")
        if valid is not None:
            _check(valid, f"{func} valid", dev, n, (torch.bool,))
    vals, cnts, present = [], [], None
    G = max(1, min((n + 511) // 512, _PARTIAL_BLOCKS))   # 512-row tiles
    chunks = [aggs[i:i + _MAX_AGGS] for i in range(0, len(aggs), _MAX_AGGS)] \
        or [[]]
    for chunk in chunks:
        A = len(chunk)
        part_val = torch.empty(G * A * nb, dtype=torch.int64, device=dev)
        part_cnt = torch.empty(G * A * nb, dtype=torch.int64, device=dev)
        part_pres = torch.empty(G * nb, dtype=torch.int64, device=dev)
        out_val = torch.empty((A, nb), dtype=torch.int64, device=dev)
        out_cnt = torch.empty((A, nb), dtype=torch.int64, device=dev)
        out_pres = torch.empty(nb, dtype=torch.int64, device=dev)
        types = [0 if (d is not None and d.dtype == torch.float64)
                 else (2 if u else 1) for (_f, d, _v, u) in chunk]
        _launch("bucket_agg", n, nb, _ptr(kid), _ptr(active), A,
                _arr(ctypes.c_int64, [_ptr(d) or 0 for (_f, d, _v, _u)
                                      in chunk]),
                _arr(ctypes.c_int64, [_ptr(v) or 0 for (_f, _d, v, _u)
                                      in chunk]),
                _arr(ctypes.c_int32, [AGG_FUNCS[f] for (f, *_r) in chunk]),
                _arr(ctypes.c_int32, types), n, G, _ptr(part_val),
                _ptr(part_cnt), _ptr(part_pres), _ptr(out_val),
                _ptr(out_cnt), _ptr(out_pres), _stream())
        for a, (func, d, _v, _u) in enumerate(chunk):
            v = out_val[a]
            if d is not None and d.dtype == torch.float64 \
                    and func in ("sum", "min", "max"):
                v = v.view(torch.float64)
            vals.append(v)
            cnts.append(out_cnt[a])
        present = out_pres
    return vals, cnts, present


_I64_MIN = -(1 << 63)


def bucket_agg_plain(kid, nb: int, active: torch.Tensor, aggs: list):
    """Plain PyTorch version of `bucket_agg` (scatter reductions)."""
    n = active.shape[0]
    dev = active.device
    k = torch.zeros(n, dtype=torch.int64, device=dev) if kid is None \
        else kid.to(torch.int64)
    k = torch.where(active, k, torch.full_like(k, nb))   # spill bucket
    present = torch.bincount(k, minlength=nb + 1)[:nb]
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    vals, cnts = [], []
    for func, d, valid, unsigned in aggs:
        m = active if valid is None else (active & valid)
        km = torch.where(m, k, torch.full_like(k, nb))
        cnt = torch.bincount(km, minlength=nb + 1)[:nb]
        if func == "count":
            vals.append(cnt.clone())
        elif func == "sum":
            x = torch.where(m, d, torch.zeros_like(d))
            vals.append(torch.zeros(nb + 1, dtype=d.dtype, device=dev)
                        .index_add_(0, km, x)[:nb])
        elif func in ("min", "max"):
            x = d ^ _I64_MIN if unsigned else d
            red = "amin" if func == "min" else "amax"
            init = torch.zeros(nb + 1, dtype=x.dtype, device=dev)
            r = init.scatter_reduce(0, km, x, red, include_self=False)[:nb]
            if unsigned:
                r = r ^ _I64_MIN
            vals.append(torch.where(cnt > 0, r, torch.zeros_like(r)))
        elif func == "first":
            init = torch.full((nb + 1,), n, dtype=torch.int64, device=dev)
            vals.append(init.scatter_reduce(0, km, iota, "amin",
                                            include_self=True)[:nb])
        else:
            raise ValueError(func)
        cnts.append(cnt)
    return vals, cnts, present


# --------------------------------------------------------------------------
# compact
# --------------------------------------------------------------------------

_MAX_COLS = 24


def _length_tensor(length, dev) -> torch.Tensor:
    if isinstance(length, torch.Tensor):
        return length.to(device=dev, dtype=torch.int32).reshape(())
    return torch.tensor(int(length), dtype=torch.int32, device=dev)


def compact(cols: list, mask: Optional[torch.Tensor], length, n: int,
            new_cap: int):
    """Stable compaction of the rows r < length (and mask[r]) of `cols`
    (each (n,), any element width) into new_cap-row buffers.

    Returns (outs, live, new_len, overflow): the compacted columns — rows
    [0, new_len) are the active rows in order, the rest zero — and 0-d
    tensors live (int32 active count), new_len = min(live, new_cap)
    (int32) and overflow = live > new_cap (bool)."""
    dev = mask.device if mask is not None else (
        cols[0].device if cols else (length.device
                                     if isinstance(length, torch.Tensor)
                                     else torch.device("cpu")))
    if dev.type != "cuda":
        return compact_plain(cols, mask, length, n, new_cap)
    if mask is not None:
        _check(mask, "mask", dev, n, (torch.bool,))
    for i, c in enumerate(cols):
        _check(c, f"column {i}", dev, n)
        if c.element_size() not in (1, 2, 4, 8):
            raise ValueError(f"column {i}: element size {c.element_size()}")
    length_t = _length_tensor(length, dev)
    nblocks = max((n + 1023) // 1024, 1)
    block_counts = torch.empty(nblocks, dtype=torch.int32, device=dev)
    block_offsets = torch.empty(nblocks, dtype=torch.int32, device=dev)
    live = torch.empty((), dtype=torch.int32, device=dev)
    new_len = torch.empty((), dtype=torch.int32, device=dev)
    ovf = torch.empty((), dtype=torch.bool, device=dev)
    outs = [torch.zeros(new_cap, dtype=c.dtype, device=dev) for c in cols]
    chunks = [list(range(i, min(i + _MAX_COLS, len(cols))))
              for i in range(0, len(cols), _MAX_COLS)] or [[]]
    for j, chunk in enumerate(chunks):
        _launch("compact", n, _ptr(length_t), _ptr(mask), new_cap,
                _ptr(block_counts), _ptr(block_offsets), _ptr(live),
                _ptr(new_len), _ptr(ovf), len(chunk),
                _arr(ctypes.c_int64, [_ptr(cols[i]) for i in chunk]),
                _arr(ctypes.c_int64, [_ptr(outs[i]) for i in chunk]),
                _arr(ctypes.c_int32, [cols[i].element_size()
                                      for i in chunk]),
                1 if j == 0 else 0, _stream())
    return outs, live, new_len, ovf


def compact_plain(cols: list, mask, length, n: int, new_cap: int):
    """Plain PyTorch version of `compact` (nonzero + index_select)."""
    dev = mask.device if mask is not None else (
        cols[0].device if cols else torch.device("cpu"))
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    active = iota < _length_tensor(length, dev)
    if mask is not None:
        active = active & mask
    idx = torch.nonzero(active).reshape(-1)
    live = torch.tensor(idx.shape[0], dtype=torch.int32, device=dev)
    keep = idx[:new_cap]
    outs = []
    for c in cols:
        o = torch.zeros(new_cap, dtype=c.dtype, device=dev)
        o[:keep.shape[0]] = c[keep]
        outs.append(o)
    new_len = torch.clamp(live, max=new_cap)
    return outs, live, new_len, live > new_cap


# --------------------------------------------------------------------------
# probe
# --------------------------------------------------------------------------

JOIN_KINDS = {"inner": 0, "left": 1, "left_semi": 2, "left_anti": 3,
              "mark": 4}
_MAX_PAYLOADS = 16


def probe(key: torch.Tensor, kvalid: Optional[torch.Tensor],
          sel: torch.Tensor, *, lut: Optional[torch.Tensor], lut_base: int,
          keys_sorted: torch.Tensor, n_build: int, pcap: int, kind: str,
          not_in: bool, has_null: bool, payloads: list):
    """Probe `key` (int64, or float64 on the sorted-keys path) against a
    build table: the LUT when `lut` is given, else a lower_bound on the
    power-of-two padded `keys_sorted`.

    Returns (found bool, safe int32 build row id clipped to [0, pcap),
    out_sel bool, gathered [(data, valid)] — one per payload
    (src column, src valid | None), gathered at `safe`, valid = found &
    src valid)."""
    dev = key.device
    if dev.type != "cuda":
        return probe_plain(key, kvalid, sel, lut=lut, lut_base=lut_base,
                           keys_sorted=keys_sorted, n_build=n_build,
                           pcap=pcap, kind=kind, not_in=not_in,
                           has_null=has_null, payloads=payloads)
    n = key.shape[0]
    _check(key, "key", dev, n, (torch.int64, torch.float64))
    _check(sel, "sel", dev, n, (torch.bool,))
    if kvalid is not None:
        _check(kvalid, "key valid", dev, n, (torch.bool,))
    if lut is not None:
        _check(lut, "lut", dev, None, (torch.int32,))
        if key.dtype != torch.int64:
            raise TypeError("LUT probe requires an integral probe key")
    else:
        _check(keys_sorted, "keys_sorted", dev, None, (key.dtype,))
        kc = keys_sorted.shape[0]
        if kc & (kc - 1):
            raise ValueError("bsearch needs a pow2-padded build")
    for i, (src, pv) in enumerate(payloads):
        _check(src, f"payload {i}", dev, pcap)
        if pv is not None:
            _check(pv, f"payload valid {i}", dev, pcap, (torch.bool,))
    found = torch.empty(n, dtype=torch.bool, device=dev)
    safe = torch.empty(n, dtype=torch.int32, device=dev)
    out_sel = torch.empty(n, dtype=torch.bool, device=dev)
    gathered = [(torch.empty(n, dtype=src.dtype, device=dev),
                 torch.empty(n, dtype=torch.bool, device=dev))
                for (src, _pv) in payloads]
    chunks = [list(range(i, min(i + _MAX_PAYLOADS, len(payloads))))
              for i in range(0, len(payloads), _MAX_PAYLOADS)] or [[]]
    for chunk in chunks:
        _launch("probe", n, _ptr(key), int(key.dtype == torch.float64),
                _ptr(kvalid), _ptr(sel), int(lut is None), _ptr(lut),
                lut.shape[0] if lut is not None else 0, int(lut_base),
                _ptr(keys_sorted), keys_sorted.shape[0], int(n_build),
                int(pcap), JOIN_KINDS[kind], int(bool(not_in)),
                int(bool(has_null)), _ptr(found), _ptr(safe), _ptr(out_sel),
                len(chunk),
                _arr(ctypes.c_int64, [_ptr(payloads[i][0]) for i in chunk]),
                _arr(ctypes.c_int64, [_ptr(gathered[i][0]) for i in chunk]),
                _arr(ctypes.c_int64, [_ptr(payloads[i][1]) or 0
                                      for i in chunk]),
                _arr(ctypes.c_int64, [_ptr(gathered[i][1]) for i in chunk]),
                _arr(ctypes.c_int32, [payloads[i][0].element_size()
                                      for i in chunk]),
                _stream())
    return found, safe, out_sel, gathered


def probe_plain(key, kvalid, sel, *, lut, lut_base, keys_sorted, n_build,
                pcap, kind, not_in, has_null, payloads):
    """Plain PyTorch version of `probe` (the reference's arithmetic)."""
    active = sel
    v = kvalid
    matchable = active if v is None else (active & v)
    if lut is None:
        cap = keys_sorted.shape[0]
        pos = torch.zeros(key.shape, dtype=torch.int64, device=key.device)
        step = cap >> 1
        while step:
            kv = keys_sorted[pos + (step - 1)]
            pos = torch.where(kv < key, pos + step, pos)
            step >>= 1
        idx = torch.clamp(pos, 0, cap - 1)
        found = (keys_sorted[idx] == key) & matchable & (idx < n_build)
    else:
        if key.dtype.is_floating_point:
            raise TypeError("LUT probe requires an integral probe key")
        span = lut.shape[0]
        off = key - int(lut_base)
        inb = (off >= 0) & (off < span)
        idx = lut[torch.clamp(off, 0, span - 1)].to(torch.int64)
        found = inb & (idx >= 0) & matchable
    safe = torch.clamp(idx, 0, pcap - 1)
    if kind in ("inner", "left_semi"):
        out_sel = found
    elif kind == "left_anti":
        out_sel = (~found) & active
    else:
        out_sel = active
    if kind == "left_anti" and not_in:
        if v is not None:
            out_sel = out_sel & (v | (n_build == 0))
        if has_null:
            out_sel = torch.zeros_like(out_sel)
    gathered = []
    for src, pv in payloads:
        gathered.append((src[safe], found if pv is None
                         else (found & pv[safe])))
    return found, safe.to(torch.int32), out_sel, gathered


# --------------------------------------------------------------------------
# sort
# --------------------------------------------------------------------------

_MAX_KEYS = 16


def sort_perm(keys: list, n: int, device) -> torch.Tensor:
    """int32 permutation sorting rows by `keys` (int64 tensors holding
    order-preserving unsigned 64-bit keys, most significant first), the
    row id breaking ties."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return sort_perm_plain(keys, n, dev)
    if len(keys) > _MAX_KEYS:
        raise ValueError(f"{len(keys)} sort keys (at most {_MAX_KEYS})")
    for i, k in enumerate(keys):
        _check(k, f"key {i}", dev, n, (torch.int64,))
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    scratch = torch.empty(n, dtype=torch.int32, device=dev)
    _launch("sort", n, len(keys), _arr(ctypes.c_int64,
                                       [_ptr(k) for k in keys]),
            _ptr(perm), _ptr(scratch), _stream())
    return perm


def sort_perm_plain(keys: list, n: int, device) -> torch.Tensor:
    """Plain PyTorch version of `sort_perm`: stable sorts from the least
    significant key up (unsigned order by flipping the sign bit)."""
    perm = torch.arange(n, dtype=torch.int64, device=device)
    for k in reversed(keys):
        order = torch.sort((k ^ _I64_MIN)[perm], stable=True).indices
        perm = perm[order]
    return perm.to(torch.int32)


# --------------------------------------------------------------------------
# segment_agg
# --------------------------------------------------------------------------

_SEG_TILE = 1024                 # sorted rows per block (segment_agg.cu)


def segment_agg(perm: torch.Tensor, keys: list, active: torch.Tensor,
                aggs: list, oc: int):
    """Per-group aggregation of rows taken in sorted order.

    perm: int32 permutation that puts the active rows first, ordered by
    key (`sort_perm`); keys: int64 key words in original row order —
    rows whose words are all equal form one group — read through `perm`;
    active: bool per original row; aggs: as `bucket_agg`'s; oc: output
    capacity (at least the number of groups; groups past it are dropped).

    Returns (ngroups, lead, present, vals, cnts): ngroups a 0-d int32;
    per group slot (oc,): lead the original id of the group's first row
    (int32), present its active row count (int64), and per aggregate its
    value (as `bucket_agg`: `first` is the smallest original row id among
    the valid rows, n when none) and the count of rows that fed it. Slots
    past ngroups hold zeros."""
    n = perm.shape[0]
    dev = perm.device
    if dev.type != "cuda":
        return segment_agg_plain(perm, keys, active, aggs, oc)
    _check(perm, "perm", dev, n, (torch.int32,))
    _check(active, "active", dev, n, (torch.bool,))
    if not 1 <= len(keys) <= _MAX_KEYS:
        raise ValueError(f"{len(keys)} key words (1 to {_MAX_KEYS})")
    for i, k in enumerate(keys):
        _check(k, f"key {i}", dev, n, (torch.int64,))
    for func, data, valid, _u in aggs:
        if func not in AGG_FUNCS:
            raise ValueError(func)
        if data is not None:
            _check(data, f"{func} data", dev, n,
                   (torch.float64, torch.int64))
        elif func in ("sum", "min", "max"):
            raise ValueError(f"{func} needs data")
        if valid is not None:
            _check(valid, f"{func} valid", dev, n, (torch.bool,))
    T = max((n + _SEG_TILE - 1) // _SEG_TILE, 1)
    i64 = dict(dtype=torch.int64, device=dev)
    flags = torch.empty(n, dtype=torch.uint8, device=dev)
    tile_cnt = torch.empty(T, dtype=torch.int32, device=dev)
    tile_off = torch.empty(T, **i64)
    ngroups = torch.zeros((), dtype=torch.int32, device=dev)
    lead = torch.zeros(oc, dtype=torch.int32, device=dev)
    present = torch.zeros(oc, **i64)
    vals, cnts = [], []
    chunks = [aggs[i:i + _MAX_AGGS] for i in range(0, len(aggs), _MAX_AGGS)] \
        or [[]]
    for j, chunk in enumerate(chunks):
        A = len(chunk)
        out_val = torch.zeros((A, oc), **i64)
        out_cnt = torch.zeros((A, oc), **i64)
        # per-tile head and tail partials: (value, count) per aggregate,
        # and the active row count
        parts = [torch.empty(n_, **i64) for _ in ("head", "tail")
                 for n_ in (max(A, 1) * T, max(A, 1) * T, T)]
        types = [0 if (d is not None and d.dtype == torch.float64)
                 else (2 if u else 1) for (_f, d, _v, u) in chunk]
        _launch("segment_agg", n, _ptr(perm), len(keys),
                _arr(ctypes.c_int64, [_ptr(k) for k in keys]),
                _ptr(active), A,
                _arr(ctypes.c_int64, [_ptr(d) or 0 for (_f, d, _v, _u)
                                      in chunk]),
                _arr(ctypes.c_int64, [_ptr(v) or 0 for (_f, _d, v, _u)
                                      in chunk]),
                _arr(ctypes.c_int32, [AGG_FUNCS[f] for (f, *_r) in chunk]),
                _arr(ctypes.c_int32, types), oc, _ptr(flags),
                _ptr(tile_cnt), _ptr(tile_off), _ptr(ngroups), _ptr(lead),
                _ptr(out_val), _ptr(out_cnt), _ptr(present),
                *[_ptr(p) for p in parts], 1 if j == 0 else 0, _stream())
        for a, (func, d, _v, _u) in enumerate(chunk):
            v = out_val[a]
            if d is not None and d.dtype == torch.float64 \
                    and func in ("sum", "min", "max"):
                v = v.view(torch.float64)
            vals.append(v)
            cnts.append(out_cnt[a])
    return ngroups, lead, present, vals, cnts


def segment_agg_plain(perm, keys: list, active, aggs: list, oc: int):
    """Plain PyTorch version of `segment_agg`: group ids from the key
    changes along `perm` (a cumulative sum), then `bucket_agg_plain` over
    them."""
    n = perm.shape[0]
    dev = perm.device
    p = perm.to(torch.int64)
    act = active[p]
    changed = torch.ones(n, dtype=torch.bool, device=dev)
    if n:
        changed[1:] = ~act[:-1]
        for k in keys:
            ks = k[p]
            changed[1:] |= ks[1:] != ks[:-1]
    boundary = act & changed
    gid = torch.cumsum(boundary.to(torch.int64), 0) - 1
    ngroups = boundary.sum().to(torch.int32)
    live_row = act & (gid < oc)
    gid = torch.where(live_row, gid, torch.full_like(gid, oc))
    starts = torch.nonzero(boundary).reshape(-1)[:oc]
    lead = torch.zeros(oc, dtype=torch.int32, device=dev)
    lead[:starts.shape[0]] = perm[starts]
    sorted_aggs = [(f, None if d is None else d[p],
                    None if v is None else v[p], u) for (f, d, v, u) in aggs]
    vals, cnts, present = bucket_agg_plain(gid, oc, live_row, sorted_aggs)
    live = torch.arange(oc, device=dev) < ngroups
    out_vals = []
    for (f, _d, _v, _u), val in zip(aggs, vals):
        if f == "first":      # sorted position → original row id
            val = torch.where(val < n, p[torch.clamp(val, 0, max(n - 1, 0))]
                              if n else val, val)
        out_vals.append(torch.where(live, val, torch.zeros_like(val)))
    return ngroups, lead, present, out_vals, cnts


# --------------------------------------------------------------------------
# hash64
# --------------------------------------------------------------------------

_MAX_HASH_COLS = 16
_C1 = 0xBF58476D1CE4E5B9 - (1 << 64)      # int64 bit patterns
_C2 = 0x94D049BB133111EB - (1 << 64)
_GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)


def hash64(cols: list, pre: Optional[list] = None) -> torch.Tensor:
    """`hash_combine(f(c0), f(c1), ...)` over columns taken as int64
    (as the host's `x.astype(np.int64)`), folded from the left, where f is the splitmix64 finalizer for the columns `pre`
    marks (all by default) and the identity for the others. The result
    is the uint64 hash as int64 bits, equal bit for bit to
    `utils/hashing.py`'s numpy branch."""
    pre = [True] * len(cols) if pre is None else list(pre)
    cols = [c.to(torch.int64).contiguous() for c in cols]
    dev = cols[0].device
    if dev.type != "cuda":
        return hash64_plain(cols, pre)
    n = cols[0].shape[0]
    if not 1 <= len(cols) <= _MAX_HASH_COLS or len(pre) != len(cols):
        raise ValueError(f"{len(cols)} hash columns (1 to {_MAX_HASH_COLS})")
    for i, c in enumerate(cols):
        _check(c, f"column {i}", dev, n, (torch.int64,))
    out = torch.empty(n, dtype=torch.int64, device=dev)
    _launch("hash64", n, len(cols),
            _arr(ctypes.c_int64, [_ptr(c) for c in cols]),
            _arr(ctypes.c_int32, [int(bool(f)) for f in pre]), _ptr(out),
            _stream())
    return out


def _lsr(u: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's `>>` is arithmetic)."""
    return (u >> s) & ((1 << (64 - s)) - 1)


def splitmix64_plain(x: torch.Tensor) -> torch.Tensor:
    u = x.to(torch.int64)
    u = (u ^ _lsr(u, 30)) * _C1          # int64 products wrap as u64's do
    u = (u ^ _lsr(u, 27)) * _C2
    return u ^ _lsr(u, 31)


def hash_combine_plain(h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return h ^ (x + _GOLDEN + (h << 6) + _lsr(h, 2))


def hash64_plain(cols: list, pre: list) -> torch.Tensor:
    """Plain PyTorch version of `hash64`."""
    h = None
    for c, f in zip(cols, pre):
        x = splitmix64_plain(c) if f else c.to(torch.int64)
        h = x if h is None else hash_combine_plain(h, x)
    return h
