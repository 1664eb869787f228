"""ctypes bindings of the four CUDA kernels, each beside its plain
PyTorch version.

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
