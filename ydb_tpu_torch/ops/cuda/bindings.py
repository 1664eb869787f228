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
| bucket_agg   | ops/xla_exec.py _groupby_small_domain                     |
| bucket_agg_keyless | ops/xla_exec.py _groupby_global                     |
| compact      | ops/xla_exec.py compress, compact_env                     |
| probe        | ops/join.py probe_lut_traced, bsearch_traced,             |
|              | _select_and_gather                                        |
| sort         | ops/sort.py _sort_impl (the lax.sort of the operands)     |
| bucket_perm  | the order ops/xla_exec.py _groupby_medium_domain folds in |
|              | (it scatter-reduces; the port sorts by bucket id, then    |
|              | segment_agg folds each run)                               |
| segment_agg  | ops/xla_exec.py _trace_group_by_sorted (boundaries, group |
|              | starts, per-group folds), _groupby_medium_domain          |
| hash64       | utils/hashing.py splitmix64, hash_combine (device side)   |
| window_scan  | ops/window_dev.py _build_window_fn (boundaries, segment   |
|              | starts and ends, prefix sums, running min/max)            |
| expand_counts| ops/join.py _expand_counts                                |
| expand_gather| ops/join.py _expand_gather                                |
| partition    | ops/spill.py _partition_sort (ids, counts, the sort and   |
|              | gathers); query/executor.py _partition_block (routing)    |
| segments     | parallel/collective.py bucket_of, bucket_segments (the    |
|              | send segments of a mesh exchange)                         |
| quantize_blocked, dequantize_blocked                                     |
|              | parallel/collective.py quantize_blocked,                  |
|              | dequantize_blocked (the DQ plane's int8 block codec)      |
| dq_bucket_plane, dq_counts                                               |
|              | dq/ici.py's bucket plane and _build_counts_fn,            |
|              | _build_counts_batched_fn (the DQ count exchange)          |
| *_batched    | the member axis of bucket_agg, segment_agg and compact:   |
|              | what ops/fused.py build_fused_batched_fn's vmap gives     |
|              | them in the reference (bucket_agg_keyless_batched: the    |
|              | keyless members' streaming body)                          |

Each launch name builds from ``csrc/<library>.cu`` (``bucket_agg``,
``bucket_agg_keyless`` and the two member entries share
``bucket_agg.cu``; ``bucket_agg`` and ``bucket_agg_batched`` are one C
entry, the single query its one member, ``expand_counts``
and ``expand_gather`` share ``expand.cu``, the two codec entries
``quant.cu``, the bucket plane and the counts ``dq_counts.cu``;
``bucket_perm`` is ``bucket_sort.cu``; each ``*_batched`` entry is in
its kernel's source).

Member axis (the batched serving lane): B same-shape queries run as one.
An input of a ``*_batched`` wrapper is either shared, shape (n,), or per
member, shape (B, n) with contiguous rows; its member stride goes to the
kernel (0 when shared), so a shared column is never copied B times.
Outputs carry the member axis first.

What bounds each on the H100 and what its design does about it is at the
top of its source in ``csrc/``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from ydb_tpu_torch.ops.cuda import build

_LIBS: dict = {}
_MU = threading.Lock()

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_PI64 = ctypes.POINTER(ctypes.c_int64)
_PI32 = ctypes.POINTER(ctypes.c_int32)

# compact.cu's one entry, for the single query (B = 1) and the members
_COMPACT_ARGS = [_I64, _I32, _P, _I32, _I64, _P, _I64, _I64, _P, _I64, _P,
                 _P, _P, _I32, _PI64, _PI64, _PI64, _PI32, _I32, _P]

# bucket_agg.cu's keyed entry, for the single query (B = 1) and members
_MEMBERS_ARGS = [_I64, _I32, _P, _I64, _I32, _P, _I64, _I32, _PI64, _PI64,
                 _PI64, _PI64, _PI32, _PI32, _I64, _PI32, _P, _P, _P, _P,
                 _P, _P]

# launch name -> (library, C symbol, argtypes)
_SIGS = {
    "bucket_agg": ("bucket_agg", "bucket_agg_members_launch", _MEMBERS_ARGS),
    "bucket_agg_keyless": ("bucket_agg", "bucket_agg_keyless_launch",
                           [_I64, _P, _I32, _PI64, _PI64, _PI32, _PI32,
                            _I64, _I32, _I32, _P, _P, _P, _P, _P, _P, _P,
                            _P]),
    "compact": ("compact", "compact_launch", _COMPACT_ARGS),
    "probe": ("probe", "probe_launch",
              [_I64, _P, _I32, _P, _P, _I32, _P, _I64, _I64, _P, _I64, _I64,
               _I64, _I32, _I32, _I32, _P, _P, _P, _I32, _PI64, _PI64, _PI64,
               _PI64, _PI32, _P, _P, _I64, _I32]),
    "sort": ("sort", "sort_launch",
             [_I64, _I32, _PI64, _I32, _P, _P, _P, _P, _I64, _P]),
    "segment_agg": ("segment_agg", "segment_agg_launch",
                    [_I64, _P, _I32, _PI64, _P, _I32, _PI64, _PI64, _PI32,
                     _PI32, _I64, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _P, _P, _P, _P, _I32, _P]),
    "hash64": ("hash64", "hash64_launch", [_I64, _I32, _PI64, _PI32, _P, _P]),
    "bucket_perm": ("bucket_sort", "bucket_perm_launch",
                    [_I64, _P, _I64, _P, _I32, _I32, _P, _P, _P, _P, _P, _P,
                     _P, _P, _P]),
    "window_scan": ("window_scan", "window_scan_launch",
                    [_I64, _P, _I32, _I32, _PI64, _I32, _PI32, _PI32, _PI32,
                     _PI64, _PI64, _PI64, _I64, _P, _I32, _I32, _P, _P, _P]),
    "expand_counts": ("expand", "expand_counts_launch",
                      [_I64, _P, _I32, _P, _P, _P, _I64, _I64, _I32, _P, _P,
                       _P, _P, _P, _P, _P, _I64, _I32, _P]),
    "expand_gather": ("expand", "expand_gather_launch",
                      [_I64, _I64, _P, _P, _P, _P, _I64, _I32, _PI64, _PI64,
                       _PI32, _PI32, _P]),
    "partition": ("partition", "partition_launch",
                  [_I64, _P, _P, _I32, _P, _P, _P, _I64, _I32, _I32, _I64,
                   _I32, _PI64, _PI64, _PI32, _P]),
    "bucket_agg_batched": ("bucket_agg", "bucket_agg_members_launch",
                           _MEMBERS_ARGS),
    "bucket_agg_keyless_batched": ("bucket_agg",
                                   "bucket_agg_keyless_batched_launch",
                                   [_I64, _I32, _P, _I64, _I32, _PI64, _PI32,
                                    _PI32, _I32, _I32, _P, _P, _P, _P, _P,
                                    _P, _P, _P]),
    "segment_agg_batched": ("segment_agg", "segment_agg_batched_launch",
                            [_I64, _P, _I32, _PI64, _P, _I32, _P, _I64,
                             _I32, _PI64, _PI64, _PI64, _PI64, _PI32, _PI32,
                             _I64, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _P, _P, _P, _P, _I32, _I32, _P, _P, _P, _PI64,
                             _PI64, _P]),
    "segments": ("segments", "segments_launch",
                 [_I64, _I32, _PI64, _PI64, _PI32, _P, _P, _P, _I64, _I32,
                  _I32, _P, _I64, _I64, _P, _P, _I32, _PI64, _PI64, _PI32,
                  _I32, _P]),
    "compact_batched": ("compact", "compact_launch", _COMPACT_ARGS),
    "quantize_blocked": ("quant", "quantize_blocked_launch",
                         [_I64, _I32, _P, _P, _P, _P]),
    "dequantize_blocked": ("quant", "dequantize_blocked_launch",
                           [_I64, _I32, _P, _P, _P, _P]),
    "dq_bucket_plane": ("dq_counts", "dq_bucket_plane_launch",
                        [_I64, _I32, _I32, _P, _P, _P, _P, _I32, _I32, _P,
                         _P]),
    "dq_counts": ("dq_counts", "dq_counts_ticket_launch",
                  [_I64, _I32, _I32, _I32, _I32, _P, _P, _P, _P, _P]),
}

# "k1": the generated expression-stage kernels (ops/k1.py, launched by
# ops/cuda/nvrtc.py); "k1_batched": those that loop over a batch's
# members
LAUNCHES = {name: 0 for name in (*_SIGS, "k1", "k1_batched")}
# the DQ runner launches from one thread per worker engine at once: a
# count is read, added to and stored under this lock
_COUNT_MU = threading.Lock()


def reset_launches() -> None:
    with _COUNT_MU:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def count_launch(name: str) -> None:
    with _COUNT_MU:
        LAUNCHES[name] += 1


def _fn(name: str):
    """The kernel's C entry point, building its library on first use.
    A library that cannot be built or loaded raises RuntimeError, not
    the OSError beneath it, which a caller could take for a lost
    connection."""
    libname, sym, argtypes = _SIGS[name]
    with _MU:
        lib = _LIBS.get(libname)
        if lib is None:
            try:
                path = build.build_all((libname,))[libname]["path"]
                lib = _LIBS[libname] = ctypes.CDLL(path)
            except OSError as e:
                raise RuntimeError(
                    f"CUDA kernel library {libname} failed to build or "
                    f"load: {e}") from e
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _launch(name: str, *args) -> None:
    rc = _fn(name)(*args)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {rc}")
    count_launch(name)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _arr(ctype, vals):
    return (ctype * max(len(vals), 1))(*vals)


def _member_stride(t: torch.Tensor, what: str, device, B: int, n: int,
                   dtypes=None) -> int:
    """Check a member-axis input — shared (n,) or per member (B, n) with
    contiguous rows — and return its member stride in elements (0 when
    shared)."""
    if t.dim() == 1:
        _check(t, what, device, n, dtypes)
        return 0
    if t.device.type != device.type or (
            device.index is not None and t.device.index != device.index):
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.dim() != 2 or tuple(t.shape) != (B, n) or (n > 1
                                                    and t.stride(1) != 1):
        raise ValueError(f"{what}: shape {tuple(t.shape)} strides "
                         f"{t.stride()}, expected ({n},) or ({B}, {n}) "
                         "with contiguous rows")
    if dtypes is not None and t.dtype not in dtypes:
        raise ValueError(f"{what}: dtype {t.dtype} not in {dtypes}")
    return t.stride(0)


def _per_member(t: Optional[torch.Tensor], B: int) -> Optional[torch.Tensor]:
    """A member-axis input as (B, n) (a shared one expanded, not copied)
    — the plain versions' view."""
    if t is None or t.dim() == 2:
        return t
    return t.unsqueeze(0).expand(B, t.shape[0])


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
_PARTIAL_BLOCKS = 528            # keyless_fold's most blocks (K2); the
                                 # keyed bodies' partials follow the grid
                                 # of bucket_agg_plan, a function of the
                                 # shape alone


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
    the (nb,) int64 count of active rows per bucket. Keyless calls launch
    ``bucket_agg_keyless`` (K2), keyed ones ``bucket_agg`` (K3)."""
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
    if kid is None:
        return _bucket_agg_keyless(n, active, aggs, dev)
    vals, cnts, present = _bucket_agg_members(
        "bucket_agg", kid, 0, nb, active.unsqueeze(0), 0, n,
        [(f, d, v, u, 0, 0) for (f, d, v, u) in aggs], dev)
    return ([v.select(0, 0) for v in vals], [c.select(0, 0) for c in cnts],
            present.select(0, 0))


def _agg_types(chunk) -> list:
    """The kernels' value type per aggregate spec: 0 float64, 1 int64,
    2 uint64 (int64 storage of unsigned values)."""
    return [0 if (d is not None and d.dtype == torch.float64)
            else (2 if u else 1) for (_f, d, _v, u, *_r) in chunk]


_KL_GRID = 264                   # bucket_agg.cu KL_GRID: 2 blocks a SM
_KL_MAX_SUMS = 4                 # bucket_agg.cu KL_MAX_SUMS
_KL_WARPS = 8                    # bucket_agg.cu WARPS


def keyless_plan(n: int, aggs: list, aligned: bool) -> dict:
    """What `bucket_agg` launches for one keyless chunk, from the shapes
    alone: `aggs` [(func, has data, has valid)], `aligned` that the mask
    is 2-byte and every data column 16-byte aligned. One launch either
    way: "stream" (the common spec: counts and at most four sums, none
    with a validity) with `J` 16-byte loads a sum a lane a step, over
    `grid` blocks of the fixed persistent grid; else "fold" over up to
    528 blocks of 512 rows. `grid` blocks write `grid` partials."""
    sums = [f for (f, has_data, _v) in aggs if f == "sum"]
    common = aligned and len(sums) <= _KL_MAX_SUMS and all(
        not has_valid and ((f == "count" and not has_data)
                           or (f == "sum" and has_data))
        for (f, has_data, has_valid) in aggs)
    if common:
        J = 8 if len(sums) <= 2 else 4
        step = _KL_WARPS * 64 * J
        return {"path": "stream", "J": J,
                "grid": max(1, min(-(-n // step), _KL_GRID)), "launches": 1}
    return {"path": "fold", "J": 0,
            "grid": max(1, min(-(-n // 512), _PARTIAL_BLOCKS)), "launches": 1}


_TICKETS: dict = {}              # (device type, index, stream) -> int32
_TICKET_MU = threading.Lock()


def _ticket(dev, words: int = 1) -> torch.Tensor:
    """At least `words` zeroed int32 words per stream: kernels' ticket
    counters, which the last block of each launch resets to zero for the
    next launch (`_ticket_launch` drops them when a launch fails)."""
    key = (dev.type, dev.index, _stream())
    with _TICKET_MU:
        t = _TICKETS.get(key)
        if t is None or t.numel() < words:
            t = _TICKETS[key] = torch.zeros(words, dtype=torch.int32,
                                            device=dev)
    return t


def _ticket_launch(name: str, dev, *args) -> None:
    """`_launch` of a kernel that draws `_ticket` words: a launch that
    failed may have left words drawn, so the stream's words are dropped
    and made anew by the next call."""
    try:
        _launch(name, *args)
    except BaseException:
        with _TICKET_MU:
            _TICKETS.pop((dev.type, dev.index, _stream()), None)
        raise


def _bucket_agg_keyless(n: int, active: torch.Tensor, aggs: list, dev):
    """K2: keyless `bucket_agg` on the card, one launch per chunk of
    _MAX_AGGS aggregates (`keyless_plan`)."""
    vals, cnts, present = [], [], None
    chunks = [aggs[i:i + _MAX_AGGS] for i in range(0, len(aggs), _MAX_AGGS)] \
        or [[]]
    i64 = dict(dtype=torch.int64, device=dev)
    for chunk in chunks:
        A = len(chunk)
        aligned = _ptr(active) % 2 == 0 and all(
            _ptr(d) % 16 == 0 for (_f, d, _v, _u) in chunk if d is not None)
        plan = keyless_plan(n, [(f, d is not None, v is not None)
                                for (f, d, v, _u) in chunk], aligned)
        G = plan["grid"]
        part_val = torch.empty(G * A, **i64)
        part_cnt = torch.empty(G * A, **i64)
        part_pres = torch.empty(G, **i64)
        out_val = torch.empty((A, 1), **i64)
        out_cnt = torch.empty((A, 1), **i64)
        out_pres = torch.empty(1, **i64)
        _ticket_launch(
            "bucket_agg_keyless", dev, n, _ptr(active), A,
            _arr(ctypes.c_int64, [_ptr(d) or 0 for (_f, d, _v, _u)
                                  in chunk]),
            _arr(ctypes.c_int64, [_ptr(v) or 0 for (_f, _d, v, _u)
                                  in chunk]),
            _arr(ctypes.c_int32, [AGG_FUNCS[f] for (f, *_r) in chunk]),
            _arr(ctypes.c_int32, _agg_types(chunk)), n, plan["J"], G,
            _ptr(part_val), _ptr(part_cnt), _ptr(part_pres),
            _ptr(_ticket(dev)), _ptr(out_val), _ptr(out_cnt),
            _ptr(out_pres), _stream())
        for a, (func, d, _v, _u) in enumerate(chunk):
            v = out_val.select(0, a)
            if d is not None and d.dtype == torch.float64 \
                    and func in ("sum", "min", "max"):
                v = v.view(torch.float64)
            vals.append(v)
            cnts.append(out_cnt.select(0, a))
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


_KT_TILE = 1024                  # bucket_agg.cu KT_TILE: rows a tile
_KT_TILE_BYTES = 7 * _KT_TILE    # bucket_agg.cu KT_TILE_BYTES
_KT_MAX_SMEM = 114_688           # bucket_agg.cu KT_MAX_SMEM: 2 blocks a SM
_KT_SLOT_BYTES = 12              # a slot's value and count a bucket
_KT_BLOCKS_PER_SM = 3            # bucket_agg_members' __launch_bounds__
_SM_SMEM = 233_472               # the H100's shared memory a SM
_SM_BLOCK_EXTRA = 2048           # a block's static shared memory and the
                                 # 1 KB the card reserves for it
_SMS = 132                       # the H100's SMs
_KT_FINAL_LANES = 2048           # slots x buckets of a member at most for
                                 # the warp-per-output final pass
_KM_GRID = 264                   # keyless_members: 2 blocks a SM


def bucket_agg_plan(n: int, nb: int, n_aggs: int, B: int = 1,
                    shared_ids: bool = True) -> dict:
    """What `bucket_agg` (B = 1) and `bucket_agg_batched` launch for one
    chunk through the keyed body (bucket_agg.cu `bucket_agg_members`, then
    its final pass), from the shapes alone: `n_aggs` distinct aggregates
    (`fold_slots`), each member's slots those and its row count.

    P (copies of the accumulators, one per partition of a tile's chunks)
    and F (tile groups, the grid's y: block f folds the tiles f, f + F,
    ...) fix the fold order. They follow n, nb and n_aggs, never B, so a
    batch's member b folds as a single query over its mask does, and
    they fill the card at the single query's footprint. Y block rows of
    SR slots: with shared ids every member's slots in aggregate-major
    order, as many a row as its shared memory takes; with per-member ids
    `rpm` rows a member. The F partials of every slot and bucket are
    folded in order by a second kernel: a warp an output ("lanes") where
    a member has few, else a thread an output with coalesced reads."""
    S1 = n_aggs + 1
    slot = nb * _KT_SLOT_BYTES
    P = next((p for p in (4, 2)
              if p * S1 * slot + _KT_TILE_BYTES <= _KT_MAX_SMEM), 1)
    most = max(1, (_KT_MAX_SMEM - _KT_TILE_BYTES) // (P * slot))
    single = P * min(most, S1) * slot + _KT_TILE_BYTES
    per_sm = max(1, min(_KT_BLOCKS_PER_SM,
                        _SM_SMEM // (single + _SM_BLOCK_EXTRA)))
    F = max(1, min(-(-n // _KT_TILE), _SMS * per_sm))
    if shared_ids:
        SR = min(most, S1 * B)
        rpm, Y = 0, -(-(S1 * B) // SR)
    else:
        SR = min(most, S1)
        rpm = -(-S1 // SR)
        Y = B * rpm
    return {"F": F, "Y": Y, "P": P, "SR": SR, "rpm": rpm,
            "final": "lanes" if S1 * nb <= _KT_FINAL_LANES else "threads",
            "smem": P * SR * slot + _KT_TILE_BYTES,
            "partial_bytes": F * S1 * B * nb * _KT_SLOT_BYTES,
            "launches": 1}


def keyless_members_plan(n: int, B: int, aggs: list, aligned: bool) -> dict:
    """What `bucket_agg_batched` launches for one keyless chunk, from the
    shapes alone: `aggs` [(func, has data, has valid, shared)], `aligned`
    that every mask row is 2-byte and every data column 16-byte aligned.
    "stream" (`keyless_members`, one launch with the ticket finish) for
    counts and at most four sums, none with a validity, over shared
    columns: `members` a block row (8 up to two sums, else 4), `rows`
    block rows, `grid` blocks a row, `J` 16-byte loads a sum a lane a
    step; else the keyed body with one bucket ("keyed", its plan)."""
    sums = [f for (f, _d, _v, _s) in aggs if f == "sum"]
    if aligned and len(sums) <= _KL_MAX_SUMS and all(
            not has_valid and ((f == "count" and not has_data)
                               or (f == "sum" and has_data and shared))
            for (f, has_data, has_valid, shared) in aggs):
        D = len(sums)
        MB = 8 if D <= 2 else 4
        J = 4 if D <= 1 else 2
        step = _KL_WARPS * 64 * J
        return {"path": "stream", "members": MB, "J": J,
                "rows": -(-B // MB),
                "grid": max(1, min(-(-n // step), _KM_GRID)), "launches": 1}
    return {"path": "keyed", **bucket_agg_plan(n, 1, len(aggs), B)}


def fold_slots(specs: list) -> tuple:
    """The aggregates a keyed launch folds, and where each result of
    `specs` [(func, data, valid, unsigned, data stride, valid stride)]
    comes from: a count with no validity is the row count (slot -1), and
    aggregates of the same function and type over the same data and
    validity tensors (the same objects, strides included) fold once.
    Returns (indices into `specs` of the distinct ones, slot per spec)."""
    keys, distinct, slots = {}, [], []
    types = _agg_types(specs)
    for i, (f, d, v, _u, ds, vs) in enumerate(specs):
        if f == "count" and v is None:
            slots.append(-1)
            continue
        key = (f, types[i], id(d) if f in ("sum", "min", "max") else None,
               ds, id(v), vs)
        if key not in keys:
            keys[key] = len(distinct)
            distinct.append(i)
        slots.append(keys[key])
    return distinct, slots


def bucket_agg_batched(kid: Optional[torch.Tensor], nb: int,
                       masks: torch.Tensor, aggs: list):
    """`bucket_agg` for B members at once (the batched serving lane).

    masks: bool (B, n), member b's active rows. kid: None (keyless), or
    int32 bucket ids shared (n,) or per member (B, n). aggs: as
    `bucket_agg`'s, each data and valid shared (n,) or per member (B, n).

    Returns (vals, cnts, present) as `bucket_agg`'s with a leading member
    axis: per aggregate a (B, nb) value and (B, nb) count, and the (B, nb)
    active-row counts. Member b's results equal `bucket_agg` over its
    rows; with keys, its float sums equal that call's bit for bit
    (keyless members fold in an order of their own)."""
    B, n = masks.shape
    dev = masks.device
    if dev.type != "cuda":
        return bucket_agg_batched_plain(kid, nb, masks, aggs)
    ms = _member_stride(masks, "masks", dev, B, n, (torch.bool,))
    if ms == 0:
        raise ValueError("masks: one row per member")
    ks = 0
    if kid is not None:
        ks = _member_stride(kid, "kid", dev, B, n, (torch.int32,))
    elif nb != 1:
        raise ValueError("keyless aggregation has one bucket")
    if not 1 <= nb <= _MAX_BUCKETS:
        raise ValueError(f"{nb} buckets (at most {_MAX_BUCKETS})")
    specs = []
    for func, data, valid, u in aggs:
        if func not in AGG_FUNCS:
            raise ValueError(func)
        ds = vs = 0
        if data is not None:
            ds = _member_stride(data, f"{func} data", dev, B, n,
                                (torch.float64, torch.int64))
        elif func in ("sum", "min", "max"):
            raise ValueError(f"{func} needs data")
        if valid is not None:
            vs = _member_stride(valid, f"{func} valid", dev, B, n,
                                (torch.bool,))
        specs.append((func, data, valid, u, ds, vs))
    if kid is None:
        return _keyless_members(n, B, masks, ms, specs, dev)
    return _bucket_agg_members("bucket_agg_batched", kid, ks, nb, masks, ms,
                               n, specs, dev)


def _outputs(specs: list, slots: list, out_val, out_cnt):
    """Per aggregate its value (a float64 view for float sums, min and
    max) and count from its slot of the (B, slots, nb) outputs."""
    vals, cnts = [], []
    for (func, d, *_r), j in zip(specs, slots):
        v = out_val.select(1, j)
        if d is not None and d.dtype == torch.float64 \
                and func in ("sum", "min", "max"):
            v = v.view(torch.float64)
        vals.append(v)
        cnts.append(out_cnt.select(1, j))
    return vals, cnts


def _bucket_agg_members(name: str, kid, ks: int, nb: int, masks, ms: int,
                        n: int, specs: list, dev):
    """The keyed launches of `bucket_agg` (B = 1) and `bucket_agg_batched`
    (and of keyless members off the streaming body), counted under
    `name`: one a chunk of _MAX_AGGS distinct aggregates (`fold_slots`).
    `masks` (B, n) rows `ms` apart; `specs` checked, with member
    strides."""
    B = masks.shape[0]
    distinct, slots = fold_slots(specs)
    chunks = [distinct[i:i + _MAX_AGGS]
              for i in range(0, len(distinct), _MAX_AGGS)] or [[]]
    i64 = dict(dtype=torch.int64, device=dev)
    vals, cnts = [None] * len(specs), [None] * len(specs)
    present = None
    for c0, chunk in zip(range(0, len(distinct) or 1, _MAX_AGGS), chunks):
        A = len(chunk)
        sub = [specs[i] for i in chunk]
        plan = bucket_agg_plan(n, nb, A, B, shared_ids=ks == 0)
        part = plan["F"] * (A + 1) * B * nb
        part_val = torch.empty(part, **i64)
        part_cnt = torch.empty(part, dtype=torch.int32, device=dev)
        out_val = torch.empty((B, A, nb), **i64)
        out_cnt = torch.empty((B, A, nb), **i64)
        out_pres = torch.empty((B, nb), **i64)
        _launch(name, n, nb, _ptr(kid), ks, B, _ptr(masks), ms, A,
                _arr(ctypes.c_int64, [_ptr(c[1]) or 0 for c in sub]),
                _arr(ctypes.c_int64, [c[4] for c in sub]),
                _arr(ctypes.c_int64, [_ptr(c[2]) or 0 for c in sub]),
                _arr(ctypes.c_int64, [c[5] for c in sub]),
                _arr(ctypes.c_int32, [AGG_FUNCS[c[0]] for c in sub]),
                _arr(ctypes.c_int32, _agg_types(sub)), n,
                _arr(ctypes.c_int32, [plan["F"], plan["Y"], plan["P"],
                                      plan["SR"], plan["rpm"],
                                      int(plan["final"] == "lanes")]),
                _ptr(part_val), _ptr(part_cnt), _ptr(out_val),
                _ptr(out_cnt), _ptr(out_pres), _stream())
        present = out_pres
        mine = [(i, j - c0) for i, j in enumerate(slots)
                if c0 <= j < c0 + A]
        v, c = _outputs([specs[i] for i, _j in mine], [j for _i, j in mine],
                        out_val, out_cnt)
        for (i, _j), vi, ci in zip(mine, v, c):
            vals[i], cnts[i] = vi, ci
    for i, j in enumerate(slots):
        if j < 0:
            vals[i] = cnts[i] = present
    return vals, cnts, present


def _keyless_members(n: int, B: int, masks, ms: int, specs: list, dev):
    """Keyless members: one launch a chunk of _MAX_AGGS aggregates, the
    streaming body (`bucket_agg_keyless_batched`) where
    `keyless_members_plan` takes it, else the keyed body with one
    bucket."""
    aligned = _ptr(masks) % 2 == 0 and ms % 2 == 0 and all(
        _ptr(c[1]) % 16 == 0 for c in specs if c[1] is not None)
    plan = keyless_members_plan(
        n, B, [(c[0], c[1] is not None, c[2] is not None, c[4] == 0)
               for c in specs], aligned)
    if plan["path"] != "stream" or len(specs) > _MAX_AGGS:
        return _bucket_agg_members("bucket_agg_batched", None, 0, 1, masks,
                                   ms, n, specs, dev)
    i64 = dict(dtype=torch.int64, device=dev)
    A, G = len(specs), plan["grid"]
    part_val = torch.empty(G * B * A, **i64)
    part_cnt = torch.empty(G * B * A, **i64)
    part_pres = torch.empty(G * B, **i64)
    out_val = torch.empty((B, A, 1), **i64)
    out_cnt = torch.empty((B, A, 1), **i64)
    out_pres = torch.empty((B, 1), **i64)
    _ticket_launch(
        "bucket_agg_keyless_batched", dev, n, B, _ptr(masks), ms, A,
        _arr(ctypes.c_int64, [_ptr(c[1]) or 0 for c in specs]),
        _arr(ctypes.c_int32, [AGG_FUNCS[c[0]] for c in specs]),
        _arr(ctypes.c_int32, _agg_types(specs)), G, plan["rows"],
        _ptr(part_val), _ptr(part_cnt), _ptr(part_pres),
        _ptr(_ticket(dev)), _ptr(out_val), _ptr(out_cnt), _ptr(out_pres),
        _stream())
    vals, cnts = _outputs(specs, list(range(A)), out_val, out_cnt)
    return vals, cnts, out_pres


def bucket_agg_batched_plain(kid, nb: int, masks: torch.Tensor, aggs: list):
    """Plain PyTorch version of `bucket_agg_batched`: `bucket_agg_plain`
    over the B·n rows with member b's buckets at b·nb + bucket."""
    B, n = masks.shape
    dev = masks.device
    off = torch.arange(B, dtype=torch.int64, device=dev)[:, None]
    k = torch.zeros((B, n), dtype=torch.int64, device=dev) if kid is None \
        else _per_member(kid, B).to(torch.int64)
    k = torch.where((k >= 0) & (k < nb), k + off * nb,
                    torch.full_like(k, -1)).reshape(-1)
    active = masks.reshape(-1) & (k >= 0)
    k = torch.clamp(k, min=0).to(torch.int32)
    flat = [(f, None if d is None else _per_member(d, B).reshape(-1),
             None if v is None else _per_member(v, B).reshape(-1), u)
            for (f, d, v, u) in aggs]
    vals, cnts, present = bucket_agg_plain(k, B * nb, active, flat)
    out_vals = []
    for (f, *_r), v in zip(aggs, vals):
        v = v.reshape(B, nb)
        if f == "first":     # flat row id → the member's row id (n: none)
            v = torch.where(v >= B * n, torch.full_like(v, n), v - off * n)
        out_vals.append(v)
    return out_vals, [c.reshape(B, nb) for c in cnts], present.reshape(B, nb)


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
    (int32) and overflow = live > new_cap (bool). On the card it is the
    member kernel's B = 1 (one launch a chunk of columns)."""
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
    outs, live, new_len, ovf = _compact_members(
        "compact", cols, [0] * len(cols), mask, 0, length, n, new_cap, 1,
        True, dev)
    return ([o.reshape(new_cap) for o in outs], live.reshape(()),
            new_len.reshape(()), ovf.reshape(()))


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


_CM_TILE = 32768                 # compact.cu CM_TILE: mask rows a block
_CM_EPOCHS = (1 << 30) - 1       # compact.cu: epochs 1 .. 2^30 - 1
_CM_STATUS: dict = {}            # (device type, index, stream) -> [words,
_CM_MU = threading.Lock()        # last epoch]


def compact_batched_plan(n: int, B: int) -> dict:
    """What `compact_batched` (and `compact`, B = 1) launches, from the
    shapes alone: one launch a chunk of _MAX_COLS columns, of `blocks` =
    B x `tiles` blocks (each a member's tile of 32,768 rows, at least one
    a member), over `status_words` int64 words (the ticket and a
    look-back word a block)."""
    tiles = max(-(-n // _CM_TILE), 1)
    return {"tiles": tiles, "blocks": B * tiles, "status_words": 1 + B * tiles,
            "launches": 1}


def compact_batched(cols: list, masks: Optional[torch.Tensor], lengths,
                    n: int, new_cap: int, B: int, zero_tail: bool = False):
    """`compact` for B members at once: member b keeps the rows r <
    lengths[b] (and masks[b, r]) of each column, in order, in row b of a
    (B, new_cap) output.

    cols: each shared (n,) or per member (B, n), any element width;
    masks: bool (B, n), shared (n,), or None; lengths: int32 (B,), or one
    length for every member (an int or 0-d tensor).

    Returns (outs, live, new_len, overflow): (B, new_cap) columns and (B,)
    live counts (int32), new_len = min(live, new_cap) and overflow = live
    > new_cap. Only each member's live prefix [0, new_len[b]) is defined:
    the kernel writes nothing past it, unless `zero_tail` asks for outputs
    zeroed first (the plain version's zeros)."""
    dev = masks.device if masks is not None else (
        cols[0].device if cols else lengths.device)
    if dev.type != "cuda":
        return compact_batched_plain(cols, masks, lengths, n, new_cap, B,
                                     zero_tail=zero_tail)
    ms = 0
    if masks is not None:
        ms = _member_stride(masks, "masks", dev, B, n, (torch.bool,))
    strides = [_member_stride(c, f"column {i}", dev, B, n)
               for i, c in enumerate(cols)]
    return _compact_members("compact_batched", cols, strides, masks, ms,
                            lengths, n, new_cap, B, zero_tail, dev)


def _compact_members(name: str, cols: list, strides: list, masks, ms: int,
                     lengths, n: int, new_cap: int, B: int, zero_tail: bool,
                     dev):
    """The launches of `compact` (B = 1) and `compact_batched`, counted
    under `name`: one a chunk of _MAX_COLS columns, the first counting.
    `cols`, `masks` and `lengths` are checked; `strides` and `ms` are
    their member strides."""
    for i, c in enumerate(cols):
        if c.element_size() not in (1, 2, 4, 8):
            raise ValueError(f"column {i}: element size {c.element_size()}")
    # a host length goes by value: copying it to the card would wait
    # for the stream
    lengths_t, ls, length = None, 0, 0
    if isinstance(lengths, torch.Tensor) and lengths.dim() == 1:
        _check(lengths, "lengths", dev, B, (torch.int32,))
        lengths_t, ls = lengths, 1
    elif isinstance(lengths, torch.Tensor):
        lengths_t = _length_tensor(lengths, dev)
    else:
        length = int(lengths)
    if n >= 1 << 31:
        raise ValueError(f"{n} rows (at most 2^31 - 1)")
    plan = compact_batched_plan(n, B)
    live = torch.empty(B, dtype=torch.int32, device=dev)
    new_len = torch.empty(B, dtype=torch.int32, device=dev)
    ovf = torch.empty(B, dtype=torch.bool, device=dev)
    alloc = torch.zeros if zero_tail else torch.empty
    outs = [alloc((B, new_cap), dtype=c.dtype, device=dev) for c in cols]
    chunks = [list(range(i, min(i + _MAX_COLS, len(cols))))
              for i in range(0, len(cols), _MAX_COLS)] or [[]]
    key = (dev.type, dev.index, _stream())
    with _CM_MU:
        # the look-back words and the ticket, kept per stream: zeroed
        # once; each call tags its words with a new epoch, and the
        # kernel leaves the ticket zero
        ent = _CM_STATUS.get(key)
        if ent is None or ent[0].numel() < plan["status_words"]:
            ent = _CM_STATUS[key] = [torch.zeros(
                plan["status_words"], dtype=torch.int64, device=dev), 0]
        ent[1] = ent[1] % _CM_EPOCHS + 1
        status, epoch = ent
        for j, chunk in enumerate(chunks):
            _launch(name, n, B, _ptr(lengths_t), ls, length, _ptr(masks),
                    ms, new_cap, _ptr(status), epoch, _ptr(live),
                    _ptr(new_len), _ptr(ovf), len(chunk),
                    _arr(ctypes.c_int64, [_ptr(cols[i]) for i in chunk]),
                    _arr(ctypes.c_int64, [strides[i] for i in chunk]),
                    _arr(ctypes.c_int64, [_ptr(outs[i]) for i in chunk]),
                    _arr(ctypes.c_int32, [cols[i].element_size()
                                          for i in chunk]),
                    1 if j == 0 else 0, _stream())
    return outs, live, new_len, ovf


def compact_batched_plain(cols: list, masks, lengths, n: int, new_cap: int,
                          B: int, zero_tail: bool = False):
    """Plain PyTorch version of `compact_batched` (a rank per member by
    cumulative sum, then one scatter over the B·new_cap slots). Its tails
    are always zero, `zero_tail` or not: zeros are one of the values an
    undefined tail may hold."""
    dev = masks.device if masks is not None else (
        cols[0].device if cols else lengths.device)
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    if isinstance(lengths, torch.Tensor) and lengths.dim() == 1:
        lens = lengths.to(device=dev, dtype=torch.int32)
    else:
        lens = _length_tensor(lengths, dev).expand(B)
    active = iota[None, :] < lens[:, None]
    if masks is not None:
        active = active & _per_member(masks, B)
    rank = torch.cumsum(active.to(torch.int64), 1) - 1
    live = active.sum(1).to(torch.int32)
    off = torch.arange(B, dtype=torch.int64, device=dev)[:, None] * new_cap
    keep = active & (rank < new_cap)
    slot = torch.where(keep, off + rank,
                       torch.full_like(rank, B * new_cap)).reshape(-1)
    outs = []
    for c in cols:
        o = torch.zeros(B * new_cap + 1, dtype=c.dtype, device=dev)
        o.index_copy_(0, slot, _per_member(c, B).reshape(-1))
        outs.append(o[:B * new_cap].reshape(B, new_cap))
    new_len = torch.clamp(live, max=new_cap)
    return outs, live, new_len, live > new_cap


# --------------------------------------------------------------------------
# probe
# --------------------------------------------------------------------------

JOIN_KINDS = {"inner": 0, "left": 1, "left_semi": 2, "left_anti": 3,
              "mark": 4}
_MAX_PAYLOADS = 16
# by bsearch: threads a block (probe.cu LUT_PT, SEARCH_PT), rows a thread
# (LUT_R, SEARCH_R) and blocks an SM (LUT_BLOCKS, SEARCH_BLOCKS)
_PROBE_THREADS = {False: 512, True: 384}
_PROBE_ROWS = {False: 8, True: 8}
_PROBE_BLOCKS_PER_SM = {False: 2, True: 1}
_PROBE_LEVELS = 14               # search levels in shared memory (MAX_LEVELS)
_PROBE_MAX_KCAP = 1 << 30


def probe_plan(n: int, kcap_or_span: int, bsearch: bool, n_payloads: int,
               sms: int = 132) -> dict:
    """What `probe` launches for `n` probe rows against `kcap_or_span`
    sorted keys (`bsearch`) or LUT entries, with `n_payloads` gathered
    payloads, on a card of `sms` SMs (the H100's 132), from the shapes
    alone: the `threads` of a block (512 for the LUT, 384 for the
    search), `rows_per_thread` (8), `tiles` of a block's rows, the `grid`
    (two blocks an SM at most for the LUT, one for the search, walking
    the tiles), the search levels `levels` run over the pivots staged in
    shared memory (all of them up to 16,384 keys, else 14) and the
    `smem` bytes those take; below them (W = kcap >> levels keys a unit)
    `plain` levels a key a load, `groups` of three levels a 64-byte node
    read from a table of `table_words` int64 words that a first kernel
    fills, and the last three levels from one 64-byte window of keys
    (with W < 8 every level is plain; probe.cu search_shape, for keys on
    a 16-byte boundary); and the `launches` (the table's, then one per
    16 payloads, at least one; none for 0 rows)."""
    bsearch = bool(bsearch)
    rows = _PROBE_ROWS[bsearch]
    tiles = -(-n // (rows * _PROBE_THREADS[bsearch]))
    plan = {"rows_per_thread": rows, "threads": _PROBE_THREADS[bsearch],
            "tiles": tiles,
            "grid": min(tiles, _PROBE_BLOCKS_PER_SM[bsearch] * sms),
            "levels": 0, "smem": 0, "plain": 0, "groups": 0,
            "table_words": 0}
    if bsearch:
        levels = min(max(kcap_or_span - 1, 0).bit_length(), _PROBE_LEVELS)
        lw = max((kcap_or_span >> levels) - 1, 0).bit_length()
        plain, groups = (lw, 0) if lw < 3 else ((lw - 3) % 3, (lw - 3) // 3)
        plan.update(levels=levels, smem=8 << levels, plain=plain,
                    groups=groups, table_words=sum(
                        (kcap_or_span >> (lw - plain - 3 * g)) * 8
                        for g in range(groups)))
    chunks = max(1, -(-n_payloads // _MAX_PAYLOADS))
    plan["launches"] = 0 if n == 0 else chunks + (plan["table_words"] > 0)
    return plan


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
        if kc & (kc - 1) or kc > _PROBE_MAX_KCAP or (n and kc < 1):
            raise ValueError(f"bsearch needs a pow2-padded build of 1 to "
                             f"{_PROBE_MAX_KCAP} keys, not {kc}")
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
    plan = probe_plan(n, keys_sorted.shape[0] if lut is None else 0,
                      lut is None, len(payloads))
    table = torch.empty(plan["table_words"], dtype=torch.int64,
                        device=dev) if plan["table_words"] else None
    chunks = [list(range(i, min(i + _MAX_PAYLOADS, len(payloads))))
              for i in range(0, len(payloads), _MAX_PAYLOADS)] or [[]]
    for j, chunk in enumerate(chunks):
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
                _stream(), _ptr(table), plan["table_words"], int(j == 0))
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
_SORT_TILE = 4096                # rows a tile of a digit pass (sort.cu RTILE)
_SORT_BINS = 256                 # 8-bit digits
_SORT_BLOCK_MAX = 8192           # the one-block path's most rows (BLOCK_MAX)
_SORT_PASS_INTS = 8              # ints of a pass-table entry (sort.cu Pass)


def sort_plan(n: int, n_keys: int) -> dict:
    """What `sort_perm` launches for `n` rows of `n_keys` words, from the
    shapes alone (no sync): "none" for 0 rows; "block" (one launch: the
    digit passes inside one block over `block_rows`, the power of two
    >= n, in `smem` bytes of shared memory); or "radix": the
    census, then one launch per pass of the maximal list `passes`
    ((word, digit) pairs, the least significant digit of the last word
    first: 8 a word), over `tiles` tiles, with `key_scratch` int64 and
    `row_scratch` int32 ping-pong words and `ctl_words` zeroed int64
    words (look-back words, census, tickets, pass table; sort.cu
    ctl_words). The census decides on the card which passes run."""
    if n == 0:
        return {"path": "none", "launches": 0}
    rows = 1 << max(n - 1, 0).bit_length()
    if rows <= _SORT_BLOCK_MAX:
        # sort.cu block_smem: two words, two row ids and a rank a row,
        # and the eight warps' counts of the 256 bins
        return {"path": "block", "block_rows": rows,
                "smem": rows * 26 + 8 * _SORT_BINS * 4, "launches": 1}
    tiles = -(-n // _SORT_TILE)
    passes = [(n_keys - 1 - p // 8, p % 8) for p in range(8 * n_keys)]
    ints = n_keys * 8 * _SORT_BINS + 8 * n_keys + 1 \
        + _SORT_PASS_INTS * 8 * n_keys
    return {"path": "radix", "tiles": tiles, "passes": passes,
            "launches": 1 + len(passes), "key_scratch": 2 * n,
            "row_scratch": 2 * n,
            "ctl_words": tiles * _SORT_BINS + (ints + 1) // 2}


def sort_perm(keys: list, n: int, device) -> torch.Tensor:
    """int32 permutation sorting rows by `keys` (int64 tensors holding
    order-preserving unsigned 64-bit keys, most significant first), the
    row id breaking ties. Any number of words: past the kernel's 16,
    `sort_perm_chained` sorts them 16 at a time."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return sort_perm_plain(keys, n, dev)
    for i, k in enumerate(keys):
        _check(k, f"key {i}", dev, n, (torch.int64,))
    if len(keys) > _MAX_KEYS:
        return sort_perm_chained(keys, n, dev, sort_perm)
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    plan = sort_plan(n, max(len(keys), 1))
    if plan["path"] == "none":
        return perm
    if not keys:                  # no key: the identity, as one equal word
        keys = [torch.zeros(n, dtype=torch.int64, device=dev)]
    ptrs = _arr(ctypes.c_int64, [_ptr(k) for k in keys])
    if plan["path"] == "block":
        _launch("sort", n, len(keys), ptrs, plan["block_rows"], _ptr(perm),
                None, None, None, 0, _stream())
        return perm
    kbuf = torch.empty(plan["key_scratch"], dtype=torch.int64, device=dev)
    rbuf = torch.empty(plan["row_scratch"], dtype=torch.int32, device=dev)
    ctl = torch.zeros(plan["ctl_words"], dtype=torch.int64, device=dev)
    _launch("sort", n, len(keys), ptrs, 0, _ptr(perm), _ptr(kbuf),
            _ptr(rbuf), _ptr(ctl), plan["ctl_words"], _stream())
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
# wide keys: more words than a kernel takes in one launch
# --------------------------------------------------------------------------
#
# The sort, segment_agg, window_scan and segments kernels read at most 16
# key words (hash64 16 columns). Past that, each wrapper hands its kernel
# a narrower input computed on the card, with no host sync, through one
# of the chains below. Each takes the <= `width`-word primitive as an
# argument, so a test can run it over a plain version capped at 16
# words and hold it against the uncapped one.


def sort_perm_chained(keys: list, n: int, device, sort16,
                      width: int = _MAX_KEYS) -> torch.Tensor:
    """`sort_perm` of any number of words through `sort16`, a sort of at
    most `width` words: the last `width` words first, then each earlier
    group gathered through the permutation so far, the permutations
    composed. Exact: each sort is stable (the row id breaks ties), so it
    keeps the order of the words after its group, as one sort of all the
    words would."""
    perm = None
    for hi in range(len(keys), 0, -width):
        group = keys[max(hi - width, 0):hi]
        if perm is None:
            perm = sort16(group, n, device)
        else:
            step = sort16([k.index_select(0, perm) for k in group], n,
                          device)
            perm = perm.index_select(0, step)
    return sort16([], n, device) if perm is None else perm


def group_word(perm: torch.Tensor, words: list) -> torch.Tensor:
    """One int64 word, in row order, that changes between rows adjacent
    in `perm`'s order exactly where one of `words` does: the number of
    changes up to the row's sorted position. `perm` is a permutation of
    all the rows."""
    n = perm.shape[0]
    i64 = dict(dtype=torch.int64, device=perm.device)
    if n == 0:
        return torch.zeros(0, **i64)
    step = torch.zeros(n - 1, dtype=torch.bool, device=perm.device)
    for w in words:
        ws = w.index_select(0, perm)
        step = step | (ws.narrow(0, 1, n - 1) != ws.narrow(0, 0, n - 1))
    gid = torch.cumsum(torch.cat([torch.zeros(1, **i64),
                                  step.to(torch.int64)]), 0)
    return torch.zeros_like(gid).scatter(0, perm.to(torch.int64), gid)


def fold_words(perm: torch.Tensor, words: list,
               width: int = _MAX_KEYS) -> list:
    """`words` when they fit `width`, else their `group_word`: the same
    runs of equal rows along `perm`."""
    return list(words) if len(words) <= width else [group_word(perm, words)]


def segment_agg_chained(perm, keys: list, active, aggs: list, oc: int,
                        agg16, width: int = _MAX_KEYS):
    """`segment_agg` (or, with masks for `active`, `segment_agg_batched`)
    of any number of key words through `agg16`, which takes at most
    `width`: past that, one group word (`group_word`), whose runs along
    `perm` are the words' runs."""
    return agg16(perm, fold_words(perm, keys, width), active, aggs, oc)


def window_scan_chained(perm, part_words: list, order_words: list,
                        aggs: list, scan16, width: int = _MAX_KEYS):
    """`window_scan` of any number of words through `scan16`, which takes
    at most `width` in all: past that, the partition words as one
    partition-id word and the order words as one dense-rank word (an
    order group starts where a partition or an order word changes, so
    the order words may fold apart from the partition words)."""
    if len(part_words) + len(order_words) > width:
        part_words = [group_word(perm, part_words)]
        order_words = [group_word(perm, order_words)] if order_words \
            else []
    return scan16(perm, part_words, order_words, aggs)


def hash64_chained(cols: list, pre: list, hash16,
                   width: int = 16) -> torch.Tensor:
    """`hash64` of any number of columns through `hash16`, which takes at
    most `width`: each later call folds the running hash, taken as it is
    (pre False), with the next columns. Exact: hash64 is a left fold."""
    h = hash16(cols[:width], pre[:width])
    for i in range(width, len(cols), width - 1):
        h = hash16([h] + cols[i:i + width - 1],
                   [False] + list(pre[i:i + width - 1]))
    return h


def wide_targets(keys: list, ndev: int, hash16,
                 width: int = 16) -> torch.Tensor:
    """`segment_targets` of any number of keys through `hash16` (a
    `hash64` of at most `width` columns): each key as int64, zeroed where
    it is not valid (splitmix64 maps 0 to 0, so that is the kernel's
    zeroed hash), hashed and folded `width` columns at a time, then the
    unsigned `% ndev`."""
    from ydb_tpu_torch.ops.spill import as_int64
    xs = []
    for d, v in keys:
        x = as_int64(d)
        xs.append(x if v is None else torch.where(v, x, torch.zeros_like(x)))
    h = hash64_chained(xs, [True] * len(xs), hash16, width)
    return umod64_plain(h, ndev).to(torch.int32)


# --------------------------------------------------------------------------
# bucket_perm
# --------------------------------------------------------------------------

_MAX_SORT_BUCKETS = 65535        # bucket_sort.cu: 16-bit ids, one spare
_MAX_SORT_MEMBERS = 65535
_BS_TILE = 4096                  # rows per block (bin_scan.cuh TILE_ROWS)
_BS_BINS = 257                   # 256 digits + the inactive rows' bin
_BS_SCAN_CHUNK = 8192            # bin_scan.cuh SCAN_CHUNK


def bucket_perm(kid: torch.Tensor, active: torch.Tensor,
                nbuckets: int) -> torch.Tensor:
    """int32 permutation that puts the active rows first, in (bucket id,
    row id) order, then the inactive rows: on its active prefix what
    ``sort_perm([encode_key(~active), encode_key(kid)])`` gives.

    kid: int32 bucket ids in [0, nbuckets), nbuckets <= 65,535; active:
    bool per row. Member form (the batched lane's per-member bucket ids):
    kid and active (B, cap), and the B·cap rows (member-major, as
    ``active.reshape(-1)``) ordered by (member, bucket id, row)."""
    dev = active.device
    if dev.type != "cuda":
        return bucket_perm_plain(kid, active, nbuckets)
    if not 1 <= nbuckets <= _MAX_SORT_BUCKETS:
        raise ValueError(f"{nbuckets} buckets (1 to {_MAX_SORT_BUCKETS})")
    members, cap = active.shape if active.dim() == 2 else (0, active.numel())
    if members > _MAX_SORT_MEMBERS:
        raise ValueError(f"{members} members (at most {_MAX_SORT_MEMBERS})")
    if kid.shape != active.shape:
        raise ValueError(f"kid: shape {tuple(kid.shape)}, expected "
                         f"{tuple(active.shape)}")
    if not (kid.is_contiguous() and active.is_contiguous()):
        raise ValueError("kid, active: not contiguous")
    n = active.numel()
    _check(active.reshape(-1), "active", dev, n, (torch.bool,))
    _check(kid.reshape(-1), "kid", dev, n, (torch.int32,))
    if n >= 1 << 31:
        raise ValueError(f"{n} rows (at most 2^31 - 1)")
    ntiles = (n + _BS_TILE - 1) // _BS_TILE
    e = max(_BS_BINS * ntiles, 1)
    i32 = dict(dtype=torch.int32, device=dev)
    perm = torch.empty(n, **i32)
    passes = 1 + (nbuckets > 256) + (members > 1) + (members > 256)
    m = n if passes > 1 else 1
    ping = [torch.empty(m, **i32) for _ in range(4)]
    hist = torch.empty(e, **i32)
    offs = torch.empty(e, **i32)
    chunk_sums = torch.empty(max((e + _BS_SCAN_CHUNK - 1) // _BS_SCAN_CHUNK,
                                 1), **i32)
    _launch("bucket_perm", n, _ptr(kid), cap, _ptr(active), nbuckets,
            members, _ptr(perm), *[_ptr(t) for t in ping],
            _ptr(hist), _ptr(offs), _ptr(chunk_sums), _stream())
    return perm


def bucket_perm_plain(kid, active, nbuckets: int) -> torch.Tensor:
    """Plain PyTorch version of `bucket_perm`: one stable sort of the
    bucket id, the inactive rows mapped past every bucket (the member
    form: of member · nbuckets + bucket id)."""
    if active.dim() == 2:
        members = active.shape[0]
        member = torch.arange(members, dtype=torch.int64,
                              device=active.device)[:, None]
        key = member * nbuckets + kid.to(torch.int64)
        key = torch.where(active, key, members * nbuckets).reshape(-1)
    else:
        key = torch.where(active, kid.to(torch.int64), nbuckets)
    return torch.sort(key, stable=True).indices.to(torch.int32)


# --------------------------------------------------------------------------
# segment_agg
# --------------------------------------------------------------------------

_SEG_TILE = 2048                 # sorted rows per block (segment_agg.cu)
_SEG_MAX_AGGS = 8                # aggregates per launch (segment_agg.cu)


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
    if not keys:
        raise ValueError("no key words")
    for i, k in enumerate(keys):
        _check(k, f"key {i}", dev, n, (torch.int64,))
    if len(keys) > _MAX_KEYS:
        return segment_agg_chained(perm, keys, active, aggs, oc, segment_agg)
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
    # per tile: its group starts, then its head's length in rows
    tile_cnt = torch.empty(2 * T, dtype=torch.int32, device=dev)
    tile_off = torch.empty(T, **i64)
    ngroups = torch.empty((), dtype=torch.int32, device=dev)
    # the kernel writes every slot (zeros past ngroups)
    lead = torch.empty(oc, dtype=torch.int32, device=dev)
    present = torch.empty(oc, **i64)
    vals, cnts = [], []
    chunks = [aggs[i:i + _SEG_MAX_AGGS]
              for i in range(0, len(aggs), _SEG_MAX_AGGS)] or [[]]
    # per chunk: the tiles' look-back words and the ticket counter
    status = torch.zeros((len(chunks), T + 1), **i64)
    for j, chunk in enumerate(chunks):
        A = len(chunk)
        out_val = torch.empty((A, oc), **i64)
        out_cnt = torch.empty((A, oc), **i64)
        # per-tile head and tail partials: (value, count) per aggregate,
        # and the active row count
        parts = [torch.empty(n_, **i64) for _ in ("head", "tail")
                 for n_ in (max(A, 1) * T, max(A, 1) * T, T)]
        types = _agg_types(chunk)
        _launch("segment_agg", n, _ptr(perm), len(keys),
                _arr(ctypes.c_int64, [_ptr(k) for k in keys]),
                _ptr(active), A,
                _arr(ctypes.c_int64, [_ptr(d) or 0 for (_f, d, _v, _u)
                                      in chunk]),
                _arr(ctypes.c_int64, [_ptr(v) or 0 for (_f, _d, v, _u)
                                      in chunk]),
                _arr(ctypes.c_int32, [AGG_FUNCS[f] for (f, *_r) in chunk]),
                _arr(ctypes.c_int32, types), oc, _ptr(status[j]),
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


_SM_GROUPS = 8                   # segment_agg.cu MGROUPS: fold blocks a tile
_SM_TILE = 4096                  # segment_agg.cu MTILE: union runs a tile
_SM_ZROWS = 16384                # segment_agg.cu MZROWS: slots a zero item
_SM_BLOCKS = 4                   # segment_agg.cu MBLOCKS: blocks a SM
_SA_CTL: dict = {}               # (device type, index, stream) -> [fold
_SA_MU = threading.Lock()        # words, member words]


def segment_agg_batched_plan(n: int, B: int, oc: int, n_aggs: int) -> dict:
    """What `segment_agg_batched` launches for `n` rows, `B` members,
    `oc` slots and `n_aggs` aggregates, from the shapes alone (no sync):
    one C call a chunk of 8 aggregates (the hidden `first` that carries
    lead is the first chunk's first), each three kernels — the fold over
    `fold_tiles` tiles of 2,048 sorted rows in `fold_blocks` blocks (up
    to 8 member groups a tile; one block a tile for B = 1), the fix, and
    the member compaction over at most `member_tiles` (tile of 4,096
    union runs, member) items and `zero_items` (member, 16,384 slots)
    items —; the
    control words kept per stream, zero between calls: `fold_words` (the
    fold's look-back words and ticket) and `member_words` (the
    compaction's ticket and look-back words). No launch for 0 rows."""
    specs = n_aggs + 1
    chunks = -(-specs // _SEG_MAX_AGGS)
    if n == 0:
        return {"calls": 0, "launches": 0, "chunks": chunks,
                "fold_tiles": 0, "fold_blocks": 0, "member_tiles": 0,
                "zero_items": 0,
                "member_blocks": 0, "fold_words": 0, "member_words": 0}
    T = -(-n // _SEG_TILE)
    tm = -(-oc // _SM_TILE)
    zero = B * -(-oc // _SM_ZROWS)
    return {"calls": chunks, "launches": 3 * chunks, "chunks": chunks,
            "fold_tiles": T, "fold_blocks": T * min(B, _SM_GROUPS),
            "member_tiles": B * tm, "zero_items": zero,
            "member_blocks": min(B * tm + zero, _SM_BLOCKS * _SMS),
            "fold_words": T + 1, "member_words": 1 + B * tm}


def segment_agg_batched(perm: torch.Tensor, keys: list, masks: torch.Tensor,
                        aggs: list, oc: int,
                        union: Optional[torch.Tensor] = None):
    """`segment_agg` for B members that share one sort (the batched
    serving lane's group-by over shared keys).

    perm: int32 (n,) that puts the rows active in ANY member first,
    ordered by key (`sort_perm` over the union of the masks); keys: int64
    key words (n,), shared; masks: bool (B, n); aggs: as
    `bucket_agg_batched`'s (data and valid shared or per member); oc: the
    output capacity, at least the number of groups of the union; union:
    `masks.any(0)` when the caller has it (formed here otherwise).

    Returns (ngroups, lead, present, vals, cnts) as `segment_agg`'s with
    a leading member axis: ngroups (B,) int32 — a group with no active
    row in member b is absent from b's result, as a sort of b's rows
    alone drops it — and per member (B, oc) slots in key order: lead the
    group's first active row of the member (int32), present its active
    rows, the values and counts. Slots past a member's ngroups hold
    zeros. On the card: three kernels a chunk of 8 aggregates
    (`segment_agg_batched_plan`), every output slot written once."""
    B, n = masks.shape
    dev = masks.device
    if dev.type != "cuda":
        return segment_agg_batched_plain(perm, keys, masks, aggs, oc,
                                         union=union)
    _check(perm, "perm", dev, n, (torch.int32,))
    ms = _member_stride(masks, "masks", dev, B, n, (torch.bool,))
    if ms == 0:
        raise ValueError("masks: one row per member")
    if not keys:
        raise ValueError("no key words")
    for i, k in enumerate(keys):
        _check(k, f"key {i}", dev, n, (torch.int64,))
    if len(keys) > _MAX_KEYS:
        return segment_agg_chained(perm, keys, masks, aggs, oc,
                                   segment_agg_batched)
    # the member's first row per group rides as a hidden `first`, the
    # first chunk's first aggregate
    specs = []
    for func, data, valid, u in [("first", None, None, False)] + list(aggs):
        if func not in AGG_FUNCS:
            raise ValueError(func)
        ds = vs = 0
        if data is not None:
            ds = _member_stride(data, f"{func} data", dev, B, n,
                                (torch.float64, torch.int64))
        elif func in ("sum", "min", "max"):
            raise ValueError(f"{func} needs data")
        if valid is not None:
            vs = _member_stride(valid, f"{func} valid", dev, B, n,
                                (torch.bool,))
        specs.append((func, data, valid, u, ds, vs))
    if union is None:
        union = masks.any(0)
    else:
        _check(union, "union", dev, n, (torch.bool,))
    i64 = dict(dtype=torch.int64, device=dev)
    ngroups = torch.empty(B, dtype=torch.int32, device=dev)
    lead = torch.empty((B, oc), dtype=torch.int32, device=dev)
    present = torch.empty((B, oc), **i64)
    if n == 0:
        return (ngroups.zero_(), lead.zero_(), present.zero_(),
                [torch.zeros((B, oc), **i64) for _ in aggs],
                [torch.zeros((B, oc), **i64) for _ in aggs])
    plan = segment_agg_batched_plan(n, B, oc, len(aggs))
    T = plan["fold_tiles"]
    # per tile: its group starts, then its head's length in rows
    tile_cnt = torch.empty(2 * T, dtype=torch.int32, device=dev)
    tile_off = torch.empty(T, **i64)
    ngroups_u = torch.empty((), dtype=torch.int32, device=dev)
    # the presence partials of the union's runs: the first chunk's fold
    # writes them, every chunk's compaction ranks by them
    part_pres = torch.empty((B, oc), **i64)
    vals = [torch.empty((B, oc), **i64) for _ in aggs]
    cnts = [torch.empty((B, oc), **i64) for _ in aggs]
    chunks = [specs[i:i + _SEG_MAX_AGGS]
              for i in range(0, len(specs), _SEG_MAX_AGGS)]
    key = (dev.type, dev.index, _stream())
    with _SA_MU:
        ent = _SA_CTL.get(key)
        if ent is None or ent[0].numel() < plan["fold_words"] \
                or ent[1].numel() < plan["member_words"]:
            ent = _SA_CTL[key] = [
                torch.zeros(plan["fold_words"], **i64),
                torch.zeros(plan["member_words"], **i64)]
        fold_ctl, member_ctl = ent
        try:
            _members_chunks(n, perm, keys, union, B, masks, ms, oc, chunks,
                            T, fold_ctl, member_ctl, tile_cnt, tile_off,
                            ngroups_u, part_pres, lead, present, ngroups,
                            vals, cnts)
        except BaseException:
            # a launch that failed may have left control words dirty: the
            # next call takes fresh ones
            _SA_CTL.pop(key, None)
            raise
    for i, (func, d, *_r) in enumerate(specs[1:]):
        if d is not None and d.dtype == torch.float64 \
                and func in ("sum", "min", "max"):
            vals[i] = vals[i].view(torch.float64)
    return ngroups, lead, present, vals, cnts


def _members_chunks(n, perm, keys, union, B, masks, ms, oc, chunks, T,
                    fold_ctl, member_ctl, tile_cnt, tile_off, ngroups_u,
                    part_pres, lead, present, ngroups, vals, cnts):
    """segment_agg_batched's C calls, one a chunk of 8 aggregates."""
    i64 = dict(dtype=torch.int64, device=perm.device)
    for j, chunk in enumerate(chunks):
        A = len(chunk)
        # per-member partials at the union's runs, and the tiles' head
        # and tail partials
        part_val = torch.empty((B, A, oc), **i64)
        part_cnt = torch.empty((B, A, oc), **i64)
        parts = [torch.empty(n_, **i64) for _ in ("head", "tail")
                 for n_ in (B * A * T, B * A * T, B * T)]
        # each spec's output index (-1: the hidden first)
        outs = [j * _SEG_MAX_AGGS - 1 + a for a in range(A)]
        _launch("segment_agg_batched", n, _ptr(perm), len(keys),
                _arr(ctypes.c_int64, [_ptr(k) for k in keys]),
                _ptr(union), B, _ptr(masks), ms, A,
                _arr(ctypes.c_int64, [_ptr(c[1]) or 0 for c in chunk]),
                _arr(ctypes.c_int64, [c[4] for c in chunk]),
                _arr(ctypes.c_int64, [_ptr(c[2]) or 0 for c in chunk]),
                _arr(ctypes.c_int64, [c[5] for c in chunk]),
                _arr(ctypes.c_int32, [AGG_FUNCS[c[0]] for c in chunk]),
                _arr(ctypes.c_int32, _agg_types(chunk)), oc,
                _ptr(fold_ctl), _ptr(member_ctl), _ptr(tile_cnt),
                _ptr(tile_off), _ptr(ngroups_u), _ptr(part_val),
                _ptr(part_cnt), _ptr(part_pres),
                *[_ptr(p) for p in parts], 1 if j == 0 else 0,
                0 if j == 0 else -1, _ptr(lead), _ptr(present),
                _ptr(ngroups),
                _arr(ctypes.c_int64, [_ptr(vals[i]) if i >= 0 else 0
                                      for i in outs]),
                _arr(ctypes.c_int64, [_ptr(cnts[i]) if i >= 0 else 0
                                      for i in outs]),
                _stream())


def segment_agg_batched_plain(perm, keys: list, masks, aggs: list, oc: int,
                              union: Optional[torch.Tensor] = None):
    """Plain PyTorch version of `segment_agg_batched`: the runs of equal
    keys along `perm` (over the union of the masks), each member's runs
    that hold its rows ranked by cumulative sum, then
    `bucket_agg_batched_plain` over the per-member group ids."""
    B, n = masks.shape
    dev = masks.device
    p = perm.to(torch.int64)
    union = (masks.any(0) if union is None else union)[p]
    changed = torch.ones(n, dtype=torch.bool, device=dev)
    if n:
        changed[1:] = ~union[:-1]
        for k in keys:
            ks = k[p]
            changed[1:] |= ks[1:] != ks[:-1]
    run = torch.cumsum((union & changed).to(torch.int64), 0) - 1  # sorted
    act = masks[:, p] & union[None, :]                   # (B, n) sorted
    run_b = torch.where(act, run[None, :].expand(B, n),
                        torch.full((B, n), n, dtype=torch.int64, device=dev))
    hits = torch.zeros((B, n + 1), dtype=torch.int64, device=dev)
    hits.scatter_add_(1, run_b, act.to(torch.int64))
    has = hits[:, :n] > 0
    rank = torch.cumsum(has.to(torch.int64), 1) - 1
    ngroups = has.sum(1).to(torch.int32)
    gid_sorted = torch.where(act, rank.gather(1, torch.clamp(run_b, 0,
                                                             max(n - 1, 0))),
                             torch.full_like(run_b, -1))
    gid = torch.full((B, n), -1, dtype=torch.int64, device=dev)
    gid[:, p] = gid_sorted                               # original order
    live_row = (gid >= 0) & (gid < oc)
    kid = torch.where(live_row, gid, torch.zeros_like(gid)).to(torch.int32)
    vals, cnts, present = bucket_agg_batched_plain(
        kid, oc, masks & live_row,
        list(aggs) + [("first", None, None, False)])
    lead = vals.pop()
    cnts.pop()
    live = torch.arange(oc, device=dev)[None, :] < ngroups[:, None]
    lead = torch.where(live, lead, torch.zeros_like(lead)).to(torch.int32)
    out_vals = [torch.where(live, v, torch.zeros_like(v)) for v in vals]
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
    `utils/hashing.py`'s numpy branch. Columns with a member axis
    ((B, n), the batched lane) hash as one launch over their B·n rows,
    shared (n,) ones broadcast against them."""
    pre = [True] * len(cols) if pre is None else list(pre)
    shape = torch.broadcast_shapes(*[c.shape for c in cols])
    if len(shape) > 1:
        return hash64([c.expand(shape).reshape(-1) for c in cols],
                      pre).reshape(shape)
    cols = [c.to(torch.int64).contiguous() for c in cols]
    dev = cols[0].device
    if dev.type != "cuda":
        return hash64_plain(cols, pre)
    n = cols[0].shape[0]
    if not cols or len(pre) != len(cols):
        raise ValueError(f"{len(cols)} hash columns, {len(pre)} flags")
    for i, c in enumerate(cols):
        _check(c, f"column {i}", dev, n, (torch.int64,))
    if len(cols) > _MAX_HASH_COLS:
        return hash64_chained(cols, pre, hash64, _MAX_HASH_COLS)
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


# --------------------------------------------------------------------------
# window_scan
# --------------------------------------------------------------------------

_MAX_WINDOW_WORDS = 16
_MAX_SCANS = 32                  # window_scan.cu MAX_Q
_SCAN_TILE = 1024                # rows per block (window_scan.cu TILE)
_SCAN_OPS = {("sum", torch.int64): 0, ("sum", torch.float64): 1,
             ("min", torch.int64): 2, ("min", torch.float64): 3,
             ("max", torch.int64): 4, ("max", torch.float64): 5}
# scan sources (window_scan.cu SRC_*)
_PART_IDX, _ORDER_IDX, _ORDER_CNT, _VALUE, _VALID_CNT = range(5)


_SCAN_STATUS: dict = {}          # (device type, index, stream) -> status
_SCAN_MU = threading.Lock()


def window_scan(perm: torch.Tensor, part_words: list, order_words: list,
                aggs: list):
    """Segmented scans over the rows taken in the order `perm` (int32),
    partitions starting where a partition word changes, order groups
    where a partition or order word changes (the words are int64 tensors
    in original row order, read through `perm`).

    aggs: [(op, data, valid)] with op "sum", "min" or "max", data an
    int64 or float64 column (original row order), valid a bool column or
    None.

    Returns (seg_start, seg_end, grp_start, dense, scans), each an (n,)
    int64 per sorted position: the first and last sorted position of the
    row's partition, the first of its order group, and the count of
    order groups from the partition start to the row (dense rank); per
    aggregate (value, count): the inclusive in-partition prefix of the
    valid values (sum) or their running min / max (the identity, ±inf or
    the int64 extreme, before the first valid row), and the inclusive
    in-partition count of valid rows."""
    n = perm.shape[0]
    dev = perm.device
    if dev.type != "cuda":
        return window_scan_plain(perm, part_words, order_words, aggs)
    _check(perm, "perm", dev, n, (torch.int32,))
    words = list(part_words) + list(order_words)
    if not part_words:
        raise ValueError(f"{len(part_words)} partition and "
                         f"{len(order_words)} order words")
    for i, w in enumerate(words):
        _check(w, f"word {i}", dev, n, (torch.int64,))
    if len(words) > _MAX_WINDOW_WORDS:
        return window_scan_chained(perm, part_words, order_words, aggs,
                                   window_scan, _MAX_WINDOW_WORDS)
    for op, data, valid in aggs:
        _check(data, f"{op} data", dev, n, (torch.int64, torch.float64))
        if (op, data.dtype) not in _SCAN_OPS:
            raise ValueError(op)
        if valid is not None:
            _check(valid, f"{op} valid", dev, n, (torch.bool,))
    i64 = dict(dtype=torch.int64, device=dev)
    seg_start, grp_start, dense, seg_end = (torch.empty(n, **i64)
                                            for _ in range(4))
    scans = [(torch.empty(n, dtype=d.dtype, device=dev), torch.empty(n, **i64))
             for (_op, d, _v) in aggs]
    per = (_MAX_SCANS - 3) // 2
    chunks = [list(range(i, min(i + per, len(aggs))))
              for i in range(0, len(aggs), per)] or [[]]
    T = max((n + _SCAN_TILE - 1) // _SCAN_TILE, 1)
    # the tiles' aggregates and prefixes, written before they are read
    lookback = torch.empty(2 * _MAX_SCANS * T, **i64)
    key = (dev.type, dev.index, _stream())
    need = len(chunks) * (T + 1)
    with _SCAN_MU:
        # per launch T + 1 status words (the tiles' flags, the ticket),
        # kept per stream: zero on entry, and the last launch leaves
        # them zero for the next call on the stream
        status = _SCAN_STATUS.get(key)
        if status is None or status.numel() < need:
            status = _SCAN_STATUS[key] = torch.zeros(
                need, dtype=torch.int32, device=dev)
        done = False
        try:
            for c, chunk in enumerate(chunks):
                # every launch recomputes the boundaries and the three
                # structure scans; scan 0 must be the partition start
                # (seg_end reads it)
                q = [("max", _PART_IDX, None, None, seg_start),
                     ("max", _ORDER_IDX, None, None, grp_start),
                     ("sum", _ORDER_CNT, None, None, dense)]
                for a in chunk:
                    op, data, valid = aggs[a]
                    q.append((op, _VALUE, data, valid, scans[a][0]))
                    q.append(("sum", _VALID_CNT, None, valid, scans[a][1]))
                _launch(
                    "window_scan", n, _ptr(perm), len(part_words),
                    len(words),
                    _arr(ctypes.c_int64, [_ptr(w) for w in words]), len(q),
                    _arr(ctypes.c_int32,
                         [_SCAN_OPS[(op, d.dtype if d is not None
                                     else torch.int64)]
                          for (op, _s, d, _v, _o) in q]),
                    _arr(ctypes.c_int32,
                         [int(s not in (_PART_IDX, _ORDER_IDX))
                          for (_op, s, _d, _v, _o) in q]),
                    _arr(ctypes.c_int32, [s for (_op, s, _d, _v, _o) in q]),
                    _arr(ctypes.c_int64, [_ptr(d) or 0
                                          for (_op, _s, d, _v, _o) in q]),
                    _arr(ctypes.c_int64, [_ptr(v) or 0
                                          for (_op, _s, _d, v, _o) in q]),
                    _arr(ctypes.c_int64, [_ptr(o)
                                          for (_op, _s, _d, _v, o) in q]),
                    T, _ptr(status), c, len(chunks), _ptr(lookback),
                    _ptr(seg_end), _stream())
            done = True
        finally:
            if not done:           # a launch that did not run leaves them
                _SCAN_STATUS.pop(key, None)
    return seg_start, seg_end, grp_start, dense, scans


def _seg_scan_plain(x: torch.Tensor, reset: torch.Tensor, fn):
    """Inclusive scan of `x` under `fn`, restarting where `reset` is set
    (Hillis–Steele doubling: log2(n) shifted combines)."""
    x, reset = x.clone(), reset.clone()
    n = x.shape[0]
    d = 1
    while d < n:
        comb = torch.where(reset[d:], x[d:], fn(x[:-d], x[d:]))
        reset = torch.cat([reset[:d], reset[d:] | reset[:-d]])
        x = torch.cat([x[:d], comb])
        d *= 2
    return x


def window_scan_plain(perm, part_words: list, order_words: list, aggs: list):
    """Plain PyTorch version of `window_scan`: boundaries by adjacent
    comparison, starts by `cummax`, ends by a reversed `cummin`, integer
    counts by `cumsum` differences, and the value scans by a segmented
    doubling scan (a prefix never crosses a partition)."""
    n = perm.shape[0]
    dev = perm.device
    p = perm.to(torch.int64)
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    b_part = torch.ones(n, dtype=torch.bool, device=dev)
    b_order = torch.ones(n, dtype=torch.bool, device=dev)
    if n:
        for w in part_words:
            ws = w[p]
            b_part[1:] &= ws[1:] == ws[:-1]
        b_part = ~b_part
        b_part[0] = True
        b_order[1:] = b_part[1:]
        for w in order_words:
            ws = w[p]
            b_order[1:] |= ws[1:] != ws[:-1]
    zero = torch.zeros_like(iota)
    seg_start = torch.cummax(torch.where(b_part, iota, zero), 0).values \
        if n else iota
    nxt = torch.cat([b_part[1:], torch.ones(min(n, 1), dtype=torch.bool,
                                            device=dev)])
    seg_end = torch.flip(torch.cummin(torch.flip(
        torch.where(nxt, iota, torch.full_like(iota, n - 1)), [0]), 0)
        .values, [0]) if n else iota
    grp_start = torch.cummax(torch.where(b_order, iota, zero), 0).values \
        if n else iota

    def in_part_count(flag):
        c = torch.cumsum(flag.to(torch.int64), 0)
        return c - c[seg_start] + flag[seg_start].to(torch.int64)

    dense = in_part_count(b_order)
    scans = []
    for op, data, valid in aggs:
        v = data[p]
        ok = torch.ones(n, dtype=torch.bool, device=dev) if valid is None \
            else valid[p]
        if op == "sum":
            x = torch.where(ok, v, torch.zeros_like(v))
            val = _seg_scan_plain(x, b_part, torch.add) \
                if v.dtype.is_floating_point else in_part_count(x)
        else:
            if v.dtype.is_floating_point:
                ident = float("inf") if op == "min" else float("-inf")
            else:
                ident = (1 << 63) - 1 if op == "min" else -(1 << 63)
            x = torch.where(ok, v, torch.full_like(v, ident))
            val = _seg_scan_plain(x, b_part, torch.minimum if op == "min"
                                  else torch.maximum)
        scans.append((val, in_part_count(ok)))
    return seg_start, seg_end, grp_start, dense, scans


# --------------------------------------------------------------------------
# expand_counts, expand_gather
# --------------------------------------------------------------------------

_EX_TILE = 2048                  # expand.cu EX_TILE: probe rows a tile
_EX_GRID = 264                   # expand.cu EX_GRID: 2 blocks a SM
_EX_EPOCHS = (1 << 62) - 1       # expand.cu: epochs 1 .. 2^62 - 1
_EX_STATUS: dict = {}            # (device type, index, stream) -> [flags,
_EX_MU = threading.Lock()        # sums, prefixes, last epoch]
_MAX_GATHER_COLS = 32
EXPAND_MODES = {"probe": 0, "build": 1, "build_valid": 2}


def expand_counts(key: torch.Tensor, kvalid: Optional[torch.Tensor],
                  length, keys_sorted: torch.Tensor, n_build: int,
                  left: bool):
    """Match counts of an expanding join probe. For each probe row
    r < length (int64 or float64 `key`, NULL where `kvalid` is False)
    the lower and upper bound of its key in the power-of-two padded
    `keys_sorted` of the same dtype, clipped to `n_build`.

    Returns (lo int32, mcounts int32, offsets int64, total 0-d int64):
    lo the first matching build row, mcounts the number of matches, and
    the exclusive prefix of the per-row output counts — the matches, or
    for LEFT at least 1 per active row — with their total."""
    n = key.shape[0]
    dev = key.device
    if dev.type != "cuda":
        return expand_counts_plain(key, kvalid, length, keys_sorted, n_build,
                                   left)
    _check(key, "key", dev, n, (torch.int64, torch.float64))
    _check(keys_sorted, "keys_sorted", dev, None, (key.dtype,))
    kc = keys_sorted.shape[0]
    if kc & (kc - 1):
        raise ValueError("expand needs a pow2-padded build")
    if kvalid is not None:
        _check(kvalid, "key valid", dev, n, (torch.bool,))
    if n >= 1 << 31:
        raise ValueError(f"{n} probe rows (at most 2^31 - 1)")
    length_t = _length_tensor(length, dev)
    lo = torch.empty(n, dtype=torch.int32, device=dev)
    mcounts = torch.empty(n, dtype=torch.int32, device=dev)
    offsets = torch.empty(n, dtype=torch.int64, device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    plan = expand_counts_plan(n)
    T = plan["tiles"]
    key_ = (dev.type, dev.index, _stream())
    with _EX_MU:
        # the look-back words, kept per stream: the flags (and the
        # ticket) zeroed once, each call's tagged with a new epoch; a
        # tile's sum and prefix in words of their own, read only after
        # the tile's flag
        ent = _EX_STATUS.get(key_)
        if ent is None or ent[1].numel() < T:
            ent = _EX_STATUS[key_] = [
                torch.zeros(1 + T, dtype=torch.int64, device=dev),
                torch.empty(T, dtype=torch.int64, device=dev),
                torch.empty(T, dtype=torch.int64, device=dev), 0]
        ent[3] = ent[3] % _EX_EPOCHS + 1
        flags, sums, prefixes, epoch = ent
        _launch("expand_counts", n, _ptr(key),
                int(key.dtype == torch.float64), _ptr(kvalid),
                _ptr(length_t), _ptr(keys_sorted), kc, int(n_build),
                int(bool(left)), _ptr(lo), _ptr(mcounts), _ptr(offsets),
                _ptr(total), _ptr(flags), _ptr(sums), _ptr(prefixes), epoch,
                plan["grid"], _stream())
    return lo, mcounts, offsets, total


def expand_counts_plan(n: int) -> dict:
    """What `expand_counts` launches, from the row count alone: one
    launch of `grid` blocks (at most 264, two a SM) that draw the
    `tiles` tiles of 2,048 probe rows by ticket, over `status_words`
    zeroed flag words (the ticket and a look-back word a tile) and two
    words a tile for its sum and prefix."""
    tiles = max(-(-n // _EX_TILE), 1)
    return {"tiles": tiles, "grid": min(tiles, _EX_GRID),
            "status_words": 1 + tiles, "launches": 1}


def expand_counts_plain(key, kvalid, length, keys_sorted, n_build: int,
                        left: bool):
    """Plain PyTorch version of `expand_counts` (`searchsorted` twice and
    a cumulative sum, the reference's arithmetic)."""
    n = key.shape[0]
    dev = key.device
    active = torch.arange(n, dtype=torch.int32, device=dev) \
        < _length_tensor(length, dev)
    matchable = active if kvalid is None else (active & kvalid)
    lo = torch.clamp(torch.searchsorted(keys_sorted, key), max=n_build)
    hi = torch.clamp(torch.searchsorted(keys_sorted, key, right=True),
                     max=n_build)
    mcounts = torch.where(matchable, hi - lo, torch.zeros_like(lo))
    counts = torch.where(active, torch.clamp(mcounts, min=1),
                         torch.zeros_like(mcounts)) if left else mcounts
    csum = torch.cumsum(counts, 0)
    return (lo.to(torch.int32), mcounts.to(torch.int32), csum - counts,
            csum[-1] if n else torch.zeros((), dtype=torch.int64,
                                           device=dev))


def expand_gather(lo: torch.Tensor, mcounts: torch.Tensor,
                  offsets: torch.Tensor, total: torch.Tensor, out_cap: int,
                  pcap: int, cols: list) -> list:
    """The output rows of an expanding probe: slot j < out_cap belongs to
    probe row ``row = searchsorted(offsets, j, right) - 1`` and to its
    ``k = j - offsets[row]``-th match, build row ``bidx = lo[row] + k``
    clipped to [0, pcap); it is a match when the row has one and
    j < total (a null-extended LEFT row has none).

    cols: [(src, mode)] — mode "probe": src[row]; "build": src[bidx];
    "build_valid": the match flag and src[bidx] (src a bool column, or
    None for the flag alone). Returns one (out_cap,) tensor per column."""
    n = lo.shape[0]
    dev = lo.device
    if dev.type != "cuda":
        return expand_gather_plain(lo, mcounts, offsets, total, out_cap,
                                   pcap, cols)
    _check(lo, "lo", dev, n, (torch.int32,))
    _check(mcounts, "mcounts", dev, n, (torch.int32,))
    _check(offsets, "offsets", dev, n, (torch.int64,))
    outs = []
    for i, (src, mode) in enumerate(cols):
        if mode not in EXPAND_MODES:
            raise ValueError(mode)
        if src is None and mode != "build_valid":
            raise ValueError(f"column {i}: {mode} needs a source")
        if src is not None:
            _check(src, f"column {i}", dev, n if mode == "probe" else pcap)
            if src.element_size() not in (1, 2, 4, 8):
                raise ValueError(f"column {i}: element size "
                                 f"{src.element_size()}")
            if mode == "build_valid" and src.dtype != torch.bool:
                raise ValueError(f"column {i}: validity must be bool")
        outs.append(torch.empty(out_cap, dtype=torch.bool
                                if mode == "build_valid" else src.dtype,
                                device=dev))
    chunks = [list(range(i, min(i + _MAX_GATHER_COLS, len(cols))))
              for i in range(0, len(cols), _MAX_GATHER_COLS)] or [[]]
    for chunk in chunks:
        _launch("expand_gather", out_cap, n, _ptr(lo), _ptr(mcounts),
                _ptr(offsets), _ptr(total), int(pcap), len(chunk),
                _arr(ctypes.c_int64, [_ptr(cols[i][0]) or 0 for i in chunk]),
                _arr(ctypes.c_int64, [_ptr(outs[i]) for i in chunk]),
                _arr(ctypes.c_int32, [outs[i].element_size() for i in chunk]),
                _arr(ctypes.c_int32, [EXPAND_MODES[cols[i][1]]
                                      for i in chunk]),
                _stream())
    return outs


def expand_gather_plain(lo, mcounts, offsets, total, out_cap: int, pcap: int,
                        cols: list) -> list:
    """Plain PyTorch version of `expand_gather` (`searchsorted` of the
    slots into the offsets, then gathers)."""
    n = lo.shape[0]
    dev = lo.device
    j = torch.arange(out_cap, dtype=torch.int64, device=dev)
    row = torch.clamp(torch.searchsorted(offsets, j, right=True) - 1, 0,
                      max(n - 1, 0))
    if n == 0:
        row = torch.zeros_like(j)
        lo = torch.zeros(1, dtype=torch.int32, device=dev)
        mcounts = torch.zeros(1, dtype=torch.int32, device=dev)
        offsets = torch.zeros(1, dtype=torch.int64, device=dev)
    k = j - offsets[row]
    bidx = torch.clamp(lo[row].to(torch.int64) + k, 0, pcap - 1)
    found = (mcounts[row] > 0) & (j < total)
    outs = []
    for src, mode in cols:
        if mode == "probe":
            outs.append(src[row] if n else torch.zeros(
                out_cap, dtype=src.dtype, device=dev))
        elif mode == "build":
            outs.append(src[bidx])
        elif src is None:
            outs.append(found)
        else:
            outs.append(found & src[bidx])
    return outs


# --------------------------------------------------------------------------
# partition
# --------------------------------------------------------------------------

_MAX_PARTS = 256
_PART_COLS = 32                  # partition.cu MAX_COLS
_PART_TILE = 4096                # rows a tile (partition.cu PTILE)
_PART_WARPS = 8                  # partition.cu PWARPS


def _check_parts(nparts: int) -> None:
    if not 1 <= nparts <= _MAX_PARTS or nparts & (nparts - 1):
        raise ValueError(f"{nparts} partitions (a power of two, 1 to "
                         f"{_MAX_PARTS})")


def partition_plan(n: int, nparts: int, n_cols: int,
                   out_rows: Optional[int] = None) -> dict:
    """What `partition` launches for `n` rows into `nparts` partitions
    with `n_cols` columns and `out_rows` output rows, from the shapes
    alone (no sync): `launches` kernel launches (the census and one
    scatter for up to 32 columns, one more scatter a further 32; none
    for 0 rows), over `tiles` 4,096-row tiles and `zero_chunks` chunks of
    the zero tail [n, out_rows) (written by the scatter itself), with
    `smem` bytes of dynamic shared memory a scatter block and
    `ctl_words` zeroed int64 control words (partition.cu ctl_words: the
    look-back words, the census, the bases, the census's done counter
    and a ticket a scatter)."""
    out_rows = n if out_rows is None else out_rows
    chunks = max(1, -(-n_cols // _PART_COLS))
    if n == 0:
        return {"launches": 0, "tiles": 0, "zero_chunks": 0,
                "chunks": chunks, "smem": 0, "ctl_words": 0}
    tiles = -(-n // _PART_TILE)
    return {"launches": 1 + chunks, "tiles": tiles,
            "zero_chunks": -(-(out_rows - n) // _PART_TILE),
            "chunks": chunks,
            "smem": _PART_TILE * (8 + 2 + 1) + _PART_WARPS * nparts * 4,
            "ctl_words": tiles * nparts + 2 * nparts + 1 + chunks}


def partition(hashes: torch.Tensor, length, nparts: int, cols: list,
              out_rows: Optional[int] = None, ids: bool = True):
    """Stable counting sort of rows by hash partition: row r < length
    goes to partition `hashes[r] % nparts` (the int64 bits taken as
    uint64; `nparts` a power of two), rows past the length to the extra
    bin `nparts`.

    Returns (ids, counts, outs): the int32 partition id of every row (in
    row order; None unless `ids`), the int64 row count of each partition,
    and each column of `cols` (any element width) moved to (partition,
    row) order — each partition a contiguous range, rows in their order,
    rows past the length last — in a buffer of `out_rows` (>= n, default
    n) rows whose rows past n are zero."""
    n = hashes.shape[0]
    dev = hashes.device
    out_rows = n if out_rows is None else out_rows
    if dev.type != "cuda":
        return partition_plain(hashes, length, nparts, cols, out_rows,
                               ids=ids)
    _check_parts(nparts)
    _check(hashes, "hashes", dev, n, (torch.int64,))
    if n >= 1 << 31 or out_rows < n:
        raise ValueError(f"{n} rows into {out_rows}")
    for i, c in enumerate(cols):
        _check(c, f"column {i}", dev, n)
        if c.element_size() not in (1, 2, 4, 8):
            raise ValueError(f"column {i}: element size {c.element_size()}")
    plan = partition_plan(n, nparts, len(cols), out_rows)
    if n == 0:
        return (torch.empty(0, dtype=torch.int32, device=dev) if ids
                else None,
                torch.zeros(nparts, dtype=torch.int64, device=dev),
                [torch.zeros(out_rows, dtype=c.dtype, device=dev)
                 for c in cols])
    length_t = _length_tensor(length, dev)
    id_out = torch.empty(n, dtype=torch.int32, device=dev) if ids else None
    counts = torch.empty(nparts, dtype=torch.int64, device=dev)
    ctl = torch.zeros(plan["ctl_words"], dtype=torch.int64, device=dev)
    outs = [torch.empty(out_rows, dtype=c.dtype, device=dev) for c in cols]
    for j in range(plan["chunks"]):
        chunk = range(j * _PART_COLS, min((j + 1) * _PART_COLS, len(cols)))
        _launch("partition", n, _ptr(hashes), _ptr(length_t), nparts,
                _ptr(id_out), _ptr(counts), _ptr(ctl), plan["ctl_words"],
                plan["chunks"], j, out_rows, len(chunk),
                _arr(ctypes.c_int64, [_ptr(cols[i]) for i in chunk]),
                _arr(ctypes.c_int64, [_ptr(outs[i]) for i in chunk]),
                _arr(ctypes.c_int32, [cols[i].element_size()
                                      for i in chunk]),
                _stream())
    return id_out, counts, outs


def partition_plain(hashes, length, nparts: int, cols: list,
                    out_rows: Optional[int] = None, ids: bool = True):
    """Plain PyTorch version of `partition` (the ids by a mask of the low
    bits, a stable `torch.sort` of them, `bincount`, `index_select`)."""
    _check_parts(nparts)
    n = hashes.shape[0]
    dev = hashes.device
    out_rows = n if out_rows is None else out_rows
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    pid = torch.where(iota < _length_tensor(length, dev),
                      (hashes & (nparts - 1)).to(torch.int32),
                      torch.full_like(iota, nparts))
    order = torch.sort(pid, stable=True).indices
    counts = torch.bincount(pid.to(torch.int64),
                            minlength=nparts + 1)[:nparts]
    outs = []
    for c in cols:
        o = torch.zeros(out_rows, dtype=c.dtype, device=dev)
        o[:n] = c.index_select(0, order)
        outs.append(o)
    return pid if ids else None, counts, outs


# --------------------------------------------------------------------------
# segments
# --------------------------------------------------------------------------

_SEG_KEY_KINDS = {torch.int64: 0, torch.int32: 1, torch.float64: 2}
_SEG_MAX_KEYS = 16               # segments.cu MAX_KEYS
_SEG_MAX_TARGETS = 256           # segments.cu MAX_TARGETS
_SG_COLS = 32                    # segments.cu MAX_COLS: planes a launch
_SG_TILE = 4096                  # segments.cu STILE: rows a tile
_SG_WARPS = 8                    # segments.cu SWARPS
_SG_ZROWS = 4096                 # segments.cu ZROWS: slots a zero-tail item
_SG_TARGET_ROWS = 2048           # segments.cu CT x CR: seg_targets' rows a
                                 # block a round
_SG_TARGET_BLOCKS = 8            # segments.cu TBLOCKS: seg_targets blocks
_SG_SCATTER_BLOCKS = 2           # segments.cu SBLOCKS: scatter blocks a SM
_SG_CTL_HEAD = 1                 # segments.cu CTL_HEAD: the ticket
_SG_SBUF = 34848                 # segments.cu SBUF_BYTES
_SG_EPOCHS = (1 << 30) - 1       # segments.cu: epochs 1 .. 2^30 - 1
_SG_CTL: dict = {}               # (device type, index, stream) -> [int64
_SG_MU = threading.Lock()        # control words, last epoch]


def segments_plan(n: int, ndev: int, seg: int, n_cols: int) -> dict:
    """What `segments` launches for `n` rows into `ndev` targets of `seg`
    slots with `n_cols` columns, from the shapes alone (no sync): one
    scatter a chunk of 32 planes (each column's data and valid are two;
    one launch without columns, for the counts), each over the `tiles`
    4,096-row tiles and the `zero_items` chunks of 4,096 slots of the
    targets' zero tails, `scatter_blocks` blocks of `smem` bytes of
    dynamic shared memory; `ctl_words` int64 control words kept per
    stream (the ticket and a look-back word a (tile, target)). The
    targets alone (`segment_targets`) are one launch of
    `target_blocks` blocks."""
    chunks = max(1, -(-2 * n_cols // _SG_COLS))
    tiles = -(-n // _SG_TILE)
    zero_items = ndev * max(1, -(-seg // _SG_ZROWS))
    return {"launches": chunks, "chunks": chunks, "tiles": tiles,
            "zero_items": zero_items,
            "scatter_blocks": min(tiles + zero_items,
                                  _SG_SCATTER_BLOCKS * _SMS),
            "smem": _SG_SBUF + 3 * _SG_TILE + 4 * _SG_WARPS * ndev,
            "ctl_words": _SG_CTL_HEAD + tiles * ndev,
            "target_blocks": min(max(1, -(-n // _SG_TARGET_ROWS)),
                                 _SG_TARGET_BLOCKS * _SMS)}


def _seg_keys(keys: list) -> list:
    """The keys as the kernel reads them: int64, int32 or float64 (the
    kernel converts float64 as the reference's `astype(int64)` does);
    any other dtype is converted to int64 first, the same way."""
    from ydb_tpu_torch.ops.spill import as_int64
    out = []
    for d, v in keys:
        if d.dtype not in _SEG_KEY_KINDS:
            d = as_int64(d)
        out.append((d.contiguous(), None if v is None else v.contiguous()))
    return out


def _seg_launch(n: int, dev, keys: list, targets_in, targets_out, length,
                ndev: int, seg: int, counts, ovf, planes: list) -> None:
    """The launches of one segments call (`segments_plan`): one scatter a
    chunk of planes, the first also writing the counts and the flag; or,
    with `targets_out` and no counts, the targets alone. `planes`:
    [(source | None, output)]. A host length goes by value (copying it to
    the card would wait for the stream)."""
    plan = segments_plan(n, ndev, seg, len(planes) // 2)
    length_t, length_v = None, 0
    if isinstance(length, torch.Tensor):
        length_t = _length_tensor(length, dev)
    else:
        length_v = int(length)
    chunks = [planes[i:i + _SG_COLS]
              for i in range(0, len(planes), _SG_COLS)] or [[]]
    key = (dev.type, dev.index, _stream())
    with _SG_MU:
        # kept per stream, zeroed once: each call tags its look-back words
        # with a new epoch, and the kernel leaves the ticket zero
        ent = _SG_CTL.get(key)
        if ent is None or ent[0].numel() < plan["ctl_words"]:
            ent = _SG_CTL[key] = [torch.zeros(plan["ctl_words"],
                                              dtype=torch.int64, device=dev),
                                  0]
        ent[1] = ent[1] % _SG_EPOCHS + 1
        ctl, epoch = ent
        # a launch that failed may have left the ticket drawn: the next
        # call takes fresh words
        try:
            _seg_chunks(n, keys, targets_in, targets_out, length_t,
                        length_v, ndev, seg, ctl, plan["ctl_words"], epoch,
                        counts, ovf, chunks)
        except BaseException:
            _SG_CTL.pop(key, None)
            raise


def _seg_chunks(n, keys, targets_in, targets_out, length_t, length_v,
                ndev, seg, ctl, ctl_words, epoch, counts, ovf, chunks):
    for j, chunk in enumerate(chunks):
        _launch("segments", n, len(keys),
                _arr(ctypes.c_int64, [_ptr(d) for d, _v in keys]),
                _arr(ctypes.c_int64, [_ptr(v) or 0 for _d, v in keys]),
                _arr(ctypes.c_int32, [_SEG_KEY_KINDS[d.dtype]
                                      for d, _v in keys]),
                _ptr(targets_in), _ptr(targets_out), _ptr(length_t),
                length_v, ndev, seg, _ptr(ctl), ctl_words, epoch,
                _ptr(counts), _ptr(ovf), len(chunk),
                _arr(ctypes.c_int64, [_ptr(src) or 0 for src, _o in chunk]),
                _arr(ctypes.c_int64, [_ptr(o) for _s, o in chunk]),
                _arr(ctypes.c_int32, [o.element_size() for _s, o in chunk]),
                j, _stream())


def _seg_check(n: int, dev, keys: list, targets, ndev: int) -> None:
    if not 1 <= ndev <= _SEG_MAX_TARGETS:
        raise ValueError(f"{ndev} targets (1 to {_SEG_MAX_TARGETS})")
    if n >= 1 << 31:
        raise ValueError(f"{n} rows")
    if targets is not None:
        _check(targets, "targets", dev, n, (torch.int32,))
    elif not keys:
        raise ValueError("no keys")
    for i, (d, v) in enumerate(keys):
        _check(d, f"key {i}", dev, n, tuple(_SEG_KEY_KINDS))
        if v is not None:
            _check(v, f"key valid {i}", dev, n, (torch.bool,))


def segment_targets(keys: list, ndev: int) -> torch.Tensor:
    """The target of every row: `hash % ndev` as uint64, where the hash
    folds splitmix64 of each key (as int64; 0 where its valid is False)
    with hash_combine — the reference's `bucket_of`. `keys`: [(data,
    valid | None)]. Returns int32 (n,)."""
    n = keys[0][0].shape[0]
    dev = keys[0][0].device
    if dev.type != "cuda":
        return segment_targets_plain(keys, ndev)
    keys = _seg_keys(keys)
    _seg_check(n, dev, keys, None, ndev)
    if len(keys) > _SEG_MAX_KEYS:
        return wide_targets(keys, ndev, hash64, _MAX_HASH_COLS)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    _seg_launch(n, dev, keys, None, out, n, ndev, 0, None, None, [])
    return out


def segments(length, ndev: int, seg: int, cols: list, *,
             keys: Optional[list] = None,
             targets: Optional[torch.Tensor] = None):
    """The send segments of one shard's rows: row r < length goes to its
    target (`targets[r]`, or computed from `keys` as `segment_targets`
    does) at its rank among the earlier rows of that target, when the
    rank is below `seg`.

    `cols`: [(data, valid | None)], each (n,) of any element width.
    Returns (outs, counts, overflow): per column (data, valid), each
    (ndev, seg) — slot [t, j] holds the j-th row of target t for j <
    counts[t], and is zero (valid False) past it; a column without a
    valid gets True at its live slots —, int32 counts (ndev,) clamped to
    `seg`, and a 0-d bool: some target had more than `seg` rows. On the
    card: one launch up to 16 columns (`segments_plan`)."""
    ref = targets if targets is not None else keys[0][0]
    n = ref.shape[0]
    dev = ref.device
    if dev.type != "cuda":
        return segments_plain(length, ndev, seg, cols, keys=keys,
                              targets=targets)
    keys = [] if targets is not None else _seg_keys(keys)
    _seg_check(n, dev, keys, targets, ndev)
    if len(keys) > _SEG_MAX_KEYS:
        targets, keys = segment_targets(keys, ndev), []
    planes, outs = [], []
    for i, (d, v) in enumerate(cols):
        _check(d, f"column {i}", dev, n)
        if d.element_size() not in (1, 2, 4, 8):
            raise ValueError(f"column {i}: element size {d.element_size()}")
        if v is not None:
            _check(v, f"column valid {i}", dev, n, (torch.bool,))
        od = torch.empty(ndev * seg, dtype=d.dtype, device=dev)
        ov = torch.empty(ndev * seg, dtype=torch.bool, device=dev)
        planes += [(d, od), (v, ov)]
        outs.append((od.view(ndev, seg), ov.view(ndev, seg)))
    counts = torch.empty(ndev, dtype=torch.int32, device=dev)
    ovf = torch.empty((), dtype=torch.bool, device=dev)
    _seg_launch(n, dev, keys, targets, None, length, ndev, seg, counts, ovf,
                planes)
    return outs, counts, ovf


def umod64_plain(h: torch.Tensor, n: int) -> torch.Tensor:
    """`h % n` of int64 bits taken as uint64 (torch has no unsigned
    64-bit remainder): with h = 2q + b, q = h >>> 1 fits int64."""
    return ((_lsr(h, 1) % n) * 2 + (h & 1)) % n


def segment_targets_plain(keys: list, ndev: int) -> torch.Tensor:
    """Plain PyTorch version of `segment_targets` (the reference's
    `bucket_of`)."""
    from ydb_tpu_torch.ops.spill import as_int64
    h = None
    for d, v in keys:
        x = splitmix64_plain(as_int64(d))
        if v is not None:
            x = torch.where(v, x, torch.zeros_like(x))
        h = x if h is None else hash_combine_plain(h, x)
    return umod64_plain(h, ndev).to(torch.int32)


def segments_plain(length, ndev: int, seg: int, cols: list, *,
                   keys: Optional[list] = None,
                   targets: Optional[torch.Tensor] = None):
    """Plain PyTorch version of `segments`: the reference's formulation,
    one compaction of the live rows of each target into `seg` slots."""
    if targets is None:
        targets = segment_targets_plain(keys, ndev)
    n = targets.shape[0]
    dev = targets.device
    active = torch.arange(n, dtype=torch.int32, device=dev) \
        < _length_tensor(length, dev)
    flat = []
    for d, v in cols:
        flat += [d, v if v is not None
                 else torch.ones(n, dtype=torch.bool, device=dev)]
    per_t, counts, ovf = [], [], torch.zeros((), dtype=torch.bool,
                                            device=dev)
    for t in range(ndev):
        outs, live, new_len, o = compact_plain(
            flat, active & (targets == t), n, n, seg)
        per_t.append(outs)
        counts.append(new_len)
        ovf = ovf | o
    outs = []
    for i in range(len(cols)):
        outs.append((torch.stack([p[2 * i] for p in per_t]),
                     torch.stack([p[2 * i + 1] for p in per_t])))
    return outs, torch.stack(counts).to(torch.int32), ovf


# --------------------------------------------------------------------------
# quant: the DQ channel plane's int8 block codec
# --------------------------------------------------------------------------

QUANT_BLOCK = 128                # quant.cu QBLOCK
QUANT_NAN_CODE = -128            # outside the symmetric range ±127
_QUANT_DTYPES = {torch.float64: 0, torch.float32: 1}


def _misaligned(t: torch.Tensor, nbytes: int) -> bool:
    """Whether a tensor's data lies off an `nbytes` boundary of its
    storage (a view with a storage offset): a kernel's vector accesses
    cannot take it. (The launchers check the pointers themselves too.)"""
    return (t.storage_offset() * t.element_size()) % nbytes != 0


def quantize_blocked(x: torch.Tensor):
    """Per-block symmetric int8 codes of a float tensor whose last axis
    is a multiple of QUANT_BLOCK: `(codes int8 of x's shape, scales
    float32 of shape x.shape[:-1] + (last // QUANT_BLOCK,))`. NaN
    encodes as QUANT_NAN_CODE; a
    block's scale is its NaN-masked max-abs over 127 (1 for an all-zero
    block)."""
    if x.device.type != "cuda":
        return quantize_blocked_plain(x)
    if x.dtype not in _QUANT_DTYPES:
        raise ValueError(f"dtype {x.dtype} not in {tuple(_QUANT_DTYPES)}")
    if x.dim() < 1 or x.shape[-1] % QUANT_BLOCK:
        raise ValueError(f"shape {tuple(x.shape)}: last axis not a multiple "
                         f"of {QUANT_BLOCK}")
    if not x.is_contiguous():
        raise ValueError("x: not contiguous")
    if _misaligned(x, 16):
        raise ValueError(f"x: storage offset {x.storage_offset()} is off "
                         "the 16-byte lines the kernel loads (pass a copy)")
    n = x.numel()
    codes = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty(x.shape[:-1] + (x.shape[-1] // QUANT_BLOCK,),
                         dtype=torch.float32, device=x.device)
    _launch("quantize_blocked", n, _QUANT_DTYPES[x.dtype], _ptr(x),
            _ptr(codes), _ptr(scales), _stream())
    return codes, scales


def quantize_blocked_plain(x: torch.Tensor):
    """Plain PyTorch version of `quantize_blocked` (the reference's jnp
    formulation; a NaN quotient, x = +-inf over an inf scale, becomes 0
    as XLA's float -> int8 conversion makes it)."""
    shape = x.shape
    xb = x.reshape(shape[:-1] + (shape[-1] // QUANT_BLOCK, QUANT_BLOCK))
    nan = torch.isnan(xb)
    mag = torch.where(nan, torch.zeros_like(xb), xb.abs()).amax(dim=-1)
    # a tensor divisor: torch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the IEEE quotient
    scale = torch.where(mag > 0, mag / torch.full_like(mag, 127.0),
                        torch.ones_like(mag)).to(torch.float32)
    q = torch.round(xb / scale[..., None])
    q = torch.where(torch.isnan(q), torch.zeros_like(q),
                    q.clamp(-127, 127))
    q = torch.where(nan, torch.full_like(q, QUANT_NAN_CODE), q)
    return q.to(torch.int8).reshape(shape), scale


def dequantize_blocked(codes: torch.Tensor, scales: torch.Tensor,
                       dtype) -> torch.Tensor:
    """Inverse of `quantize_blocked`: `codes * scale` in `dtype` (a
    torch float dtype) per value, NaN where the code is QUANT_NAN_CODE."""
    if codes.device.type != "cuda":
        return dequantize_blocked_plain(codes, scales, dtype)
    if dtype not in _QUANT_DTYPES:
        raise ValueError(f"dtype {dtype} not in {tuple(_QUANT_DTYPES)}")
    want = codes.shape[:-1] + (codes.shape[-1] // QUANT_BLOCK,) \
        if codes.dim() else None
    if codes.dtype != torch.int8 or codes.dim() < 1 \
            or codes.shape[-1] % QUANT_BLOCK:
        raise ValueError(f"codes: {codes.dtype} {tuple(codes.shape)}")
    if scales.dtype != torch.float32 or tuple(scales.shape) != tuple(want) \
            or scales.device != codes.device:
        raise ValueError(f"scales: {scales.dtype} {tuple(scales.shape)} on "
                         f"{scales.device}, expected float32 {tuple(want)}")
    if not (codes.is_contiguous() and scales.is_contiguous()):
        raise ValueError("codes or scales: not contiguous")
    out = torch.empty(codes.shape, dtype=dtype, device=codes.device)
    _launch("dequantize_blocked", codes.numel(), _QUANT_DTYPES[dtype],
            _ptr(codes), _ptr(scales), _ptr(out), _stream())
    return out


def dequantize_blocked_plain(codes: torch.Tensor, scales: torch.Tensor,
                             dtype) -> torch.Tensor:
    """Plain PyTorch version of `dequantize_blocked`."""
    shape = codes.shape
    qb = codes.reshape(shape[:-1] + (shape[-1] // QUANT_BLOCK, QUANT_BLOCK))
    x = qb.to(dtype) * scales[..., None].to(dtype)
    x = torch.where(qb == QUANT_NAN_CODE, torch.full_like(x, float("nan")),
                    x)
    return x.reshape(shape)


# --------------------------------------------------------------------------
# dq_counts: the DQ count exchange and its bucket plane
# --------------------------------------------------------------------------

_DQ_MAX_TARGETS = 1024           # dq_counts.cu MAX_TARGETS
_PLANE_THREADS = 256             # dq_counts.cu PLANE_THREADS
_PLANE_ROWS = 8                  # dq_counts.cu PLANE_ROWS: 4 row pairs
_COUNT_THREADS = 256             # dq_counts.cu COUNT_THREADS
_COUNT_LOADS = 4                 # dq_counts.cu COUNT_LOADS: int4 a thread
_COUNT_SM_BLOCKS = 8             # dq_counts.cu COUNT_SM_BLOCKS
_REG_TARGETS = 4                 # dq_counts.cu REG_TARGETS


def bucket_plane_plan(nprod: int, cap: int) -> dict:
    """The bucket plane's launch: a grid of (row tiles, producers),
    PLANE_ROWS rows a thread; producer p's pairs start at its first even
    flat row (`heads` rows before it go alone)."""
    tile = _PLANE_THREADS * _PLANE_ROWS
    return {"grid": (-(-cap // tile), nprod), "threads": _PLANE_THREADS,
            "rows_per_thread": _PLANE_ROWS, "tile": tile,
            "heads": [(p * cap) & 1 for p in range(nprod)], "launches": 1}


def dq_bucket_plane(keys: torch.Tensor, valid: Optional[torch.Tensor],
                    lengths: torch.Tensor, ndev: int,
                    lut: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The target of every row of a [nprod, cap] key plane: -1 past its
    producer's length or where `valid` is False; else, for int64 keys,
    splitmix64 of the key mod `ndev` as uint64, or, with `lut` (int32
    dictionary codes as keys), lut[clamp(code, 0, len(lut) - 1)].
    Returns int32 [nprod, cap]."""
    dev = keys.device
    if dev.type != "cuda":
        return dq_bucket_plane_plain(keys, valid, lengths, ndev, lut)
    if keys.dim() != 2 or not keys.is_contiguous():
        raise ValueError(f"keys: shape {tuple(keys.shape)}, expected a "
                         "contiguous [nprod, cap]")
    nprod, cap = keys.shape
    if lut is None:
        if keys.dtype != torch.int64:
            raise ValueError(f"keys: dtype {keys.dtype}, expected int64")
    else:
        if keys.dtype != torch.int32:
            raise ValueError(f"codes: dtype {keys.dtype}, expected int32")
        _check(lut, "lut", dev, None, (torch.int32,))
        if lut.shape[0] < 1:
            raise ValueError("lut: empty")
    if valid is not None and (tuple(valid.shape) != (nprod, cap)
                              or valid.dtype != torch.bool
                              or valid.device != dev
                              or not valid.is_contiguous()):
        raise ValueError(f"valid: {valid.dtype} {tuple(valid.shape)}")
    _check(lengths, "lengths", dev, nprod, (torch.int32,))
    if not 1 <= ndev <= _DQ_MAX_TARGETS:
        raise ValueError(f"{ndev} targets (1 to {_DQ_MAX_TARGETS})")
    if not 1 <= nprod <= 65535:
        raise ValueError(f"{nprod} producers (1 to 65535)")
    # a pair of keys is one 16-byte (int64) or 8-byte (codes) load, a
    # pair of valid bytes one 2-byte load
    for t, what, a in ((keys, "keys", 16 if lut is None else 8),
                       (valid, "valid", 2)):
        if t is not None and _misaligned(t, a):
            raise ValueError(f"{what}: storage offset {t.storage_offset()}"
                             f" is off the {a}-byte pairs the kernel "
                             "loads (pass a copy)")
    plane = torch.empty((nprod, cap), dtype=torch.int32, device=dev)
    _launch("dq_bucket_plane", cap, nprod, 0 if lut is None else 1,
            _ptr(keys), _ptr(valid), _ptr(lengths), _ptr(lut),
            0 if lut is None else lut.shape[0], ndev, _ptr(plane),
            _stream())
    return plane


def dq_bucket_plane_plain(keys, valid, lengths, ndev: int, lut=None):
    """Plain PyTorch version of `dq_bucket_plane`."""
    nprod, cap = keys.shape
    if lut is None:
        b = umod64_plain(splitmix64_plain(keys.to(torch.int64)), ndev)
    else:
        b = lut.to(torch.int64)[keys.to(torch.int64).clamp(
            0, lut.shape[0] - 1)]
    iota = torch.arange(cap, dtype=torch.int64, device=keys.device)
    active = iota[None, :] < lengths.to(torch.int64)[:, None]
    if valid is not None:
        active = active & valid
    return torch.where(active, b, torch.full_like(b, -1)).to(torch.int32)


def dq_counts_plan(nch: int, nprod: int, cap: int, ndev: int) -> dict:
    """The count exchange's one launch, from the shapes alone: a grid of
    (`blocks`, nprod, nch); a (channel, producer) row's `steps` of
    COUNT_THREADS x COUNT_LOADS 16-byte vectors go round its blocks,
    `steps_per_block` at most each, with at most COUNT_SM_BLOCKS blocks
    a SM over the launch; `mode`: "registers" (REG_TARGETS counters a
    thread, ndev <= 4) or "shared" (a histogram); `part_words` int32
    partials (ndev a block) and `tickets` words (one a row) kept zero
    per stream."""
    steps = max(1, -(-cap // (4 * _COUNT_THREADS * _COUNT_LOADS)))
    most = max(1, _COUNT_SM_BLOCKS * _SMS // max(1, nch * nprod))
    per = -(-steps // most)
    blocks = -(-steps // per)
    mode = "registers" if ndev <= _REG_TARGETS else "shared"
    return {"grid": (blocks, nprod, nch), "blocks": blocks, "steps": steps,
            "steps_per_block": per, "mode": mode,
            "part_words": nch * nprod * ndev * blocks,
            "tickets": nch * nprod, "launches": 1}


def dq_counts(planes: torch.Tensor, ndev: int) -> torch.Tensor:
    """Per (channel, producer, target) live-row counts of [nch, nprod,
    cap] int32 bucket planes: counts[c, p, d] = number of rows r with
    planes[c, p, r] == d, for d < ndev (-1 counts nowhere). Returns int32
    [nch, nprod, ndev], from one launch (`dq_counts_plan`)."""
    dev = planes.device
    if dev.type != "cuda":
        return dq_counts_plain(planes, ndev)
    if planes.dim() != 3 or planes.dtype != torch.int32 \
            or not planes.is_contiguous():
        raise ValueError(f"planes: {planes.dtype} {tuple(planes.shape)}, "
                         "expected a contiguous int32 [nch, nprod, cap]")
    nch, nprod, cap = planes.shape
    if not 1 <= ndev <= _DQ_MAX_TARGETS:
        raise ValueError(f"{ndev} targets (1 to {_DQ_MAX_TARGETS})")
    if not (nch <= 65535 and nprod <= 65535):
        raise ValueError(f"{nch} channels, {nprod} producers (to 65535)")
    counts = torch.empty((nch, nprod, ndev), dtype=torch.int32, device=dev)
    if nch and nprod:
        plan = dq_counts_plan(nch, nprod, cap, ndev)
        part = torch.empty(plan["part_words"], dtype=torch.int32,
                           device=dev)
        _ticket_launch("dq_counts", dev, cap, nch, nprod, ndev,
                       plan["blocks"], _ptr(planes), _ptr(part),
                       _ptr(_ticket(dev, plan["tickets"])), _ptr(counts),
                       _stream())
    return counts


def dq_counts_plain(planes: torch.Tensor, ndev: int) -> torch.Tensor:
    """Plain PyTorch version of `dq_counts` (the reference's equality
    reduction, one target at a time)."""
    return torch.stack([(planes == d).sum(dim=2) for d in range(ndev)],
                       dim=2).to(torch.int32)
