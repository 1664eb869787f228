"""Chip smoke test of the PyTorch/CUDA port (``ydb_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--sf 1] [--profile]

Phases, each printing its own line(s):

1. the card's name and power limit, as ``nvidia-smi`` prints them;
2. the build of the thirteen CUDA kernel libraries from
   ``ydb_tpu_torch/ops/cuda/csrc`` (one ``nvcc`` per source, in
   parallel), with its seconds and ``-Xptxas -v``'s registers, stack
   frame and spills of every ``segment_agg``, ``bucket_sort``, ``sort``,
   ``window_scan``, ``bucket_agg``, ``compact`` and ``expand`` kernel (a
   stack frame or a spill in ``segment_agg``, ``sort``, ``window_scan``
   or the kernels of K2, K3 and K2/K3 xB, K6 xB and K8's counts fails the
   run), then
   NVRTC's version and the seconds of one trivial K1 stage (its first
   build);
3. generation of TPC-H at ``--sf``, TPC-DS at SF1 and ClickBench's hits
   at 1,000,000 rows, each loaded into its own ``QueryEngine()`` (no
   device argument: it must land on ``cuda``);
4. the kernel phase: each kernel against its plain PyTorch version on the
   card, on seeded random inputs at the shapes the queries give it.
   ``bucket_agg``, ``compact``, ``probe`` and ``sort`` at
   Q1/Q6/Q14's shapes (nulls, an all-null bucket, LUT misses and a
   forced compact overflow included), ``bucket_agg`` (K3, the keyed
   member kernel at one member) at Q1's shape called twice and held bit
   for bit, at an odd row count with unaligned inputs, and at 512
   buckets and 16 aggregates (timed beside a floor: bincounts of its sums
   and counts), and each wrapper's multi-launch form; K2, the keyless
   ``bucket_agg_keyless`` (one launch): every function with nulls, the
   streaming body at one to four float and integer sums and counts, odd
   row counts and an unaligned column, and Q14's two float64 sums timed
   against ``sum(0)`` of the pre-masked matrix, called twice and held
   bit for bit (the ``bucket_agg_keyless`` row); F1, more key words than
   a kernel takes in one launch: ``sort_perm`` at 17 and 33 words (2^20
   and 5,000 rows, twice, bit for bit), ``segment_agg`` and its member
   form at 17 and 33, ``window_scan`` at 20 words and ``segments`` at 20
   keys, each exactly against its plain version, and after the K1 phase
   a GROUP BY over lineitem's 16 columns and the same columns under
   ORDER BY ... LIMIT on the card, each equal to the pandas oracle and
   to the same catalog's plain path (the CPU);
   ``sort`` at scan capacity (the sorted group-by's sort; two calls
   bit for bit equal), at n = 0, 1, 1,023, 1,024, 1,025 and 8,193, with
   every word equal, 16 words, one live bit, words >= 2^63 and the
   member form at B = 8 over 2^20 rows (each twice, bit for bit);
   ``segment_agg`` at q18's subquery shape (timed), q3's (a filter,
   groups of at most 7 rows, an output bound), one group holding half
   the rows, nullable int keys, NaN and -0.0 float keys with every
   aggregate function, more aggregates than one launch takes and 0
   rows, each called twice and the two calls held bit for bit equal,
   and q18's groups moved 13 rows on, whose sums must keep their bits;
   ``bucket_perm`` (K4's counting sort) exactly at 60,000 random
   buckets, 65,535 with half the rows in one, 2% active, 0 rows and
   B = 8 members (a shared id over the union of their masks, and
   per-member ids), then the
   medium-domain lane (``bucket_perm`` + ``segment_agg``, 60,000
   buckets) timed against the ``sort_perm`` composition it replaced,
   bit for bit equal to it, and one ``scatter_reduce``; ``hash64``
   over two int64 columns at lineitem's rows (half the hashes >=
   2^63); a probe of u64 keys >= 2^63; ``probe_checks`` (the sorted-keys
   search at every kcap = 2^k, k = 0 .. 21, int64 and float64 keys with
   NaN, ±inf and -0.0, all five kinds, NOT IN, 17 payloads, offset views,
   sorted keys off a 16-byte boundary, 1 to 100,003 rows, 0 rows; two
   calls bit for bit); ``expand_counts`` (one launch)
   and ``expand_gather`` at TPC-DS ds25's shape (timed), with one key
   matching 100,000 build rows (timed, the counts beside two
   ``searchsorted``), LEFT with NULL probe keys, float keys, 0, 1,
   2,047, 2,049 and 333,333 probes at a shortened length, a float skew
   and two calls, each bit for bit against the plain version; ``sort`` on
   random keys: the window lane's store_sales partition sort (the
   63-bit partition hash and the date word, timed against a stable
   ``sort`` of the hash word); ``window_scan``
   over store_sales at SF1 by item and date (timed), at ds89's frame
   (timed), one partition, one row per partition, NULL values, its
   multi-launch form and one partition of 2^22 + 333 rows (timed), each
   called twice and held bit for bit equal; K1 (the generated expression-stage kernels,
   ``ydb_tpu_torch/ops/k1.py``, built by NVRTC at first use) on every
   stage q1, q6 and q19 hand over on the fused path, q19's batched
   stages at B = 8 with per-member params, and the op sweep of
   ``ydb_tpu_torch/bench/k1_sweep.py`` (every op of ``ops/kernels.py``
   over each storage dtype it takes, NULLs, NaN, +-inf, -0.0, zero
   divisors, codes of -1, a null_neg LUT, hash inputs >= 2^63) at 2^20
   and 0 rows: outputs equal in dtype, validity presence and shape,
   ints and masks exactly, floats bit for bit (any NaN for any NaN)
   and held at rtol 1e-9; each stage's kernel and plain ms, launches and
   byte bound, and per query the sum beside ``k1_bound_bytes``. Ints, masks, counts, row maps and permutations
   must match exactly, float sums to rtol 1e-9 (another summation
   order). Times: device time between CUDA events (a spin kernel ahead
   hides the host's launch work), median of 15 calls after warm-up, for
   the kernel, its plain version and one PyTorch library call computing
   the same function (or, where noted, a floor of it) where there is
   one; the bound is the bytes of the distinct input and output tensors
   over 3.35 TB/s (for ``expand_gather``: the rows the outputs take);
5. the slice phase, path by path (``PATHS``), through
   ``QueryEngine.query``: all 22 TPC-H queries with ``YDB_TPU_LATE_MAT``
   on, and Q1 and Q14 again with it off, on the fused path; 36 TPC-DS
   queries at SF1 (the 25 the third slice opened and the reference
   bench's subset), the ten windowed ones again on the device window
   lane, and a window query over all of store_sales; the other 37 TPC-DS
   queries once each, cold (``TPCDS_REST``; every TPC-DS oracle answer
   is made by ``TPCDS_ORACLE_WORKERS`` worker processes while the card
   works on the earlier phases); the 43 ClickBench
   queries; and TPC-H again through a second engine over the same data
   whose device budgets are the defaults over 100 (``BEYOND_BUDGETS``),
   so scans stream through the tiled lane, large build sides partition
   into GraceJoin builds and partial aggregates spill to host
   partitions: all 22 queries and the reference tiled-lane test's two
   extra ones, each line with the query's spilled rows, tiles and
   partition counts (``LaneRecorder``); then the mesh path: TPC-H at
   ``--sf`` loaded with 4 shards through ``QueryEngine(mesh=make_mesh(4,
   device="cuda:0"))`` (a mesh that lists the card once per shard, so
   every shard's kernels run on it and an exchange is a copy within its
   memory): all 22 queries on the ``distributed`` and ``distributed-map``
   lanes, and the queries whose last join the shuffle join accepts again
   through an engine over the same catalog whose broadcast budget is 1
   (``distributed-shuffle-join``), each line with the device ms of the
   ``segments`` calls and of the exchanges (CUDA events around each
   call, ``MeshRecorder``) and the exchanges' byte bound (every stacked
   segment read and written once); then TPC-H q10 at SF 0.4 through a
   fourth engine, whose 60,000 customer names take the medium-domain
   lane (``MediumLaneRecorder``: the lane must run, ``bucket_perm``
   must launch). Every answer must equal its
   pandas oracle (``ydb_tpu_torch/bench/{tpch,tpcds,clickbench}_oracle.py``;
   rtol 1e-9 for floats, exact otherwise, row order included where the
   query fixes it), queries whose path a slice fixes must take it
   (``EXPECT_PATH``), and each path's kernels must have launched in that
   path's own run (the counters are reset just before it and read just
   after; K1 launches on every path); each query's line adds the K1
   builds (NVRTC compilations) its runs made and their milliseconds, each
   path's launch line their totals;
6. ``partition`` against its plain version at the largest spill feed of
   the beyond-budget path (timed, no ids, as the paths call it), at a
   GraceJoin routing of lineitem's superblock rows by l_orderkey into 8
   partitions (timed, no ids, its own kernel row with its launches a
   call and a bound that counts the zero tail), and at 1 and 256
   partitions, 0 live rows, nullable, float (NaN, ±inf, -0.0) and
   two-column keys, hashes >= 2^63, 36 columns and 0 rows; then
   ``partition_checks``: the length at 0, 1, 4,095, 4,096, 4,097 and n,
   1, 2, 8 and 256 partitions, 33 columns of widths 8, 4, 2 and 1,
   out_rows > n, ids on and off, views off a 16-byte boundary, 2^20 +
   333 rows into 256 (ids, counts and moved columns bit for bit, two
   calls bit for bit); then ``probe`` at q9's sorted-keys probe of
   partsupp (recorded from one q9 run: its key count and kcap printed;
   timed beside ``searchsorted``, its own kernel row);
7. the batched serving lane's member-axis entries, before the paths
   (``batched_kernel_phase``): ``bucket_agg_batched`` at Q1's shape with
   8 members' masks from 8 DELTAs (timed), keyless at Q6's through the
   streaming member body (timed, the ``bucket_agg_keyless_batched``
   row), at 512 buckets x 16 aggregates (timed), every function,
   per-member ids and values; member b bit for bit a single
   ``bucket_agg`` over its mask at Q1 and 512 x 16, two calls bit for
   bit (keyed and keyless), the streaming body at 0 to 4 sums with
   counts, unaligned masks and columns (the keyed body with one
   bucket), and B = 1, 3, 8, 32 at an odd row count with shared and
   per-member ids and keyless; ``segment_agg_batched`` at the batch c40
   sends over the 1M hits rows (timed, with its kernels counted in a
   CUDA graph capture: the fold, the fix and the member compaction,
   and no other device work), with six aggregates (timed) and ten (two
   chunks), two calls bit for bit; ``compact_batched`` at the point-lookup batch
   over orders' capacity (timed) and at 8 top-k masks over lineitem
   (timed), with no mask, a shared mask and more columns than one
   launch takes; B = 1, identical members, an empty member and B = 64.
   ``compact_batched`` is held on its counts and on every member's live
   prefix (the rest of its outputs is undefined), and its lines log the
   bytes the wrapper zero-fills beyond the kernel (``zero_fill_bytes``,
   measured: it must be 0). Each line also times B launches of the
   single-query kernel; the bound is the single kernel's byte count
   extended by the member axis, a shared input counted once;
8. the batched serving path, after the others (``serving_phase``): per
   template of ``ydb_tpu_torch/bench/serving.py`` (TPC-H Q1, Q6, Q12,
   Q14, Q19 and Q3 with qgen parameters, 64 point lookups of orders,
   ClickBench c36, c37, c40, c42), B client threads released together
   through an engine with ``YDB_TPU_BATCH_WINDOW=500`` and through the
   lane-off engine over the same catalog: every member equal to the
   lane-off answer, the validation member to its oracle, the batched
   templates coalesced (Q3's literals sit on its build sides, so it
   runs as singles), wrapper calls per batch equal at B = 2 and B = 8
   (a sort of B x cap rows sorts more rows inside its one call);
   the storm walls with the lane on and off (the lane-on storm after one
   untimed storm, so that the batched stages' K1 builds fall outside
   it) and one traced batch's device time.

9. ``segments`` (K15a: the send segments of a mesh exchange) against its
   plain version at the largest probe-row routing of the shuffle join
   and at q18's partial aggregate (both timed, both table rows), both
   recorded on the mesh path, and at 3 and 8 targets, a clamped segment
   (overflow), 0 live rows, int32, float (NaN, ±inf, out of range) and
   three nullable keys, given targets, the targets alone and 40 columns:
   counts, the overflow flag and every slot bit for bit; the library
   time is a floor (a stable sort of the targets and one index_select
   per column). At the two recorded shapes the kernels of a call are
   counted in a CUDA graph capture: the scatter, and no other device
   work.

10. the DQ path, after the serving path (``dq_phase``): TPC-H at
    ``--sf`` over 4 worker engines (``QueryEngine()``) filled by
    ``ydb_tpu_torch/bench/cluster_load.py`` (lineitem and orders split
    by the reference router's INSERT rule, the other six tables
    replicated), through ``ShardedCluster.query`` as DQ stage graphs:
    the 8 queries whose graphs run (q1, q3, q5, q6, q10, q12, q14, q19)
    equal their oracle, the 14 others raise ``ClusterError`` (11 do not
    lower; q7, q8 and q9 lower and fail in their join stage, as in the
    reference), the shuffle queries' edges ride the ICI plane
    (``dq/ici_bytes`` grows, ``dq/channel_bytes`` does not); q3, q10
    and q12 again on ``YDB_TPU_DQ_PLANE=host``, byte-equal; the quant
    pass (``YDB_TPU_DQ_QUANT=1``) on the answered shuffle queries as
    full group-bys: keys and counts exact, revenue within 2e-2,
    ``dq/quant_bytes_saved`` > 0 and q12's o_orderpriority refused; a
    hand-built Broadcast ICI graph and a stage with two ICI hash-shuffle
    outputs (the batched count exchange). Each query line gives its
    cold and warm walls, ICI bytes, segment sizes, padding efficiency
    and the device ms of the count exchange, the segments, the codec,
    the exchange and the compaction (``DqRecorder``). Then
    ``quantize_blocked``, ``dequantize_blocked``, ``dq_bucket_plane``
    and ``dq_counts`` against their plain versions at the largest calls
    of the path (timed) and on NaN, +-inf, all-zero blocks, ties,
    float32, float64, 0 rows and planes with -1 rows, bit for bit.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero without it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
RTOL = 1e-9


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg) -> None:
    """A check that holds under ``python -O`` too."""
    if not cond:
        raise AssertionError(msg)


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------


SPIN_CYCLES = 20_000_000           # ~10 ms: outlasts any wrapper's host work


def time_ms(fn, iters: int = 15, warmup: int = 3) -> float:
    """Median per-call device time: CUDA events around each call, with a
    spin kernel queued ahead of the first event, so the host work of the
    wrapper (checks, allocations, launches) is done before the card
    reaches the events and they bracket the device work alone."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def distinct_bytes(tensors) -> int:
    """Bytes of the distinct tensors among `tensors` (None skipped): a
    tensor that several operands share is read once."""
    seen = {}
    for t in tensors:
        if t is not None:
            seen[t.data_ptr()] = t.numel() * t.element_size()
    return sum(seen.values())


def agg_bytes(kid, nb: int, active, aggs) -> int:
    """bucket_agg's distinct input bytes plus its outputs (a value and a
    count per aggregate and bucket, a row count per bucket)."""
    ins = [kid, active] + [t for (_f, d, v, _u) in aggs for t in (d, v)]
    return distinct_bytes(ins) + nb * 8 * (2 * len(aggs) + 1)


def check_bucket_agg(B, kid, nb: int, active, aggs, sync, tag) -> float:
    """bucket_agg against its plain version: counts, present rows and
    integer results exactly, float sums to RTOL. Returns the largest
    absolute difference of a float sum."""
    import torch
    kv, kc, kp = B.bucket_agg(kid, nb, active, aggs)
    pv, pc, pp = B.bucket_agg_plain(kid, nb, active, aggs)
    sync()
    check(torch.equal(kp, pp), f"bucket_agg {tag} present")
    err = 0.0
    for i, (f, d, _v, _u) in enumerate(aggs):
        check(torch.equal(kc[i], pc[i]), f"bucket_agg {tag} count {i}")
        if f == "sum" and d.dtype == torch.float64:
            torch.testing.assert_close(kv[i], pv[i], rtol=RTOL, atol=0)
            err = max(err, float((kv[i] - pv[i]).abs().max()))
        else:
            check(torch.equal(kv[i], pv[i]), f"bucket_agg {tag} {f} {i}")
    return err


# --------------------------------------------------------------------------
# kernel phase
# --------------------------------------------------------------------------


def kernel_phase(B, n: int, q6_compact_cap: int, n_part: int,
                 lut_span: int, device: str = "cuda") -> list:
    """Each kernel (bindings module `B`) vs its plain version at the
    slice's shapes."""
    import torch
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    rows = []

    def sync():
        # a fault inside a kernel surfaces here, where it happened
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def rand(shape, dtype=torch.float64):
        return torch.rand(shape, generator=g, device=dev, dtype=dtype)

    def randint(lo, hi, shape, dtype=torch.int64):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=dtype)

    # -- bucket_agg at Q1's partial shape and skew: n rows, 12 buckets
    #    ((l_returnflag, l_linestatus) with their NULL slots), of which
    #    TPC-H fills four with about 49%, 25%, 25% and 0.7% of the rows;
    #    the 10 kernel aggregates Q1 asks for (7 float64 sums, 3 counts,
    #    no NULLs: lineitem's columns are NOT NULL; count(*) is the
    #    per-bucket row count the kernel always returns)
    u = rand((n,))
    kid = torch.where(u < 0.49, 10, torch.where(
        u < 0.74, 5, torch.where(u < 0.993, 7, 6))).to(torch.int32)
    active = rand((n,)) < 0.98
    aggs = [("sum", rand((n,)) * 1e5, None, False) for _ in range(7)] \
        + [("count", None, None, False) for _ in range(3)]
    run_k = lambda: B.bucket_agg(kid, 12, active, aggs)           # noqa: E731
    run_p = lambda: B.bucket_agg_plain(kid, 12, active, aggs)     # noqa: E731
    err = check_bucket_agg(B, kid, 12, active, aggs, sync, "Q1")
    # the keyed body (bucket_agg_members at one member): two calls bit
    # for bit; an odd row count, and unaligned ids, mask and columns
    first = B.bucket_agg(kid, 12, active, aggs)
    again = B.bucket_agg(kid, 12, active, aggs)
    sync()
    check(same_bits(list(first[0]) + list(first[1]) + [first[2]],
                    list(again[0]) + list(again[1]) + [again[2]]),
          "bucket_agg Q1: two calls differ")
    m = n - 333
    check_bucket_agg(B, kid[1:m + 1], 12, active[1:m + 1],
                     [(f, None if d is None else d[1:m + 1], v, u)
                      for (f, d, v, u) in aggs], sync, "Q1 odd unaligned")
    # every func on the same rows with NULLs, bucket 6 all NULL, checked
    # (not timed): float sums, counts, min / max / first, integer sums,
    # signed and unsigned min / max
    v = rand((n,)) > 0.05
    v[kid == 6] = False
    extras = [("sum", aggs[0][1], v, False), ("count", None, v, False),
              ("min", aggs[0][1], v, False), ("max", aggs[1][1], v, False),
              ("first", None, v, False),
              ("sum", randint(-(1 << 40), 1 << 40, (n,)), v, False),
              ("min", randint(-(1 << 62), 1 << 62, (n,)), None, False),
              ("max", randint(-(1 << 62), 1 << 62, (n,)), v, True),
              ("min", randint(-(1 << 62), 1 << 62, (n,)), None, True)]
    check_bucket_agg(B, kid, 12, active, extras, sync, "funcs")
    kid_l = torch.where(active, kid.to(torch.int64),
                        torch.full_like(kid, 12, dtype=torch.int64))
    stacked = torch.stack(
        [torch.where(active if v is None else (active & v), d, 0.0)
         for (f, d, v, _u) in aggs if f == "sum"]
        + [active.to(torch.float64) for (f, *_r) in aggs if f == "count"],
        dim=1)
    def lib():
        return torch.zeros(13, stacked.shape[1], dtype=torch.float64,
                           device=dev).index_add_(0, kid_l, stacked)
    rows.append(dict(
        name="bucket_agg", route="cuda",
        source="ydb_tpu_torch/ops/cuda/csrc/bucket_agg.cu",
        replaces="ydb_tpu/ops/xla_exec.py:352",
        shape=f"n={n} nb=12 aggs={len(aggs)} (Q1 partial)",
        max_abs_err=err, ms=time_ms(run_k), plain_ms=time_ms(run_p),
        library_ms=time_ms(lib),
        bound_ms=bound_ms(agg_bytes(kid, 12, active, aggs)),
        bound_by="bytes"))

    # -- bucket_agg at the most the small-domain lane routes to it:
    #    512 buckets (a few empty), 16 aggregates, n rows; checked and
    #    timed, printed on a line of its own
    kid5 = randint(0, 512, (n,), torch.int32)
    kid5[(kid5 % 97) == 5] = 4                 # buckets 5, 102, ... empty
    wide = []
    for a in range(16):
        f = ("sum", "sum", "count", "min", "max", "first")[a % 6]
        d = None if f in ("count", "first") else (
            rand((n,)) * 1e5 if a % 4 else randint(-(1 << 40), 1 << 40,
                                                   (n,)))
        wide.append((f, d, rand((n,)) > 0.05 if a % 3 else None, False))
    check_bucket_agg(B, kid5, 512, active, wide, sync, "nb=512")
    wide_bound = bound_ms(agg_bytes(kid5, 512, active, wide))
    kid5_l = torch.where(active, kid5.to(torch.int64), 512)

    def lib_512():
        # a bincount per sum and per count over the bucket ids (inactive
        # rows and NULLs in a dump bin): min, max and first have none,
        # so this is a floor of the library's time
        out = []
        for f, d, v, _u in wide:
            if f == "sum":
                w = d.to(torch.float64) if v is None \
                    else torch.where(v, d.to(torch.float64), 0.0)
                out.append(torch.bincount(kid5_l, weights=w, minlength=513))
            elif f == "count":
                out.append(torch.bincount(
                    kid5_l if v is None else torch.where(v, kid5_l, 512),
                    minlength=513))
        return out
    k5 = time_ms(lambda: B.bucket_agg(kid5, 512, active, wide))
    lib5 = time_ms(lib_512)
    log(f"kernel bucket_agg at nb=512: n={n} aggs={len(wide)} "
        f"kernel_ms={k5:.4f} "
        f"plain_ms={time_ms(lambda: B.bucket_agg_plain(kid5, 512, active, wide)):.4f} "
        f"library_ms={lib5:.4f} (bincounts of the sums and counts only, "
        f"a floor) kernel/library={k5 / lib5:.3f} "
        f"bound_us={wide_bound * 1e3:.2f} (bytes) "
        f"kernel/bound={k5 / wide_bound:.3f}")

    # -- K2, keyless bucket_agg (Q6, Q14: no ids, one bucket; one launch,
    #    bucket_agg_keyless): every func with nulls checked (the folding
    #    body), the streaming body at one to four sums (float64, int64,
    #    uint64) and counts, odd row counts and an unaligned column (the
    #    folding body again); then Q14's two float64 sums over the whole
    #    scan (late materialization off) timed and called twice, bit for
    #    bit, printed on a line of its own and as K2's row
    check_bucket_agg(B, None, 1, active, wide, sync, "keyless")
    ints = randint(-(1 << 40), 1 << 40, (n,))
    streams = [aggs[:1], aggs[:2] + [("count", None, None, False)],
               aggs[:3], [("sum", ints, None, False)] + aggs[:2]
               + [("sum", ints, None, True)], [("count", None, None, False)],
               []]
    for i, spec in enumerate(streams):
        check_bucket_agg(B, None, 1, active, spec, sync, f"keyless stream {i}")
    for m in (1, 4095, 4097, 12345, 1 << 20):
        check_bucket_agg(B, None, 1, active[:m], [(f, d[:m], None, u) for
                                                  (f, d, _v, u) in aggs[:2]],
                         sync, f"keyless n={m}")
    check_bucket_agg(B, None, 1, active[1:], [("sum", aggs[0][1][1:], None,
                                               False)], sync,
                     "keyless unaligned")
    two = aggs[:2]
    first = B.bucket_agg(None, 1, active, two)
    again = B.bucket_agg(None, 1, active, two)
    sync()
    check(same_bits(list(first[0]) + list(first[1]) + [first[2]],
                    list(again[0]) + list(again[1]) + [again[2]]),
          "bucket_agg keyless: two calls differ")
    err2 = check_bucket_agg(B, None, 1, active, two, sync, "keyless Q14")
    masked2 = stacked[:, :2].contiguous()    # the two sums, pre-masked
    k2_ms = time_ms(lambda: B.bucket_agg(None, 1, active, two))
    k2_plain = time_ms(lambda: B.bucket_agg_plain(None, 1, active, two))
    k2_lib = time_ms(lambda: masked2.sum(0))
    k2_bound = bound_ms(agg_bytes(None, 1, active, two))
    log(f"kernel bucket_agg keyless: n={n} aggs={len(two)} "
        f"kernel_ms={k2_ms:.4f} plain_ms={k2_plain:.4f} "
        f"library_ms={k2_lib:.4f} bound_us={k2_bound * 1e3:.2f} (bytes) "
        f"kernel/library={k2_ms / k2_lib:.3f} kernel/bound="
        f"{k2_ms / k2_bound:.3f} bit_equal=True")
    rows.append(dict(
        name="bucket_agg_keyless", route="cuda",
        source="ydb_tpu_torch/ops/cuda/csrc/bucket_agg.cu",
        replaces="ydb_tpu/ops/xla_exec.py:301",
        shape=f"n={n} aggs=2 float64 sums (Q14, keyless)",
        max_abs_err=err2, ms=k2_ms, plain_ms=k2_plain, library_ms=k2_lib,
        bound_ms=k2_bound, bound_by="bytes"))

    # -- compact at Q6's shape: n rows → the sized compact capacity,
    #    4 columns of the filtered env; then a forced overflow
    sel = rand((n,)) < 0.8 * q6_compact_cap / n      # live fits the cap
    length = torch.tensor(n - 12345, dtype=torch.int32, device=dev)
    cols = [rand((n,)), rand((n,)), randint(0, 1 << 30, (n,), torch.int32),
            rand((n,)) > 0.5]
    for new_cap, tag in ((q6_compact_cap, "fit"), (1024, "overflow")):
        ko, kl, kn, kf = B.compact(cols, sel, length, n, new_cap)
        po, pl, pn, pf = B.compact_plain(cols, sel, length, n, new_cap)
        sync()
        check(int(kl) == int(pl) and int(kn) == int(pn)
              and bool(kf) == bool(pf), f"compact {tag} scalars")
        check(bool(kf) == (tag == "overflow"), f"compact {tag} overflow")
        for a, b in zip(ko, po):
            check(torch.equal(a, b), f"compact {tag} column")
    nlive = int(kl)
    def run_k():
        return B.compact(cols, sel, length, n, q6_compact_cap)

    def run_p():
        return B.compact_plain(cols, sel, length, n, q6_compact_cap)
    width = sum(c.element_size() for c in cols)

    def lib():
        idx = torch.nonzero(sel).reshape(-1)
        return [c.index_select(0, idx) for c in cols]
    rows.append(dict(
        name="compact", route="cuda",
        source="ydb_tpu_torch/ops/cuda/csrc/compact.cu",
        replaces="ydb_tpu/ops/xla_exec.py:1041",
        shape=f"n={n} new_cap={q6_compact_cap} cols={len(cols)}",
        max_abs_err=0.0, ms=time_ms(run_k), plain_ms=time_ms(run_p),
        library_ms=time_ms(lib),
        bound_ms=bound_ms(n + 2 * nlive * width), bound_by="bytes"))

    # -- probe at Q14's shape: n probe rows of l_partkey into a
    #    200,000-key LUT (late: row id + found), with misses and NULLs
    nb_build = n_part
    lut = torch.full((lut_span,), -1, dtype=torch.int32, device=dev)
    perm = torch.randperm(nb_build, generator=g, device=dev)
    lut[:nb_build] = perm.to(torch.int32)
    key = randint(1, nb_build + 5000, (n,))    # keys past the span miss
    kvalid = rand((n,)) > 0.01
    psel = rand((n,)) < 0.0125
    keys_sorted = torch.arange(1, lut_span + 1, device=dev,
                               dtype=torch.int64)
    args = dict(lut=lut, lut_base=1, keys_sorted=keys_sorted,
                n_build=nb_build, pcap=lut_span, kind="inner", not_in=False,
                has_null=False, payloads=[])
    run_k = lambda: B.probe(key, kvalid, psel, **args)          # noqa: E731
    run_p = lambda: B.probe_plain(key, kvalid, psel, **args)    # noqa: E731
    kf_, ks_, ko_, _ = run_k()
    pf_, ps_, po_, _ = run_p()
    sync()
    check(torch.equal(kf_, pf_) and torch.equal(ks_, ps_)
          and torch.equal(ko_, po_), "probe")
    # the kernel's other forms, checked (not timed) on the same probes:
    # payload gathers (non-late joins), the sorted-keys lower_bound for
    # sparse int keys and for float keys, and the anti / NOT IN rules
    pay = [(randint(0, 1 << 40, (lut_span,)), rand((lut_span,)) > 0.3),
           (rand((lut_span,)), None)]
    sparse = torch.sort(torch.randperm(1 << 22, generator=g, device=dev)
                        [:4096] * 977).values
    pad = torch.full((8192 - 4096,), torch.iinfo(torch.int64).max,
                     dtype=torch.int64, device=dev)
    fkeys = torch.cat([torch.sort(rand((3000,)) * 100 - 50).values,
                       torch.full((1096,), float("inf"), device=dev,
                                  dtype=torch.float64)])
    fprobe = torch.where(rand((n,)) < 0.5,
                         fkeys[randint(0, 3000, (n,))], rand((n,)) * 100)
    variants = [
        ("lut payloads", key, dict(args, kind="left", payloads=pay)),
        ("bsearch anti not_in", sparse[randint(0, 4096, (n,))] +
         randint(0, 2, (n,)), dict(args, lut=None, n_build=4096,
                                   keys_sorted=torch.cat([sparse, pad]),
                                   pcap=8192, kind="left_anti",
                                   not_in=True)),
        ("bsearch float mark", fprobe, dict(
            args, lut=None, keys_sorted=fkeys, n_build=3000, pcap=lut_span,
            kind="mark", payloads=pay)),
    ]
    for tag, k_, kw in variants:
        got = B.probe(k_, kvalid, psel, **kw)
        want = B.probe_plain(k_, kvalid, psel, **kw)
        sync()
        check(all(torch.equal(x, y) for x, y in zip(got[:3], want[:3])),
              f"probe {tag}")
        for (gd, gv), (wd, wv) in zip(got[3], want[3]):
            check(torch.equal(gd, wd) and torch.equal(gv, wv),
                  f"probe {tag} payload")
    a, b = run_k(), run_k()
    sync()
    check(same_probe(a, b), "probe: two calls differ")
    rows.append(dict(
        name="probe", route="cuda",
        source="ydb_tpu_torch/ops/cuda/csrc/probe.cu",
        replaces="ydb_tpu/ops/join.py:218",
        shape=f"n={n} lut={lut_span} (Q14's l_partkey into part's LUT)",
        max_abs_err=0.0, ms=time_ms(run_k), plain_ms=time_ms(run_p),
        library_ms=time_ms(lambda: torch.searchsorted(keys_sorted, key)),
        bound_ms=bound_ms(n * (8 + 1 + 1) + n * (1 + 4 + 1)
                          + lut_span * 4), bound_by="bytes"))
    probe_checks(B, device)

    # -- the wrappers' multi-launch forms (more aggregates, compacted
    #    columns or gathered payloads than one launch takes), checked at
    #    a small size against the plain versions
    m = min(1 << 17, n)
    many = [("sum", rand((m,)), rand((m,)) > 0.1, False) if a % 2 else
            ("count", None, rand((m,)) > 0.1, False)
            for a in range(B._MAX_AGGS + 4)]
    check_bucket_agg(B, randint(0, 12, (m,), torch.int32), 12,
                     rand((m,)) < 0.9, many, sync, "chunked")
    ccols = [rand((m,)) if i % 2 else randint(0, 1 << 30, (m,), torch.int32)
             for i in range(B._MAX_COLS + 6)]
    csel = rand((m,)) < 0.3
    for new_cap, tag in ((1 << 16, "fit"), (1024, "overflow")):
        got = B.compact(ccols, csel, m - 77, m, new_cap)
        want = B.compact_plain(ccols, csel, m - 77, m, new_cap)
        sync()
        check(all(int(x) == int(y) for x, y in zip(got[1:], want[1:]))
              and all(torch.equal(x, y) for x, y in zip(got[0], want[0])),
              f"compact chunked {tag}")
    pays = [(randint(0, 1 << 40, (lut_span,)),
             rand((lut_span,)) > 0.3 if i % 2 else None)
            for i in range(B._MAX_PAYLOADS + 2)]
    kw = dict(args, kind="left", payloads=pays)
    csel = rand((m,)) < 0.5
    got = B.probe(key[:m], kvalid[:m], csel, **kw)
    want = B.probe_plain(key[:m], kvalid[:m], csel, **kw)
    sync()
    check(all(torch.equal(x, y) for x, y in zip(got[:3], want[:3]))
          and all(torch.equal(gd, wd) and torch.equal(gv, wv)
                  for (gd, gv), (wd, wv) in zip(got[3], want[3])),
          "probe chunked")

    # -- sort at Q1's ORDER BY shape: 128 rows, dropped rank + 2 keys
    from ydb_tpu_torch.ops.sort import encode_key
    m = 128
    dropped = (torch.arange(m, device=dev) >= 4).to(torch.int64)
    keys = [encode_key(dropped), encode_key(randint(0, 3, (m,))),
            encode_key(randint(0, 2, (m,)))]
    run_k = lambda: B.sort_perm(keys, m, dev)                   # noqa: E731
    run_p = lambda: B.sort_perm_plain(keys, m, dev)             # noqa: E731
    check(torch.equal(run_k(), run_p()), "sort")
    # a sort past the one-block path: the census and the digit passes
    big = [encode_key(randint(-5, 5, (1 << 16,))),
           encode_key(rand((1 << 16,)) - 0.5)]
    check(torch.equal(B.sort_perm(big, 1 << 16, dev),
                      B.sort_perm_plain(big, 1 << 16, dev)), "sort 64K")
    rows.append(dict(
        name="sort", route="cuda",
        source="ydb_tpu_torch/ops/cuda/csrc/sort.cu",
        replaces="ydb_tpu/ops/sort.py:32", shape=f"n={m} keys={len(keys)}",
        max_abs_err=0.0, ms=time_ms(run_k), plain_ms=time_ms(run_p),
        library_ms=time_ms(lambda: torch.sort(keys[1], stable=True)),
        bound_ms=bound_ms(m * 8 * len(keys) + m * 4), bound_by="bytes"))
    return rows


def same_probe(got, want) -> bool:
    """Every output of a probe call equal to another's (floats bit for
    bit)."""
    import torch
    if not all(torch.equal(x, y) for x, y in zip(got[:3], want[:3])):
        return False
    return len(got[3]) == len(want[3]) and all(
        torch.equal(gd.view(torch.uint8), wd.view(torch.uint8))
        and torch.equal(gv, wv)
        for (gd, gv), (wd, wv) in zip(got[3], want[3]))


def probe_bytes(key, kvalid, sel, kcap: int, payloads=()) -> int:
    """probe's bytes: the probe side read once (key, validity,
    selection), found, the row id and the selection written once, the
    sorted keys read once (kcap x 8), and per payload its gathered
    element and validity written once."""
    n = key.shape[0]
    ins = n * (key.element_size() + 1) + (0 if kvalid is None else n)
    return ins + n * (1 + 4 + 1) + kcap * 8 + sum(
        n * (src.element_size() + 1) for src, _v in payloads)


def record_probes(B, eng, sql: str) -> list:
    """Every probe call of one run of `sql` on `eng`: (key, key validity,
    selection, keyword arguments), the tensors copied."""
    calls = []
    real = B.probe

    def recording(key, kvalid, sel, **kw):
        calls.append((key.clone(), None if kvalid is None
                      else kvalid.clone(), sel.clone(), dict(kw)))
        return real(key, kvalid, sel, **kw)
    B.probe = recording
    try:
        eng.query(sql)
    finally:
        B.probe = real
    return calls


def probe_q9_phase(B, calls: list) -> list:
    """K7's sorted-keys search at q9's shape: the largest probe of one q9
    run that has no LUT (partsupp's composite key is sparse), against
    its plain version (every output, two calls bit for bit), timed
    beside ``torch.searchsorted`` on the same keys; the key count and
    kcap come from the build q9 made."""
    import torch
    search = [c for c in calls if c[3]["lut"] is None]
    check(search, "q9 made no sorted-keys probe")
    key, kvalid, sel, kw = max(search, key=lambda c: c[0].shape[0])
    n, kcap = key.shape[0], kw["keys_sorted"].shape[0]
    want = B.probe_plain(key, kvalid, sel, **kw)
    a, b = B.probe(key, kvalid, sel, **kw), B.probe(key, kvalid, sel, **kw)
    if key.is_cuda:
        torch.cuda.synchronize()
    check(same_probe(a, want), "probe q9 sorted keys: not the plain version")
    check(same_probe(a, b), "probe q9 sorted keys: two calls differ")
    ref = kw["keys_sorted"]
    row = dict(
        name="probe", route="cuda",
        source="ydb_tpu_torch/ops/cuda/csrc/probe.cu",
        replaces="ydb_tpu/ops/join.py:199",
        shape=f"n={n} keys={kw['n_build']} kcap={kcap} kind={kw['kind']} "
              f"active={int(sel.sum())} (q9's sorted-keys probe of "
              "partsupp)",
        max_abs_err=0.0,
        ms=time_ms(lambda: B.probe(key, kvalid, sel, **kw)),
        plain_ms=time_ms(lambda: B.probe_plain(key, kvalid, sel, **kw)),
        library_ms=time_ms(lambda: torch.searchsorted(ref, key)),
        bound_ms=bound_ms(probe_bytes(key, kvalid, sel, kcap,
                                      kw["payloads"])),
        bound_by="bytes")
    log(f"kernel probe q9 sorted keys: n={n} keys={kw['n_build']} "
        f"kcap={kcap} kernel_ms={row['ms']:.4f} "
        f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
        f"bound_us={row['bound_ms'] * 1e3:.2f} (bytes: the probe side, "
        "its outputs and kcap x 8)")
    return [row]


def probe_checks(B, device: str = "cuda") -> str:
    """K7 against its plain version at its edges, every output bit for
    bit, each case called twice and the calls held bit for bit: the
    sorted-keys search at every kcap = 2^k for k = 0 .. 24, 26 and 29
    (all levels in shared memory up to 2^14; then levels a key a load,
    one to four groups of three-level nodes from the table and the last
    window) over int64 keys with the sentinel padding, and over float64
    keys with NaN, +-inf and -0.0 among the probes; all five kinds, with
    the NOT IN rule and a NULL on the build side; 17 payloads of widths
    1, 2, 4 and 8 (with and without validity) on both paths; views that
    start off a 16-byte boundary, the sorted keys too (no node table, no
    window); odd row counts from 1 to 100,003, around a warp's 256 rows
    and 4,096; 0 rows."""
    import torch
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(707)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def rand(m):
        return torch.rand((m,), generator=g, device=dev, dtype=torch.float64)

    def randint(lo, hi, m):
        return torch.randint(lo, hi, (m,), generator=g, device=dev)

    def run(tag, key, kvalid, sel, **kw):
        want = B.probe_plain(key, kvalid, sel, **kw)
        a = B.probe(key, kvalid, sel, **kw)
        b = B.probe(key, kvalid, sel, **kw)
        sync()
        check(same_probe(a, want), f"probe {tag}: not the plain version")
        check(same_probe(a, b), f"probe {tag}: two calls differ")

    kinds = list(B.JOIN_KINDS)
    m = 70_001
    cases = 0
    for floating in (False, True):
        for k in [*range(25), 26, 29]:
            kcap = 1 << k
            nb = max(1, 3 * kcap // 4)
            if k > 21:
                # sorted without a sort: the running sum of random gaps
                if floating:
                    special = torch.tensor([-float("inf"), -0.0, 0.5],
                                           device=dev, dtype=torch.float64)
                    real = torch.sort(torch.cat([special, torch.cumsum(
                        rand(nb - 3) + 1e-3, 0) - nb / 4])).values
                    keys = torch.cat([real, torch.full(
                        (kcap - nb,), float("inf"), device=dev,
                        dtype=torch.float64)])
                    odd = torch.tensor([float("nan"), float("inf"),
                                        -float("inf"), -0.0, 0.0, 1e308],
                                       device=dev, dtype=torch.float64)
                    miss = (rand(m) - 0.5) * (nb / 2)
                else:
                    real = torch.cumsum(randint(1, 1 << 12, nb), 0) \
                        - (1 << 40)
                    keys = torch.cat([real, torch.full(
                        (kcap - nb,), torch.iinfo(torch.int64).max,
                        device=dev, dtype=torch.int64)])
                    odd = torch.tensor([torch.iinfo(torch.int64).max,
                                        torch.iinfo(torch.int64).min, 0,
                                        -1], device=dev, dtype=torch.int64)
                    miss = randint(-(1 << 40), 1 << 40, m)
                del real
            elif floating:
                special = torch.tensor([-float("inf"), -0.0, 0.5],
                                       device=dev, dtype=torch.float64)
                real = torch.sort(torch.cat([
                    special[:min(nb, 3)],
                    (rand(nb - min(nb, 3)) - 0.5) * 1e3])).values
                keys = torch.cat([real, torch.full(
                    (kcap - nb,), float("inf"), device=dev,
                    dtype=torch.float64)])
                odd = torch.tensor([float("nan"), float("inf"),
                                    -float("inf"), -0.0, 0.0, 1e308],
                                   device=dev, dtype=torch.float64)
                miss = (rand(m) - 0.5) * 1e3
            else:
                real = torch.sort(torch.unique(randint(
                    -(1 << 40), 1 << 40, 2 * nb + 8))[:nb]).values
                nb = real.shape[0]
                keys = torch.cat([real, torch.full(
                    (kcap - nb,), torch.iinfo(torch.int64).max, device=dev,
                    dtype=torch.int64)])
                odd = torch.tensor([torch.iinfo(torch.int64).max,
                                    torch.iinfo(torch.int64).min, 0, -1],
                                   device=dev, dtype=torch.int64)
                miss = randint(-(1 << 40), 1 << 40, m)
            u = rand(m)
            key = torch.where(u < 0.5, keys[randint(0, nb, m)],
                              torch.where(u < 0.8, miss,
                                          odd[randint(0, odd.shape[0], m)]))
            kind = kinds[k % len(kinds)]
            pays = [] if k % 3 or k > 24 else [
                (randint(0, 1 << 40, kcap), rand(kcap) > 0.3),
                (rand(kcap), None),
                (randint(0, 1 << 30, kcap).to(torch.int32), None),
                (rand(kcap) > 0.5, rand(kcap) > 0.5)]
            run(f"{'float' if floating else 'int'} kcap=2^{k} {kind}", key,
                rand(m) > 0.1, rand(m) < 0.7, lut=None, lut_base=0,
                keys_sorted=keys, n_build=nb, pcap=kcap, kind=kind,
                not_in=kind == "left_anti" and k % 2 == 1,
                has_null=kind == "left_anti" and k % 4 == 3, payloads=pays)
            cases += 1
    # the LUT and the search: every kind, NOT IN with and without a NULL
    # on the build side, 17 payloads of mixed widths, at odd row counts
    span, nb = 1 << 16, 50_000
    lut = torch.full((span,), -1, dtype=torch.int32, device=dev)
    lut[randint(0, span, nb)] = randint(0, nb, nb).to(torch.int32)
    keys = torch.cat([torch.sort(torch.unique(randint(0, 1 << 20, 3 * nb))
                                 [:nb]).values,
                      torch.full((span - nb,), torch.iinfo(torch.int64).max,
                                 device=dev, dtype=torch.int64)])
    pays = []
    for i in range(17):
        w = (torch.int64, torch.float64, torch.int32, torch.int16,
             torch.bool)[i % 5]
        src = (rand(span) * 3e4).to(w) if w != torch.bool \
            else rand(span) > 0.5
        pays.append((src, rand(span) > 0.2 if i % 2 else None))
    for n in (1, 15, 16, 17, 255, 257, 1023, 1025, 4095, 4097, 100_003):
        key = randint(-100, span + 100, n)
        skey = torch.where(rand(n) < 0.6, keys[randint(0, nb, n)], key)
        kv, sel = rand(n) > 0.05, rand(n) < 0.8
        for kind in kinds:
            for not_in, has_null in ((False, False), (True, False),
                                     (True, True)):
                if not_in and kind != "left_anti":
                    continue
                base = dict(lut_base=-7, n_build=nb, pcap=span, kind=kind,
                            not_in=not_in, has_null=has_null,
                            payloads=pays if n == 100_003 else pays[:3])
                run(f"lut n={n} {kind} not_in={not_in}", key, kv, sel,
                    lut=lut, keys_sorted=keys, **base)
                run(f"search n={n} {kind} not_in={not_in}", skey, kv, sel,
                    lut=None, keys_sorted=keys, **base)
                cases += 2
    # views that start off a 16-byte boundary (a flattened member axis, a
    # GraceJoin partition slice), and 0 rows
    n = 100_003
    key = randint(-100, span + 100, n + 8)
    skey = torch.where(rand(n + 8) < 0.6, keys[randint(0, nb, n + 8)], key)
    kv, sel = rand(n + 8) > 0.05, rand(n + 8) < 0.8
    for off in (1, 3, 5):
        base = dict(lut_base=0, n_build=nb, pcap=span, kind="left",
                    not_in=False, has_null=False, payloads=pays[:5])
        run(f"lut offset {off}", key[off:off + n], kv[off + 1:off + 1 + n],
            sel[off + 2:off + 2 + n], lut=lut, keys_sorted=keys, **base)
        run(f"search offset {off}", skey[off:off + n],
            kv[off + 1:off + 1 + n], sel[off + 2:off + 2 + n], lut=None,
            keys_sorted=keys, **base)
        cases += 2
    # sorted keys off a 16-byte boundary: every level a key a load
    big = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                     torch.sort(randint(-(1 << 40), 1 << 40, 1 << 20)).values])
    ukeys = big[1:]
    probes = torch.where(rand(n) < 0.5, ukeys[randint(0, 1 << 20, n)],
                         randint(-(1 << 40), 1 << 40, n))
    run("search unaligned keys kcap=2^20", probes, kv[:n], sel[:n],
        lut=None, lut_base=0, keys_sorted=ukeys, n_build=(1 << 20) - 5,
        pcap=1 << 20, kind="left", not_in=False, has_null=False,
        payloads=[])
    cases += 1
    z = B.probe(key[:0], None, sel[:0], lut=None, lut_base=0,
                keys_sorted=keys, n_build=nb, pcap=span, kind="inner",
                not_in=False, has_null=False, payloads=pays[:2])
    check(z[0].shape == (0,) and z[3][0][0].shape == (0,), "probe 0 rows")
    msg = (f"kernel probe checks: {cases} cases, kcap 1 .. 2^24, 2^26, "
           "2^29 (int64 and "
           "float64 keys, sentinels, NaN, +-inf, -0.0), all five kinds, "
           "NOT IN, 17 payloads, offset views, unaligned sorted keys, "
           "1 .. 100,003 rows, 0 rows: "
           "equal to the plain version, two calls bit for bit")
    log(msg)
    return msg


def partition_checks(B, device: str = "cuda") -> str:
    """K14 against its plain version, ids, counts and every column bit
    for bit, each case called twice and the calls held bit for bit: the
    length at 0, 1, a tile - 1, a tile, a tile + 1 and n; 1, 2, 8 and
    256 partitions; 33 columns of widths 8, 4, 2 and 1 (two launches of
    the scatter); out_rows > n; the ids asked for and not; views that
    start off a 16-byte boundary; many tiles at 256 partitions."""
    import torch
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(1313)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def randint(lo, hi, m, dtype=torch.int64):
        return torch.randint(lo, hi, (m,), generator=g, device=dev,
                             dtype=dtype)

    def columns(m, k):
        fl = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0,
                           0.0, 1.5], dtype=torch.float64, device=dev)
        out = []
        for i in range(k):
            w = i % 5
            out.append(fl[randint(0, 6, m)] if w == 0 else
                       randint(-(1 << 31), 1 << 31, m, torch.int32) if w == 1
                       else randint(-(1 << 15), 1 << 15, m, torch.int16)
                       if w == 2 else randint(0, 255, m, torch.uint8)
                       if w == 3 else randint(0, 2, m) > 0)
        return out

    def run(tag, h, length, nparts, cols, out_rows, ids):
        want = B.partition_plain(h, length, nparts, cols, out_rows, ids=ids)
        a = B.partition(h, length, nparts, cols, out_rows, ids=ids)
        b = B.partition(h, length, nparts, cols, out_rows, ids=ids)
        sync()
        for got, what in ((a, "not the plain version"),
                          (b, "two calls differ")):
            check((got[0] is None) == (not ids)
                  and (not ids or torch.equal(got[0], want[0])),
                  f"partition {tag}: ids {what}")
            check(torch.equal(got[1], want[1]),
                  f"partition {tag}: counts {what}")
            for i, (x, y) in enumerate(zip(got[2], want[2])):
                check(torch.equal(x.view(torch.uint8), y.view(torch.uint8)),
                      f"partition {tag}: column {i} {what}")

    tile = 4096
    n = 3 * tile + 333
    h = randint(-(1 << 62), 1 << 62, n) * 2 + randint(0, 2, n)
    cols = columns(n, 33)
    cases = 0
    for nparts in (1, 2, 8, 256):
        for length in (0, 1, tile - 1, tile, tile + 1, n):
            run(f"nparts={nparts} length={length}", h, length, nparts, cols,
                n + 777, ids=(length + nparts) % 2 == 0)
            cases += 1
    # views off a 16-byte boundary, the length on the device
    big = columns(n + 8, 5)
    hb = randint(-(1 << 62), 1 << 62, n + 8)
    for off in (1, 3):
        run(f"offset {off}", hb[off:off + n],
            torch.tensor(n - 999, dtype=torch.int32, device=dev), 8,
            [c[off + i:off + i + n] for i, c in enumerate(big)], 2 * n,
            ids=off == 1)
        cases += 1
    # many tiles into 256 partitions (long look-back chains), and 1 row
    m = (1 << 20) + 333
    hm = randint(-(1 << 62), 1 << 62, m)
    run("2^20 + 333 rows into 256", hm, m - 5, 256, columns(m, 6), m + 9,
        ids=True)
    run("one row", hm[:1], 1, 16, columns(1, 3), 5, ids=True)
    cases += 2
    msg = (f"kernel partition checks: {cases} cases, length 0, 1, 4095, "
           "4096, 4097 and n; 1, 2, 8 and 256 partitions; 33 columns of "
           "widths 8, 4, 2 and 1; out_rows > n; ids on and off; offset "
           "views; 2^20 + 333 rows into 256: equal to the plain version, "
           "two calls bit for bit")
    log(msg)
    return msg


def sort_checks(B, device: str = "cuda") -> None:
    """K9's edges against the plain version, each called twice and the
    two calls held bit for bit equal: n = 0, 1, 1,023, 1,024, 1,025 (the
    one-block path), 8,193 (the radix passes' smallest), every word
    equal, 16 words, one live bit, words >= 2^63, and the member form at
    B = 8 over 2^20 rows (member id, inactive rank, key)."""
    import torch

    from ydb_tpu_torch.ops.sort import encode_key
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(999)

    def randint(lo, hi, m):
        return torch.randint(lo, hi, (m,), generator=g, device=dev)

    def exact(keys, m, tag):
        a = B.sort_perm(keys, m, dev)
        b = B.sort_perm(keys, m, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        check(torch.equal(a, B.sort_perm_plain(keys, m, dev))
              and torch.equal(a, b), f"sort {tag}: n={m}")
    cases = []
    for m in (0, 1, 1023, 1024, 1025, 8193):
        exact([encode_key(randint(0, 2, m)), encode_key(randint(-9, 9, m)),
               encode_key(torch.rand(m, generator=g, device=dev,
                                     dtype=torch.float64) - 0.5)], m,
              "mixed")
        cases.append(f"n={m}")
    m = 100_000
    exact([torch.full((m,), 7, dtype=torch.int64, device=dev)] * 2, m,
          "every word equal")
    exact([torch.full((1000,), 7, dtype=torch.int64, device=dev)] * 2, 1000,
          "every word equal (one block)")
    exact([randint(0, 3, m) for _ in range(16)], m, "16 words")
    exact([randint(0, 2, m) << 41], m, "one live bit")
    exact([randint(-(1 << 62), 1 << 62, m) - (randint(0, 2, m) << 63)], m,
          "words >= 2^63")
    Bm, cap = 8, 1 << 17
    member = torch.arange(Bm, device=dev)[:, None].expand(Bm, cap).reshape(-1)
    act = torch.rand(Bm * cap, generator=g, device=dev) < 0.3
    exact([encode_key(member), encode_key((~act).to(torch.int64)),
           encode_key(randint(0, 5000, Bm * cap))], Bm * cap,
          "member form B=8")
    log("kernel sort checks: " + " ".join(cases) + ", every word equal "
        "(radix and one block), 16 words, one live bit, words >= 2^63, "
        f"member form B={Bm} x {cap}: equal to the plain version, two "
        "calls bit for bit ok")


def f1_phase(B, device: str = "cuda") -> None:
    """More key words than a kernel takes in one launch (ROADMAP Queue 3
    F1), each wrapper exactly against its plain version: `sort_perm` at
    17 and 33 words over 2^20 rows and 5,000 rows (the one-block path),
    each twice and bit for bit; `segment_agg` (and its member form) at
    17 and 33 words; `window_scan` at 20 words; `segments` and
    `segment_targets` at 20 keys with NULLs."""
    import torch

    from ydb_tpu_torch.ops.sort import encode_key
    t0 = time.perf_counter()
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(1111)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def words(width, m):
        # small domains: many rows equal in every word
        return [encode_key(torch.randint(-2, 3, (m,), generator=g,
                                         device=dev)) for _ in range(width)]

    def rand(m):
        return torch.rand(m, generator=g, device=dev, dtype=torch.float64)
    for width in (17, 33):
        for m in (1 << 20, 5000):
            w = words(width, m)
            a = B.sort_perm(w, m, dev)
            b = B.sort_perm(w, m, dev)
            sync()
            check(torch.equal(a, B.sort_perm_plain(w, m, dev))
                  and torch.equal(a, b), f"f1 sort {width} words n={m}")
    m = 1 << 20
    for width in (17, 33):
        w = words(width, m)
        active = rand(m) < 0.9
        perm = B.sort_perm([encode_key((~active).to(torch.int64))] + w, m,
                           dev)
        aggs = [("sum", rand(m), rand(m) < 0.9, False),
                ("count", None, None, False),
                ("first", None, None, False)]
        got = B.segment_agg(perm, w, active, aggs, m)
        want = B.segment_agg_plain(perm, w, active, aggs, m)
        sync()
        check(all(torch.equal(x, y) for x, y in zip(got[:3], want[:3])),
              f"f1 segment_agg {width} words: groups")
        for i, (x, y) in enumerate(zip(got[3] + got[4], want[3] + want[4])):
            if x.dtype == torch.float64:
                torch.testing.assert_close(x, y, rtol=RTOL, atol=0)
            else:
                check(torch.equal(x, y), f"f1 segment_agg {width} words {i}")
        masks = (rand(4 * m).reshape(4, m) < 0.5) & active[None, :]
        bperm = B.sort_perm([encode_key((~masks.any(0)).to(torch.int64))]
                            + w, m, dev)
        check_segment_agg_batched(B, bperm, w, masks.contiguous(), aggs[:2],
                                  m, sync, f"f1 {width} words")
    w = words(20, m)
    perm = B.sort_perm(w, m, dev)
    scans = [("sum", rand(m), rand(m) < 0.9),
             ("max", torch.randint(-99, 99, (m,), generator=g, device=dev),
              None)]
    got = B.window_scan(perm, w[:6], w[6:], scans)
    want = B.window_scan_plain(perm, w[:6], w[6:], scans)
    sync()
    check(all(torch.equal(x, y) for x, y in zip(got[:4], want[:4])),
          "f1 window_scan 20 words: structure")
    for (gv, gc), (wv, wc) in zip(got[4], want[4]):
        check(torch.equal(gc, wc), "f1 window_scan 20 words: counts")
        torch.testing.assert_close(gv, wv, rtol=RTOL, atol=0)
    keys = [(torch.randint(-3, 3, (m,), generator=g, device=dev)
             if i % 3 else rand(m) * 1e3, rand(m) < 0.8 if i % 2 else None)
            for i in range(20)]
    cols = [(rand(m), None), (torch.randint(0, 99, (m,), generator=g,
                                            device=dev), rand(m) < 0.5)]
    check(torch.equal(B.segment_targets(keys, 4),
                      B.segment_targets_plain(keys, 4)),
          "f1 segment_targets 20 keys")
    got = B.segments(m - 7, 4, m, cols, keys=keys)
    want = B.segments_plain(m - 7, 4, m, cols, keys=keys)
    sync()
    check(torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]),
          "f1 segments 20 keys: counts")
    for (gd, gv), (wd, wv) in zip(got[0], want[0]):
        live = torch.arange(m, device=dev)[None, :] < got[1][:, None]
        check(torch.equal(torch.where(live, gd, 0), torch.where(live, wd, 0))
              and torch.equal(gv & live, wv & live),
              "f1 segments 20 keys: rows")
    log("kernel F1 checks: sort_perm at 17 and 33 words (n=2^20 and 5000, "
        "two calls bit for bit), segment_agg and segment_agg_batched at 17 "
        "and 33 words, window_scan at 6 + 14 words, segments and "
        "segment_targets at 20 keys: equal to the plain versions ok "
        f"({time.perf_counter() - t0:.1f} s)")


# the 16 lineitem columns: a GROUP BY over them sorts 17 words (the
# inactive rank first), an ORDER BY 22 (K9 sorts past 16 words in two
# launches of the chain)
F1_COLUMNS = ("l_orderkey", "l_partkey", "l_suppkey", "l_linenumber",
              "l_quantity", "l_extendedprice", "l_discount", "l_tax",
              "l_returnflag", "l_linestatus", "l_shipdate", "l_commitdate",
              "l_receiptdate", "l_shipinstruct", "l_shipmode", "l_comment")
F1_ORDER_KEY_BELOW = 50_000        # about 200,000 lineitem rows at SF1
F1_SQL = {
    "group_by_16": f"select {', '.join(F1_COLUMNS)}, count(*) as n "
                   f"from lineitem where l_orderkey < {F1_ORDER_KEY_BELOW} "
                   f"group by {', '.join(F1_COLUMNS)}",
    "order_by_16": f"select {', '.join(F1_COLUMNS)} from lineitem "
                   f"where l_orderkey < {F1_ORDER_KEY_BELOW} order by "
                   + ", ".join(f"{c} desc" if i % 2 else c
                               for i, c in enumerate(F1_COLUMNS))
                   + " limit 100",
}


def f1_oracle(name: str, data):
    from ydb_tpu_torch.bench.tpch_oracle import frames
    li = frames(data)["lineitem"]
    d = li[li.l_orderkey < F1_ORDER_KEY_BELOW][list(F1_COLUMNS)]
    if name == "group_by_16":
        return d.groupby(list(F1_COLUMNS), sort=True).size() \
            .reset_index(name="n")
    return d.sort_values(list(F1_COLUMNS),
                         ascending=[i % 2 == 0 for i in range(16)],
                         kind="stable").head(100)


def f1_query_phase(bindings, eng, eng_plain, data) -> None:
    """F1 through the main path: the two 16-column queries on the card,
    each matching the pandas oracle and the same engine's plain path
    (`eng_plain`, the CPU over the same catalog); the sort chain must
    have run (more `sort` launches than sorts)."""
    from ydb_tpu_torch.bench.tpch_oracle import assert_frames_match
    for name, sql in F1_SQL.items():
        before = dict(bindings.LAUNCHES)
        t0 = time.perf_counter()
        got = eng.query(sql)
        wall = (time.perf_counter() - t0) * 1e3
        launches = {k: v - before[k] for k, v in bindings.LAUNCHES.items()
                    if v > before[k]}
        check(launches.get("sort", 0) >= 2, f"f1 {name}: {launches}")
        ordered = name == "order_by_16"
        assert_frames_match(got, f1_oracle(name, data), ordered=ordered)
        t0 = time.perf_counter()
        plain = eng_plain.query(sql)
        plain_wall = (time.perf_counter() - t0) * 1e3
        assert_frames_match(got, plain, ordered=ordered)
        log(f"query f1 {name}: rows={len(got)} cold_ms={wall:.2f} "
            f"plain_cpu_ms={plain_wall:.2f} path={eng.executor.last_path} "
            f"ok launches={json.dumps(launches)}")


def segment_agg_bytes(perm, keys, active, aggs, oc: int) -> int:
    """segment_agg's distinct input bytes plus its outputs at `oc` slots
    (lead, present, and a value and a count per aggregate)."""
    ins = [perm, active] + list(keys) \
        + [t for (_f, d, v, _u) in aggs for t in (d, v)]
    return distinct_bytes(ins) + oc * (4 + 8 + 16 * len(aggs))


def bits(t):
    """A tensor's raw bits, for bit-for-bit comparisons of floats."""
    import torch
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def same_bits(a, b) -> bool:
    """Two results of a kernel (tensors or nested lists / tuples of them)
    equal bit for bit."""
    import torch
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_bits(x, y)
                                        for x, y in zip(a, b))
    return torch.equal(bits(a), bits(b))


def check_segment_agg(B, perm, keys, active, aggs, oc: int, sync,
                      tag) -> float:
    """segment_agg against its plain version: ngroups, leaders, counts
    and integer results exactly (every slot, the zeros past ngroups
    included), float sums to RTOL; and a second call bit for bit equal
    to the first. Returns the largest absolute difference of a float
    sum."""
    import torch
    got = B.segment_agg(perm, keys, active, aggs, oc)
    again = B.segment_agg(perm, keys, active, aggs, oc)
    want = B.segment_agg_plain(perm, keys, active, aggs, oc)
    sync()
    check(same_bits(got, again), f"segment_agg {tag}: two calls differ")
    check(int(got[0]) == int(want[0]),
          f"segment_agg {tag} ngroups {int(got[0])} != {int(want[0])}")
    check(torch.equal(got[1], want[1]), f"segment_agg {tag} lead")
    check(torch.equal(got[2], want[2]), f"segment_agg {tag} present")
    err = 0.0
    for i, (f, d, _v, _u) in enumerate(aggs):
        check(torch.equal(got[4][i], want[4][i]),
              f"segment_agg {tag} count {i}")
        kv, pv = got[3][i], want[3][i]
        if f == "sum" and d.dtype == torch.float64:
            torch.testing.assert_close(kv, pv, rtol=RTOL, atol=0)
            err = max(err, float((kv - pv).abs().max())) if kv.numel() \
                else err
        else:
            check(torch.equal(kv, pv), f"segment_agg {tag} {f} {i}")
    return err


def bucket_perm_phase(B, n: int, active, rev, dev, sync, rand,
                      randint) -> list:
    """K4: `bucket_perm` against its plain version, exactly, at 60,000
    random buckets, 65,535 buckets with half the rows in one, 2% of the
    rows active, 0 rows, and B = 8 members over a shared id (the union of
    their masks) and over per-member ids; then the medium-domain lane
    (bucket_perm + segment_agg) against the composition it replaced
    (sort_perm + segment_agg) and one scatter_reduce, timed in this call:
    the new lane's permutation prefix and folded values must equal the
    old composition's bit for bit."""
    import torch

    from ydb_tpu_torch.ops.sort import encode_key
    nb = 60_000

    def exact(kid, act, nbuckets, tag):
        got = B.bucket_perm(kid, act, nbuckets)
        want = B.bucket_perm_plain(kid, act, nbuckets)
        sync()
        check(torch.equal(got, want), f"bucket_perm {tag}")
        return got
    kid = randint(0, nb, (n,), torch.int32)
    exact(kid, active, nb, "60,000 buckets")
    skew = torch.where(rand((n,)) < 0.5, 12_345,
                       randint(0, 65_535, (n,), torch.int32)).to(torch.int32)
    exact(skew, active, 65_535, "65,535 buckets, half the rows in one")
    sparse = active & (rand((n,)) < 0.02)
    exact(kid, sparse, nb, "2% active")
    exact(kid[:0], active[:0], nb, "0 rows")
    exact(kid[:1000], torch.zeros(1000, dtype=torch.bool, device=dev), nb,
          "no active row")
    Bm, m = 8, min(1 << 20, n)
    masks = (rand((Bm, m)) < 0.3) & active[None, :m]
    exact(kid[:m].contiguous(), masks.any(0), nb, "B=8 shared id, union")
    per = randint(0, 1200, (Bm, m), torch.int32)
    exact(per, masks, 1200, "B=8 per-member ids")
    log("kernel bucket_perm checks: 60,000 buckets, 65,535 with half the "
        "rows in one, 2% active, 0 rows, no active row, B=8 shared and "
        "per-member: equal to the plain version")

    # the lane, new and old, and the reference's scatter_reduce
    kwords = [encode_key(kid.to(torch.int64))]
    kaggs = [("sum", rev, None, False), ("count", None, None, False)]
    oc = 65536
    inactive = encode_key((~active).to(torch.int64))

    def new_perm():
        return B.bucket_perm(kid, active, nb)

    def old_perm():
        return B.sort_perm([inactive] + kwords, n, dev)

    def lane(perm_fn):
        return B.segment_agg(perm_fn(), kwords, active, kaggs, oc)
    pn, po = new_perm(), old_perm()
    got, old = lane(new_perm), lane(old_perm)
    want = B.segment_agg(po, kwords, active, kaggs, oc)
    plain = B.segment_agg_plain(B.bucket_perm_plain(kid, active, nb), kwords,
                                active, kaggs, oc)
    sync()
    live = int(active.sum())
    check(torch.equal(pn[:live], po[:live]), "K4 lane: permutation prefix")
    check(same_bits(got, old) and same_bits(got, want),
          "K4 lane: folded values differ from the old composition's")
    check(int(got[0]) == int(plain[0]) and torch.equal(got[1], plain[1])
          and torch.equal(got[2], plain[2])
          and torch.equal(got[4][1], plain[4][1]), "K4 lane vs plain")
    torch.testing.assert_close(got[3][0], plain[3][0], rtol=RTOL, atol=0)
    err = float((got[3][0] - plain[3][0]).abs().max())
    kid_l = torch.where(active, kid.to(torch.int64),
                        torch.full((n,), nb, dtype=torch.int64, device=dev))

    def lib4():
        return torch.zeros(nb + 1, dtype=torch.float64, device=dev) \
            .scatter_reduce_(0, kid_l, rev, "sum")
    t_new, t_old = time_ms(lambda: lane(new_perm)), time_ms(lambda: lane(old_perm))
    t_perm, t_sort = time_ms(new_perm), time_ms(old_perm)
    t_fold = time_ms(lambda: B.segment_agg(pn, kwords, active, kaggs, oc))
    t_plain = time_ms(lambda: B.segment_agg_plain(
        B.bucket_perm_plain(kid, active, nb), kwords, active, kaggs, oc))
    t_lib = time_ms(lib4)
    # the least the lane moves: the ids (int32), the activity and the
    # summed column read once; per slot a lead, a row count, and a value
    # and a count per aggregate written once
    lane_bound = bound_ms(distinct_bytes([kid, active, rev])
                          + oc * (4 + 8 + 16 * len(kaggs)))
    log(f"kernel K4 lane medium domain: n={n} buckets={nb} live={live} "
        f"lane_ms={t_new:.4f} (bucket_perm_ms={t_perm:.4f} "
        f"segment_agg_ms={t_fold:.4f}) old_lane_ms={t_old:.4f} "
        f"(sort_perm_ms={t_sort:.4f}) plain_ms={t_plain:.4f} "
        f"library_ms={t_lib:.4f} bound_us={lane_bound * 1e3:.2f} (bytes) "
        f"max_abs_err={err:.3g} bit_equal_to_old=True")
    # bucket_perm's own row: the ids and the activity read once, the
    # permutation written once; the library call is one stable sort of
    # the ids with the inactive rows mapped past the buckets
    return [dict(
        name="bucket_perm", route="cuda",
        source="ydb_tpu_torch/ops/cuda/csrc/bucket_sort.cu",
        replaces="ydb_tpu/ops/xla_exec.py:457",
        shape=f"n={n} buckets={nb} (the K4 lane's order; lane "
              f"{t_new:.4f} ms with segment_agg, was {t_old:.4f} with "
              "sort_perm)",
        max_abs_err=0.0, ms=t_perm,
        plain_ms=time_ms(lambda: B.bucket_perm_plain(kid, active, nb)),
        library_ms=time_ms(lambda: torch.sort(kid_l, stable=True)),
        bound_ms=bound_ms(distinct_bytes([kid, active]) + n * 4),
        bound_by="bytes")]


def sorted_lane_phase(B, n: int, cap: int, live: int,
                      device: str = "cuda") -> list:
    """The sorted group-by's kernels (``sort`` at scan capacity,
    ``segment_agg``) and ``hash64`` against their plain versions, and a
    probe of u64 keys >= 2^63. `n` rows in portions of `cap` rows of
    which `live` are real, as the lineitem superblock holds them."""
    import numpy as np
    import torch

    from ydb_tpu_torch.core.block import HostBlock
    from ydb_tpu_torch.core.dtypes import DType, Kind
    from ydb_tpu_torch.core.schema import Column, Schema
    from ydb_tpu_torch.ops import join as J
    from ydb_tpu_torch.ops.sort import encode_key, group_key_words
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(4321)
    rows = []

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def rand(shape, dtype=torch.float64):
        return torch.rand(shape, generator=g, device=dev, dtype=dtype)

    def randint(lo, hi, shape, dtype=torch.int64):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=dtype)

    def perm_of(words, active):
        return B.sort_perm([encode_key((~active).to(torch.int64))] + words,
                           active.shape[0], dev)

    # -- q18's subquery: group lineitem by l_orderkey (1 to 7 lines per
    #    order, keys ascending in each portion as the generator writes
    #    them), sum(l_quantity); no output bound, so oc = n
    iota = torch.arange(n, device=dev)
    active = (iota % cap) < live
    lines = randint(1, 8, (n // 3 + 8,))
    okey = torch.repeat_interleave(
        torch.arange(lines.shape[0], device=dev) * 4 + 1, lines)[:n]
    qty = randint(1, 51, (n,)).to(torch.float64)
    words = [encode_key(okey)]
    sort_keys = [encode_key((~active).to(torch.int64))] + words
    perm = B.sort_perm(sort_keys, n, dev)
    check(torch.equal(perm, B.sort_perm_plain(sort_keys, n, dev))
          and torch.equal(perm, B.sort_perm(sort_keys, n, dev)),
          "sort at scan capacity (plain, two calls)")
    sort_bound = bound_ms(n * 8 * len(sort_keys) + n * 4)
    log(f"kernel sort at scan capacity: n={n} keys={len(sort_keys)} "
        f"kernel_ms={time_ms(lambda: B.sort_perm(sort_keys, n, dev)):.4f} "
        f"plain_ms={time_ms(lambda: B.sort_perm_plain(sort_keys, n, dev)):.4f} "
        f"library_ms={time_ms(lambda: torch.sort(okey, stable=True)):.4f} "
        f"bound_us={sort_bound * 1e3:.2f} (bytes)")
    aggs = [("sum", qty, None, False)]
    err = check_segment_agg(B, perm, words, active, aggs, n, sync, "q18")
    # the same groups 13 rows further on (13 one-row groups of smaller
    # keys in front): a group of up to 32 rows folds to the same bits
    # wherever it lies, as two layouts of the same rows (the DQ planes)
    # need
    shift = 13
    pre = torch.arange(shift, device=dev) - shift
    s_words = [encode_key(torch.cat([pre, okey]))]
    s_active = torch.cat([torch.ones(shift, dtype=torch.bool, device=dev),
                          active])
    s_qty = torch.cat([rand((shift,)), qty])
    s_perm = perm_of(s_words, s_active)
    at = B.segment_agg(perm, words, active, aggs, n)
    moved = B.segment_agg(s_perm, s_words, s_active,
                          [("sum", s_qty, None, False)], n + shift)
    sync()
    ng18 = int(at[0])
    check(int(moved[0]) == ng18 + shift
          and same_bits(moved[3][0][shift:shift + ng18], at[3][0][:ng18]),
          "segment_agg q18: a group's sum depends on its position")
    ng = int(B.segment_agg_plain(perm, words, active, aggs, n)[0])
    # the library call: one scatter_reduce of the sums over group ids
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = okey[1:] != okey[:-1]
    gid = torch.cumsum(first.to(torch.int64), 0) - 1
    gid = torch.where(active, gid, torch.full_like(gid, n))

    def lib():
        return torch.zeros(n + 1, dtype=torch.float64, device=dev) \
            .scatter_reduce_(0, gid, qty, "sum")
    rows.append(dict(
        name="segment_agg", route="cuda",
        source="ydb_tpu_torch/ops/cuda/csrc/segment_agg.cu",
        replaces="ydb_tpu/ops/xla_exec.py:599",
        shape=f"n={n} groups={ng} aggs=1 oc={n} (q18 subquery)",
        max_abs_err=err,
        ms=time_ms(lambda: B.segment_agg(perm, words, active, aggs, n)),
        plain_ms=time_ms(lambda: B.segment_agg_plain(perm, words, active,
                                                     aggs, n)),
        library_ms=time_ms(lib),
        bound_ms=bound_ms(segment_agg_bytes(perm, words, active, aggs, n)),
        bound_by="bytes"))

    # -- q3's shape: a shipdate filter and a join keep a few orders' lines
    #    (groups of at most 7 rows), under the join's output bound
    chosen = rand((lines.shape[0],)) < 0.02
    keep = torch.repeat_interleave(chosen, lines)[:n]
    active3 = active & keep & (rand((n,)) < 0.54)
    oc3 = 1 << 17
    rev = rand((n,)) * 1e5
    aggs3 = [("sum", rev, None, False), ("count", None, None, False)]
    perm3 = perm_of(words, active3)
    check_segment_agg(B, perm3, words, active3, aggs3, oc3, sync, "q3")
    log(f"kernel segment_agg q3 shape: n={n} "
        f"groups={int(B.segment_agg_plain(perm3, words, active3, aggs3, oc3)[0])} "
        f"oc={oc3} kernel_ms={time_ms(lambda: B.segment_agg(perm3, words, active3, aggs3, oc3)):.4f} "
        f"plain_ms={time_ms(lambda: B.segment_agg_plain(perm3, words, active3, aggs3, oc3)):.4f} "
        f"bound_us={bound_ms(segment_agg_bytes(perm3, words, active3, aggs3, oc3)) * 1e3:.2f} (bytes)")

    # -- one group holding half the rows (Q1's skew), the rest in groups
    #    of about ten
    skey = torch.where(rand((n,)) < 0.5, 0, randint(1, n // 10, (n,)))
    swords = [encode_key(skey)]
    sperm = perm_of(swords, active)
    aggs_s = [("sum", rev, None, False), ("count", None, None, False),
              ("max", qty, None, False)]
    check_segment_agg(B, sperm, swords, active, aggs_s, n, sync, "skew")
    log(f"kernel segment_agg one group of half the rows: n={n} "
        f"kernel_ms={time_ms(lambda: B.segment_agg(sperm, swords, active, aggs_s, n)):.4f} "
        f"plain_ms={time_ms(lambda: B.segment_agg_plain(sperm, swords, active, aggs_s, n)):.4f} "
        f"bound_us={bound_ms(segment_agg_bytes(sperm, swords, active, aggs_s, n)) * 1e3:.2f} (bytes)")

    # -- the medium-domain lane (K4): rows ordered by a bucket id (60,000
    #    buckets, as q10 groups customers at SF 0.4) with bucket_perm,
    #    then folded per bucket by segment_agg; against the comparison
    #    sort it replaced (sort_perm, then the same fold) and the
    #    reference's own method, one scatter_reduce of the sums over the
    #    bucket ids (the library call)
    rows += bucket_perm_phase(B, n, active, rev, dev, sync, rand,
                              randint)
    # -- nullable int keys, NaN and -0.0 float keys, every aggregate
    #    function over float, signed and unsigned values with NULLs, the
    #    multi-launch form (at a row count that ends in a partial
    #    tile), and 0 rows; checked, not timed
    m = (1 << 20) + 333
    am = rand((m,)) < 0.9
    ki = randint(-3, 300, (m,))
    kf = torch.tensor([0.5, -1.25, float("nan"), 2.0, 0.0, -0.0],
                      device=dev, dtype=torch.float64)[randint(0, 6, (m,))]
    env = {"ki": (ki, rand((m,)) > 0.2), "kf": (kf, None)}
    ewords = group_key_words(["ki", "kf"], env)
    eperm = perm_of(ewords, am)
    vf, vv = rand((m,)) * 100 - 50, rand((m,)) > 0.1
    every = [("count", None, vv, False), ("sum", vf, vv, False),
             ("min", vf, vv, False), ("max", vf, None, False),
             ("first", None, vv, False),
             ("sum", randint(-(1 << 40), 1 << 40, (m,)), vv, False),
             ("min", randint(-(1 << 62), 1 << 62, (m,)), None, False),
             ("max", randint(-(1 << 62), 1 << 62, (m,)), vv, True),
             ("min", randint(-(1 << 62), 1 << 62, (m,)), None, True)]
    check_segment_agg(B, eperm, ewords, am, every, m, sync, "every func")
    check_segment_agg(B, eperm, ewords, am, every * 2, m, sync, "chunked")
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    check_segment_agg(B, torch.zeros(0, dtype=torch.int32, device=dev),
                      [empty], torch.zeros(0, dtype=torch.bool, device=dev),
                      [("sum", empty.to(torch.float64), None, False),
                       ("min", empty, None, False)], 128, sync, "0 rows")
    log("kernel segment_agg checks: q18, q3, skew, every func, chunked, "
        "0 rows: equal to the plain version (every slot), two calls bit "
        "for bit equal")

    # -- hash64: hash_combine(hash64(a), hash64(b)) over lineitem's rows
    ha = randint(-(1 << 62), 1 << 62, (n,)) * 2 + randint(0, 2, (n,))
    hb = randint(1, 10001, (n,))
    hk = B.hash64([ha, hb])
    hp = B.hash64_plain([ha, hb], [True, True])
    sync()
    check(torch.equal(hk, hp), "hash64")
    top = float((hk < 0).to(torch.float64).mean())
    check(top > 0.4, f"hash64: {top} of the hashes >= 2^63")
    rows.append(dict(
        name="hash64", route="cuda",
        source="ydb_tpu_torch/ops/cuda/csrc/hash64.cu",
        replaces="ydb_tpu/utils/hashing.py:17",
        shape=f"n={n} cols=2 (q9 partsupp key)", max_abs_err=0.0,
        ms=time_ms(lambda: B.hash64([ha, hb])),
        plain_ms=time_ms(lambda: B.hash64_plain([ha, hb], [True, True])),
        # no PyTorch call computes a 64-bit splitmix hash
        library_ms=None, bound_ms=bound_ms(3 * 8 * n), bound_by="bytes"))

    # -- a probe of u64 keys >= 2^63: about as many hashed keys as
    #    partsupp holds at SF1 (800,000) as the build, half the probes
    #    hitting
    nb_ = n // 8
    bkeys = torch.unique(B.hash64([randint(0, 1 << 40, (nb_,))]))
    bblock = HostBlock.from_arrays(
        Schema([Column("bk", DType(Kind.UINT64, False)),
                Column("p", DType(Kind.INT64, False))]),
        {"bk": bkeys.cpu().numpy().view(np.uint64),
         "p": np.arange(bkeys.shape[0])}, {})
    bt = J.build(bblock, "bk", ["p"], dev)
    hit = rand((n,)) < 0.5
    pk = torch.where(hit, bkeys[randint(0, bkeys.shape[0], (n,))],
                     B.hash64([randint(1 << 41, 1 << 42, (n,))]))
    kw = dict(lut=None, lut_base=0, keys_sorted=bt.keys_sorted,
              n_build=bt.n, pcap=bt.keys_sorted.shape[0], kind="inner",
              not_in=False, has_null=False,
              payloads=[(bt.payload["p"], None)])
    got = B.probe(pk, None, active, **kw)
    want = B.probe_plain(pk, None, active, **kw)
    sync()
    check(all(torch.equal(x, y) for x, y in zip(got[:3], want[:3]))
          and torch.equal(got[3][0][0], want[3][0][0]), "probe u64")
    check(torch.equal(got[0], hit & active), "probe u64: every hit found")
    check(torch.equal(bkeys[got[3][0][0]][got[0]], pk[got[0]]),
          "probe u64: payload row")
    return rows


def padded_build_keys(vals):
    """Sorted build keys padded to a power of two (at least 128) with the
    dtype's sentinel, as `ops/join.build` lays them out; returns (keys,
    real count)."""
    import torch
    s = torch.sort(vals).values
    nb = s.shape[0]
    cap = max(128, 1 << max(nb - 1, 0).bit_length())
    fill = float("inf") if s.dtype.is_floating_point \
        else torch.iinfo(torch.int64).max
    return torch.cat([s, torch.full((cap - nb,), fill, dtype=s.dtype,
                                    device=s.device)]), nb


def check_expand(B, key, kvalid, length, keys, nb, left, probe_cols,
                 payloads, sync, tag):
    """expand_counts and expand_gather against their plain versions: row
    maps, counts, offsets and every gathered column exactly. Returns the
    counts' outputs, the gather's column specs and its output capacity."""
    import torch
    got = B.expand_counts(key, kvalid, length, keys, nb, left)
    want = B.expand_counts_plain(key, kvalid, length, keys, nb, left)
    sync()
    for g_, w_, what in zip(got, want, ("lo", "mcounts", "offsets",
                                        "total")):
        check(torch.equal(g_, w_), f"expand_counts {tag}: {what}")
    total = int(want[3])
    out_cap = max(128, 1 << max(total - 1, 0).bit_length())
    cols = [(c, "probe") for c in probe_cols] \
        + [(d, "build") for d, _v in payloads] \
        + [(v, "build_valid") for _d, v in payloads]
    gk = B.expand_gather(*want, out_cap, keys.shape[0], cols)
    gp = B.expand_gather_plain(*want, out_cap, keys.shape[0], cols)
    sync()
    for i, (a, b) in enumerate(zip(gk, gp)):
        check(torch.equal(a, b), f"expand_gather {tag}: column {i}")
    return want, cols, out_cap


def k8_phase(B, device: str = "cuda") -> list:
    """The expanding join probe's kernels (K8) against their plain
    versions: at ds25's shape at SF1 (timed), a skewed build, LEFT with
    NULL probe keys, and 0 probes."""
    import torch
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(2525)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def rand(n):
        return torch.rand((n,), generator=g, device=dev, dtype=torch.float64)

    def randint(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=g, device=dev)

    # -- ds25's shape: 1,048,576 store_sales probes against a 4,809-row
    #    build whose keys repeat (1.6 rows per key), about 50,000 output
    #    rows; the probe block carries four columns (one nullable), the
    #    build three payloads (one nullable)
    n = 1 << 20
    # the block's live length rides on the device, as a DeviceBlock's
    # does (an int would cost a host-to-device copy inside the timing)
    length = torch.tensor(n, dtype=torch.int32, device=dev)
    keys, nb = padded_build_keys(randint(0, 3000, 4809))
    kcap = keys.shape[0]
    key = randint(0, 100_000, n)
    probe_cols = [key, randint(0, 1 << 40, n), rand(n) * 100, rand(n) > 0.1]
    payloads = [(randint(0, 1 << 40, kcap), None), (rand(kcap), None),
                (randint(0, 1 << 30, kcap), rand(kcap) > 0.2)]
    counts, cols, out_cap = check_expand(B, key, None, length, keys, nb,
                                         False, probe_cols, payloads, sync,
                                         "ds25")
    total = int(counts[3])
    check(30_000 < total < 80_000, f"ds25 shape: {total} output rows")
    lo, mcounts, offsets, tot = counts

    def lib_counts():
        return (torch.searchsorted(keys, key),
                torch.searchsorted(keys, key, right=True))
    cnt = torch.diff(offsets, append=tot.reshape(1))

    def lib_gather():
        # the output rows' probe row ids alone: a floor, not the gather
        return torch.repeat_interleave(cnt, output_size=total)
    in_w = sum(c.element_size() for c in probe_cols) \
        + sum(d.element_size() for d, _v in payloads)
    out_w = sum(c.element_size() for c in probe_cols) \
        + sum(d.element_size() + 1 for d, _v in payloads)
    rows = [dict(
        name="expand_counts", route="cuda",
        source="ydb_tpu_torch/ops/cuda/csrc/expand.cu",
        replaces="ydb_tpu/ops/join.py:404",
        shape=f"n={n} build={nb} (ds25, inner)", max_abs_err=0.0,
        ms=time_ms(lambda: B.expand_counts(key, None, length, keys, nb,
                                           False)),
        plain_ms=time_ms(lambda: B.expand_counts_plain(key, None, length,
                                                       keys, nb, False)),
        library_ms=time_ms(lib_counts),
        # key in, lo + mcounts + offsets out; the build keys once
        bound_ms=bound_ms(n * (8 + 4 + 4 + 8) + kcap * 8),
        bound_by="bytes"), dict(
        name="expand_gather", route="cuda",
        source="ydb_tpu_torch/ops/cuda/csrc/expand.cu",
        replaces="ydb_tpu/ops/join.py:427",
        shape=f"n={n} out={total} cols={len(cols)} (ds25)",
        max_abs_err=0.0,
        ms=time_ms(lambda: B.expand_gather(lo, mcounts, offsets, tot,
                                           out_cap, kcap, cols)),
        plain_ms=time_ms(lambda: B.expand_gather_plain(
            lo, mcounts, offsets, tot, out_cap, kcap, cols)),
        library_ms=time_ms(lib_gather),
        # the three row maps once, the probe and payload rows the outputs
        # take, the outputs once
        bound_ms=bound_ms(n * 16 + total * (in_w + out_w)),
        bound_by="bytes")]

    # -- skew: one key matching 100,000 build rows (8 probe rows hold it),
    #    the other keys 0 to 3 rows each
    bvals = torch.cat([torch.zeros(100_000, dtype=torch.int64, device=dev),
                       torch.repeat_interleave(
                           torch.arange(1, 300_001, device=dev),
                           randint(0, 4, 300_000))])
    skeys, snb = padded_build_keys(bvals)
    skey = torch.where(randint(0, n, n) < 8, 0, randint(1, 300_001, n))
    spay = [(randint(0, 1 << 40, skeys.shape[0]), None)]
    scounts, scols, scap = check_expand(B, skey, None, length, skeys, snb,
                                        False, [skey], spay, sync, "skew")
    st = int(scounts[3])
    sk_ms = time_ms(lambda: B.expand_counts(skey, None, length, skeys, snb,
                                            False))
    sk_lib = time_ms(lambda: (torch.searchsorted(skeys, skey),
                              torch.searchsorted(skeys, skey, right=True)))
    log(f"kernel expand skew: n={n} build={snb} out={st} "
        f"counts_ms={sk_ms:.4f} counts_plain_ms="
        f"{time_ms(lambda: B.expand_counts_plain(skey, None, length, skeys, snb, False)):.4f} "
        f"counts_library_ms={sk_lib:.4f} (two searchsorted) "
        f"counts_bound_us={bound_ms(n * 24 + skeys.shape[0] * 8) * 1e3:.2f} "
        f"gather_ms={time_ms(lambda: B.expand_gather(*scounts, scap, skeys.shape[0], scols)):.4f} "
        f"gather_plain_ms={time_ms(lambda: B.expand_gather_plain(*scounts, scap, skeys.shape[0], scols)):.4f} "
        f"gather_bound_us={bound_ms(n * 16 + st * 32) * 1e3:.2f} (bytes)")
    # -- LEFT with NULL probe keys and a shortened length; float keys;
    #    0 probes (LEFT and inner); checked, not timed
    kv = rand(n) > 0.05
    check_expand(B, key, kv, n - 777, keys, nb, True, probe_cols, payloads,
                 sync, "left nulls")
    fkeys, fnb = padded_build_keys(torch.round(rand(5000) * 4000) / 4)
    check_expand(B, torch.round(rand(n) * 8000) / 4, kv, n, fkeys, fnb, True,
                 [key], [(rand(fkeys.shape[0]), None)], sync, "float left")
    for left in (False, True):
        z = check_expand(B, key[:0], None, 0, keys, nb, left, [key[:0]],
                         payloads, sync, f"0 probes left={left}")
        check(int(z[0][3]) == 0, "0 probes: total")
    # one launch (the look-back across tiles): odd row counts, one tile,
    # a float skew with a hot key, LEFT at a shortened length, a
    # host-int length, and two calls equal
    for m in (1, 2047, 2049, 333_333):
        check_expand(B, key[:m], kv[:m], m - 1, keys, nb, m % 2 == 1,
                     [key[:m]], payloads, sync, f"n={m}")
    fsk, fsnb = padded_build_keys(bvals.to(torch.float64) / 8)
    check_expand(B, skey.to(torch.float64) / 8, kv, n - 12_345, fsk, fsnb,
                 True, [skey], [(rand(fsk.shape[0]), None)], sync,
                 "float skew left")
    before = B.LAUNCHES["expand_counts"]
    a1 = B.expand_counts(skey, None, length, skeys, snb, False)
    a2 = B.expand_counts(skey, None, length, skeys, snb, False)
    sync()
    check(B.LAUNCHES["expand_counts"] - before == 2
          and all(torch.equal(x, y) for x, y in zip(a1, a2)),
          "expand_counts: one launch a call, two calls equal")
    log("kernel expand_counts checks: ds25, skew, LEFT with NULLs, float "
        "keys, length < n, 0, 1, 2047, 2049 and 333,333 probes, a float "
        "skew, two calls equal: bit-equal to the plain version ok")
    return rows


def window_scan_bytes(perm, part_words, order_words, aggs) -> int:
    """window_scan's distinct input bytes plus its outputs: four int64
    structure columns and a value and a count per aggregate."""
    n = perm.shape[0]
    ins = [perm] + list(part_words) + list(order_words) \
        + [t for (_op, d, v) in aggs for t in (d, v)]
    return distinct_bytes(ins) + n * 8 * (4 + 2 * len(aggs))


def check_window_scan(B, perm, pw, ow, aggs, sync, tag) -> float:
    """window_scan against its plain version: starts, ends, ranks, counts,
    integer scans and min / max exactly, float sums to RTOL; and a
    second call bit for bit equal to the first (the float carries are
    folded in tile order, whichever tile published first). Returns the
    largest absolute difference of a float sum."""
    import torch
    got = B.window_scan(perm, pw, ow, aggs)
    again = B.window_scan(perm, pw, ow, aggs)
    want = B.window_scan_plain(perm, pw, ow, aggs)
    sync()
    check(same_bits(list(got[:4]) + [list(x) for x in got[4]],
                    list(again[:4]) + [list(x) for x in again[4]]),
          f"window_scan {tag}: two calls differ")
    for i, what in enumerate(("seg_start", "seg_end", "grp_start",
                              "dense")):
        check(torch.equal(got[i], want[i]), f"window_scan {tag}: {what}")
    err = 0.0
    for a, ((gv, gc), (wv, wc)) in enumerate(zip(got[4], want[4])):
        check(torch.equal(gc, wc), f"window_scan {tag}: count {a}")
        if aggs[a][0] == "sum" and gv.dtype == torch.float64:
            torch.testing.assert_close(gv, wv, rtol=RTOL, atol=0)
            if gv.numel():
                err = max(err, float((gv - wv).abs().max()))
        else:
            check(torch.equal(gv, wv), f"window_scan {tag}: scan {a}")
    return err


def k13_phase(B, ss: dict, device: str = "cuda") -> list:
    """The window scans (K13) against their plain version: over
    store_sales at SF1 (`ss`: its columns as tensors) partitioned by
    ss_item_sk and ordered by ss_sold_date_sk (timed), at ds89's frame
    (timed), one partition, every row its own partition, NULL values,
    and one partition of 2^22 + 333 rows (timed); every case called
    twice and the calls held bit for bit equal. Before them, K9 on
    random keys: the store_sales partition sort (timed against a stable
    sort of the hash word)."""
    import torch

    from ydb_tpu_torch.ops.sort import encode_key
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(8989)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def rand(n):
        return torch.rand((n,), generator=g, device=dev, dtype=torch.float64)

    def part_word(*cols):
        # the window lane's partition word (ops/window_dev.py)
        n = cols[0].shape[0]
        h = B.hash64([torch.zeros(n, dtype=torch.int64, device=dev)]
                     + list(cols), pre=[False] + [True] * len(cols))
        return B._lsr(h, 1)

    # -- store_sales: rank / dense_rank (structure), a running sum, a
    #    ROWS-frame avg's sum, a running max
    n = ss["ss_item_sk"].shape[0]
    pw = [part_word(ss["ss_item_sk"])]
    ow = [encode_key(ss["ss_sold_date_sk"])]
    perm = B.sort_perm(pw + ow, n, dev)
    # -- K9 on random keys: the window lane's partition sort of
    #    store_sales (the 63-bit partition hash, then the date word),
    #    against a stable sort of the hash word alone
    check(torch.equal(perm, B.sort_perm_plain(pw + ow, n, dev))
          and torch.equal(perm, B.sort_perm(pw + ow, n, dev)),
          "sort random keys (plain, two calls)")
    t_k = time_ms(lambda: B.sort_perm(pw + ow, n, dev))
    t_l = time_ms(lambda: torch.sort(pw[0], stable=True))
    log(f"kernel sort random keys (store_sales partition sort): n={n} "
        f"keys=2 kernel_ms={t_k:.4f} "
        f"plain_ms={time_ms(lambda: B.sort_perm_plain(pw + ow, n, dev)):.4f} "
        f"library_ms={t_l:.4f} kernel/library={t_k / t_l:.3f} "
        f"bound_us={bound_ms(n * 8 * 2 + n * 4) * 1e3:.2f} (bytes)")
    aggs = [("sum", ss["ss_ext_sales_price"], None),
            ("sum", ss["ss_sales_price"], None),
            ("max", ss["ss_net_profit"], None)]
    err = check_window_scan(B, perm, pw, ow, aggs, sync, "store_sales")

    def lib():
        return ([torch.cumsum(d, 0) for (op, d, _v) in aggs if op == "sum"]
                + [torch.cummax(d, 0) for (op, d, _v) in aggs if op == "max"])
    rows = [dict(
        name="window_scan", route="cuda",
        source="ydb_tpu_torch/ops/cuda/csrc/window_scan.cu",
        replaces="ydb_tpu/ops/window_dev.py:202",
        shape=f"n={n} partitions=ss_item_sk order=ss_sold_date_sk aggs=3 "
              "(store_sales SF1)",
        max_abs_err=err,
        ms=time_ms(lambda: B.window_scan(perm, pw, ow, aggs)),
        plain_ms=time_ms(lambda: B.window_scan_plain(perm, pw, ow, aggs)),
        library_ms=time_ms(lib),
        bound_ms=bound_ms(window_scan_bytes(perm, pw, ow, aggs)),
        bound_by="bytes")]

    # -- ds89's frame: 82,881 rows of (category, brand, store, month),
    #    partitions of 12 months, whole-partition avg(ssp)
    m = 82_881
    pid = torch.randperm(m, generator=g, device=dev) // 12
    pw9 = [part_word(pid % 2, pid, pid % 57)]
    perm9 = B.sort_perm(pw9, m, dev)
    check(torch.equal(perm9, B.sort_perm_plain(pw9, m, dev)),
          "sort ds89 partition sort")
    log(f"kernel sort ds89 partition sort: n={m} keys=1 "
        f"kernel_ms={time_ms(lambda: B.sort_perm(pw9, m, dev)):.4f} "
        f"library_ms={time_ms(lambda: torch.sort(pw9[0], stable=True)):.4f} "
        f"bound_us={bound_ms(m * 8 + m * 4) * 1e3:.2f} (bytes)")
    aggs9 = [("sum", rand(m) * 1e4, None)]
    check_window_scan(B, perm9, pw9, [], aggs9, sync, "ds89")
    log(f"kernel window_scan ds89 frame: n={m} "
        f"kernel_ms={time_ms(lambda: B.window_scan(perm9, pw9, [], aggs9)):.4f} "
        f"plain_ms={time_ms(lambda: B.window_scan_plain(perm9, pw9, [], aggs9)):.4f} "
        f"library_ms={time_ms(lambda: torch.cumsum(aggs9[0][1], 0)):.4f} "
        f"bound_us={bound_ms(window_scan_bytes(perm9, pw9, [], aggs9)) * 1e3:.2f} (bytes)")

    # -- one partition; every row its own partition; NULL values with
    #    every scan; a partial last tile; more aggregates than one launch
    #    takes; checked, not timed
    k = (1 << 20) + 333
    vals = rand(k) * 200 + 1          # float sums of one sign, as prices:
    signed = rand(k) * 200 - 100      # no prefix cancels towards 0
    ints = torch.randint(-1000, 1000, (k,), generator=g, device=dev)
    valid = rand(k) > 0.2
    every = [("sum", vals, valid), ("sum", ints, valid),
             ("min", signed, valid), ("max", signed, None),
             ("min", ints, None), ("max", ints, valid)]
    order = [encode_key(torch.randint(0, 90, (k,), generator=g,
                                      device=dev))]
    for tag, words in (("one partition", [part_word(ints * 0)]),
                       ("singletons", [part_word(torch.arange(
                           k, device=dev))]),
                       ("nulls", [part_word(ints % 300)])):
        p_ = B.sort_perm(words + order, k, dev)
        check_window_scan(B, p_, words, order, every, sync, tag)
    check_window_scan(B, p_, words, order, every * 3, sync, "chunked")
    # -- one partition over 2^22 + 333 rows: every tile's carry comes
    #    from the walk back over the tiles before it
    k = (1 << 22) + 333
    vals = rand(k) * 200 + 1
    ints = torch.randint(-1000, 1000, (k,), generator=g, device=dev)
    valid = rand(k) > 0.2
    longest = [("sum", vals, valid), ("sum", ints, None),
               ("max", rand(k) - 0.5, valid)]
    words = [part_word(ints * 0)]
    order = [encode_key(torch.randint(0, 90, (k,), generator=g,
                                      device=dev))]
    p_ = B.sort_perm(words + order, k, dev)
    check_window_scan(B, p_, words, order, longest, sync, "one partition "
                      f"of {k} rows")
    log(f"kernel window_scan one partition: n={k} aggs={len(longest)} "
        f"kernel_ms={time_ms(lambda: B.window_scan(p_, words, order, longest)):.4f} "
        f"bound_us={bound_ms(window_scan_bytes(p_, words, order, longest)) * 1e3:.2f} "
        "(bytes); checked against the plain version, two calls bit for "
        "bit")
    return rows


K13_SQL = """select ss_ticket_sk, ss_item_sk, ss_sold_date_sk,
  rank() over (partition by ss_item_sk order by ss_sold_date_sk) as rk,
  dense_rank() over (partition by ss_item_sk order by ss_sold_date_sk)
    as drk,
  sum(ss_ext_sales_price) over (partition by ss_item_sk
    order by ss_sold_date_sk) as run_sum,
  avg(ss_sales_price) over (partition by ss_item_sk order by ss_sold_date_sk
    rows between 2 preceding and current row) as ma3,
  max(ss_net_profit) over (partition by ss_item_sk
    order by ss_sold_date_sk) as run_max,
  lag(ss_sales_price) over (partition by ss_item_sk
    order by ss_sold_date_sk) as prev
from store_sales
order by run_sum desc, ss_ticket_sk
limit 100"""


def k13_oracle(raw: dict):
    """K13_SQL in pandas over the generated store_sales (in its row
    order, which is the table's): windows per item in date order, ties
    in row order."""
    import pandas as pd
    f = pd.DataFrame({c: raw["store_sales"][c] for c in (
        "ss_ticket_sk", "ss_item_sk", "ss_sold_date_sk", "ss_ext_sales_price",
        "ss_sales_price", "ss_net_profit")})
    s = f.sort_values(["ss_item_sk", "ss_sold_date_sk"], kind="stable")
    g = s.groupby("ss_item_sk", sort=False)
    out = pd.DataFrame({
        "ss_ticket_sk": s.ss_ticket_sk, "ss_item_sk": s.ss_item_sk,
        "ss_sold_date_sk": s.ss_sold_date_sk,
        "rk": g.ss_sold_date_sk.rank(method="min").astype("int64"),
        "drk": g.ss_sold_date_sk.rank(method="dense").astype("int64"),
        "run_sum": g.ss_ext_sales_price.cumsum(),
        "ma3": g.ss_sales_price.rolling(3, min_periods=1).mean()
        .reset_index(level=0, drop=True),
        "run_max": g.ss_net_profit.cummax(),
        "prev": g.ss_sales_price.shift(1)})
    return out.sort_values(["run_sum", "ss_ticket_sk"],
                           ascending=[False, True],
                           kind="stable").head(100).reset_index(drop=True)


def partition_bytes(n: int, cols, nparts: int, out_rows=None,
                    ids: bool = False) -> int:
    """partition's bytes: the hashes in, the ids out when they are asked
    for (the paths do not ask), each moved column read and written once,
    the zero tail (out_rows - n) of each column written once, the counts
    out."""
    width = sum(c.element_size() for c in cols)
    tail = (n if out_rows is None else out_rows) - n
    return n * (8 + (4 if ids else 0)) + 2 * n * width + tail * width \
        + 8 * nparts


def check_partition(B, h, length, nparts: int, cols, sync, tag,
                    out_rows=None):
    """partition against its plain version: ids, counts and every moved
    column exactly (floats bit for bit, NaNs included). Returns the plain
    version's outputs."""
    import torch
    got = B.partition(h, length, nparts, cols, out_rows)
    want = B.partition_plain(h, length, nparts, cols, out_rows)
    sync()
    check(torch.equal(got[0], want[0]), f"partition {tag}: ids")
    check(torch.equal(got[1], want[1]), f"partition {tag}: counts")
    for i, (a, b) in enumerate(zip(got[2], want[2])):
        if a.dtype == torch.float64:
            a, b = a.view(torch.int64), b.view(torch.int64)
        check(torch.equal(a, b), f"partition {tag}: column {i}")
    return want


def partition_phase(B, feed, li: dict, n: int, live: int,
                    device: str = "cuda") -> list:
    """The partition kernel (K14) against its plain version: at the
    largest spill feed of the beyond-budget path (`feed`: its block,
    keys and partitions; timed), at a GraceJoin routing of lineitem's
    superblock rows by l_orderkey into 8 partitions (`li`: lineitem
    columns padded to `n` rows, `live` real; timed), and checked at 1
    and 256 partitions, 0 live rows, nullable and float keys, two key
    columns, more columns than one launch moves and 0 rows."""
    import torch

    from ydb_tpu_torch.ops import spill as SP
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(1414)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def randint(lo, hi, m):
        return torch.randint(lo, hi, (m,), generator=g, device=dev)

    def lib(ids, cols):
        order = torch.sort(ids, stable=True).indices
        return [c.index_select(0, order) for c in cols]

    # -- the largest spill feed of the beyond-budget path
    dblock, keys, nparts, query = feed
    arrays = {k: v.contiguous() for k, v in dblock.arrays.items()}
    valids = {k: v.contiguous() for k, v in dblock.valids.items()}
    h = SP.key_hashes(arrays, valids, keys)
    cols = list(arrays.values()) + list(valids.values())
    m = h.shape[0]
    want = check_partition(B, h, dblock.length, nparts, cols, sync,
                           "spill feed")
    ids = want[0]
    # timed as the paths call it: no ids
    rows = [dict(
        name="partition", route="cuda",
        source="ydb_tpu_torch/ops/cuda/csrc/partition.cu",
        replaces="ydb_tpu/ops/spill.py:35",
        shape=f"n={m} live={int(dblock.length)} keys={len(keys)} "
              f"nparts={nparts} cols={len(cols)} (largest spill feed, "
              f"{query}; no ids)",
        max_abs_err=0.0,
        ms=time_ms(lambda: B.partition(h, dblock.length, nparts, cols,
                                       ids=False)),
        plain_ms=time_ms(lambda: B.partition_plain(h, dblock.length, nparts,
                                                   cols, ids=False)),
        library_ms=time_ms(lambda: lib(ids, cols)),
        bound_ms=bound_ms(partition_bytes(m, cols, nparts)),
        bound_by="bytes")]

    # -- GraceJoin routing: lineitem's superblock rows by l_orderkey into
    #    8 partitions, the block's columns moved into 2n-row buffers as the
    #    executor moves them (no ids; the zero tail of n rows written)
    length = torch.tensor(live, dtype=torch.int32, device=dev)
    hk = B.hash64([SP.as_int64(li["l_orderkey"])])
    lcols = list(li.values())
    want = check_partition(B, hk, length, 8, lcols, sync, "grace routing",
                           out_rows=2 * n)
    gids = want[0]
    plan = B.partition_plan(n, 8, len(lcols), 2 * n)
    # the kernels a call launches, counted in a graph capture of three
    # calls
    captured = captured_kernels(lambda: B.partition(
        hk, length, 8, lcols, 2 * n, ids=False), calls=3)
    ours = {k: c for k, c in captured.items()
            if "part_census" in k or "part_scatter" in k}
    rest = {k: c for k, c in captured.items() if k not in ours}
    n_kern, n_rest = sum(ours.values()) / 3, sum(rest.values()) / 3
    check(n_kern == plan["launches"],
          f"partition routing: {n_kern} kernels a call captured, the plan "
          f"says {plan['launches']}: {captured}")
    check(n_rest <= 1,
          f"partition routing: more than one launch a call besides its "
          f"kernels: {rest}")
    rows.append(dict(
        name="partition", route="cuda",
        source="ydb_tpu_torch/ops/cuda/csrc/partition.cu",
        replaces="ydb_tpu/query/executor.py:2151",
        shape=f"n={n} live={live} nparts=8 cols={len(lcols)} "
              f"out_rows={2 * n} "
              f"(GraceJoin routing of lineitem by l_orderkey; no ids; "
              f"captured: {n_kern:g} kernel launches a call, "
              f"{n_rest:g} fill of the control words)",
        max_abs_err=0.0,
        ms=time_ms(lambda: B.partition(hk, length, 8, lcols, 2 * n,
                                       ids=False)),
        plain_ms=time_ms(lambda: B.partition_plain(hk, length, 8, lcols,
                                                   2 * n, ids=False)),
        library_ms=time_ms(lambda: lib(gids, lcols)),
        bound_ms=bound_ms(partition_bytes(n, lcols, 8, 2 * n)),
        bound_by="bytes"))
    r = rows[-1]
    log(f"kernel partition grace routing: n={n} live={live} nparts=8 "
        f"cols={len(lcols)} (lineitem by l_orderkey) "
        f"captured_3_calls={captured} kernel_ms={r['ms']:.4f} "
        f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
        f"bound_us={r['bound_ms'] * 1e3:.2f} (bytes: the hashes, each "
        "column read and written once, the zero tail of n rows, no ids)")
    top = float((hk < 0).to(torch.float64).mean())
    check(top > 0.4, f"partition: {top} of the hashes >= 2^63")

    # -- checked, not timed: 1 and 256 partitions, 0 live rows, nullable
    #    keys (the NULL sentinel), float keys with NaN, ±inf and -0.0, two
    #    key columns, a partial last tile, the multi-launch form, 0 rows
    m = (1 << 20) + 333
    ki = randint(-(1 << 62), 1 << 62, m)
    kv = randint(0, 10, m) > 1
    kf = torch.tensor([float("nan"), float("inf"), float("-inf"), -0.0, 0.0,
                       1.5, -2.5, 1e300], dtype=torch.float64,
                      device=dev)[randint(0, 8, m)]
    vals = [ki, kf, kv, randint(0, 1 << 30, m).to(torch.int32)]
    hk1 = SP.key_hashes({"k": ki}, {}, ["k"])
    cases = [("1 partition", hk1, m, 1), ("256 partitions", hk1, m - 999, 256),
             ("0 live rows", hk1, 0, 16),
             ("nullable key", SP.key_hashes({"k": ki}, {"k": kv}, ["k"]), m,
              32),
             ("float key", SP.key_hashes({"f": kf}, {}, ["f"]), m, 8),
             ("two keys", SP.key_hashes({"k": ki, "f": kf}, {"k": kv},
                                        ["k", "f"]), m - 1, 64)]
    for tag, hh, ln, parts in cases:
        check_partition(B, hh, ln, parts, vals, sync, tag)
    check_partition(B, cases[0][1], m, 4, vals * 9, sync, "36 columns")
    z = check_partition(B, ki[:0], 0, 8, [v[:0] for v in vals], sync,
                        "0 rows")
    check(int(z[1].sum()) == 0, "partition 0 rows: counts")
    partition_checks(B, device)
    return rows


def segments_bytes(keys, cols, ndev: int, seg: int) -> int:
    """segments' bytes: the keys and every column's data and valid read
    once (a tensor shared by several operands once), each of the ndev x
    seg slots of every output written once, the counts and the flag."""
    ins = distinct_bytes([k for k, _v in keys] + [v for _k, v in keys]
                         + [d for d, _v in cols] + [v for _d, v in cols])
    outs = ndev * seg * sum(d.element_size() + 1 for d, _v in cols)
    return ins + outs + 4 * ndev + 1


def check_segments(B, length, ndev: int, seg: int, cols, sync, tag,
                   keys=None, targets=None):
    """segments against its plain version: counts, the overflow flag and
    every slot of every output, data (floats bit for bit) and valid.
    Returns the plain version's outputs."""
    import torch
    got = B.segments(length, ndev, seg, cols, keys=keys, targets=targets)
    want = B.segments_plain(length, ndev, seg, cols, keys=keys,
                            targets=targets)
    sync()
    check(torch.equal(got[1], want[1]), f"segments {tag}: counts "
          f"{got[1].tolist()} != {want[1].tolist()}")
    check(bool(got[2]) == bool(want[2]), f"segments {tag}: overflow")
    for i, ((gd, gv), (wd, wv)) in enumerate(zip(got[0], want[0])):
        if gd.dtype.is_floating_point:
            gd, wd = gd.view(torch.int64 if gd.element_size() == 8
                             else torch.int32), \
                wd.view(torch.int64 if wd.element_size() == 8
                        else torch.int32)
        check(torch.equal(gd, wd), f"segments {tag}: column {i} data")
        check(torch.equal(gv, wv), f"segments {tag}: column {i} valid")
    return want


def segments_phase(B, calls: dict, device: str = "cuda") -> list:
    """The segments kernel (K15a) against its plain version: at the two
    shapes the mesh paths gave it (`calls`, recorded by `MeshRecorder`):
    the largest probe-row routing of the shuffle join (timed, the table's
    row) and q18's partial aggregate (timed); then checked at 3 and 8
    targets, a clamped seg (overflow), 0 live rows, 0 rows, int32, float
    (NaN, ±inf, out-of-range) and three nullable keys, given targets, the
    targets alone (`segment_targets`, the reference's `bucket_of`) and
    more columns than one launch moves."""
    import torch

    from ydb_tpu_torch.ops import spill as SP
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(1515)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def randint(lo, hi, m, dtype=torch.int64):
        return torch.randint(lo, hi, (m,), generator=g, device=dev,
                             dtype=dtype)

    def lib(tgt, length, ndev, cols):
        # the floor of a library formulation: a stable sort of the live
        # rows' targets and one index_select per column (no [ndev, seg]
        # layout, no clamp)
        n = tgt.shape[0]
        ids = torch.where(torch.arange(n, device=tgt.device) < length, tgt,
                          torch.full_like(tgt, ndev))
        order = torch.sort(ids, stable=True).indices
        return [c.index_select(0, order) for d, v in cols
                for c in ((d,) if v is None else (d, v))]

    rows = []
    for tag, label in (("join", "the shuffle join's largest probe-row "
                        "routing"), ("q18", "q18's partial aggregate")):
        check(tag in calls, f"segments: no {label} recorded on the mesh "
              "paths")
        query, (length, ndev, seg, cols, keys) = calls[tag]
        n = cols[0][0].shape[0]
        live = int(length)
        want = check_segments(B, length, ndev, seg, cols, sync,
                              f"{tag} ({query})", keys=keys)
        tgt = B.segment_targets(keys, ndev)
        plan = B.segments_plan(n, ndev, seg, len(cols))
        # the kernels a call launches, counted in a graph capture of
        # three calls: the scatter, and nothing else
        captured = captured_kernels(lambda: B.segments(
            length, ndev, seg, cols, keys=keys), calls=3)
        ours = {k: c for k, c in captured.items() if "seg_scatter" in k}
        rest = {k: c for k, c in captured.items() if k not in ours}
        n_kern = sum(ours.values()) / 3
        check(n_kern == plan["launches"] == 1,
              f"segments {tag}: {n_kern} kernels a call captured, the plan "
              f"says {plan['launches']}: {captured}")
        check(not rest, f"segments {tag}: device work besides its kernels: "
              f"{rest}")
        shape = (f"n={n} live={live} keys={len(keys)} ndev={ndev} "
                 f"seg={seg} cols={len(cols)} ({label}, {query}; captured: "
                 f"{n_kern:g} kernel launches a call)")
        row = dict(
            name="segments", route="cuda",
            source="ydb_tpu_torch/ops/cuda/csrc/segments.cu",
            replaces="ydb_tpu/parallel/collective.py:56",
            shape=shape, max_abs_err=0.0,
            ms=time_ms(lambda: B.segments(length, ndev, seg, cols,
                                          keys=keys)),
            plain_ms=time_ms(lambda: B.segments_plain(length, ndev, seg,
                                                      cols, keys=keys)),
            library_ms=time_ms(lambda: lib(tgt, length, ndev, cols)),
            bound_ms=bound_ms(segments_bytes(keys, cols, ndev, seg)),
            bound_by="bytes")
        check(not bool(want[2]), f"segments {tag}: overflow")
        if tag == "join":
            check(int(want[1].sum()) == live, "segments join: counts")
        rows.append(row)
        log(f"kernel segments {tag}: {shape} kernel_ms={row['ms']:.4f} "
            f"plain_ms={row['plain_ms']:.4f} "
            f"library_ms={row['library_ms']:.4f} "
            f"bound_us={row['bound_ms'] * 1e3:.2f} (bytes) "
            f"captured_3_calls={captured}")

    # -- checked, not timed
    m = (1 << 20) + 333
    ki = randint(-(1 << 62), 1 << 62, m)
    kv = randint(0, 10, m) > 1
    kc = randint(-1, 5000, m, torch.int32)
    kf = torch.tensor([float("nan"), float("inf"), float("-inf"), -0.0, 0.0,
                       1.5, -2.5, 1e300, -1e300, 9.3e18], dtype=torch.float64,
                      device=dev)[randint(0, 10, m)]
    vals = [(ki, kv), (kf, None), (kc, kv),
            (randint(0, 1 << 30, m).to(torch.int32), None),
            (kv.clone(), None)]
    cases = [("3 targets", [(ki, None)], m, 3, m),
             ("8 targets, nullable", [(ki, kv)], m - 999, 8, m),
             ("clamped seg", [(ki, None)], m, 4, m // 5),
             ("0 live rows", [(ki, None)], 0, 4, 1024),
             ("int32 codes", [(kc, kv)], m, 4, m),
             ("float key", [(kf, None)], m, 4, m),
             ("three keys", [(ki, kv), (kc, None), (kf, kv)], m - 1, 7, m)]
    for tag, keys, ln, ndev, seg in cases:
        w = check_segments(B, ln, ndev, seg, vals, sync, tag, keys=keys)
        if tag == "clamped seg":
            check(bool(w[2]), "segments clamped seg: no overflow")
        check(torch.equal(B.segment_targets(keys, ndev),
                          B.segment_targets_plain(keys, ndev)),
              f"segment_targets {tag}")
    tgt = B.segment_targets([(ki, kv)], 4)
    check_segments(B, m, 4, m, vals, sync, "given targets", targets=tgt)
    check_segments(B, m, 4, m, vals * 8, sync, "40 columns",
                   keys=[(ki, None)])
    z = check_segments(B, 0, 4, 16, [(v[:0], None) for v, _ in vals], sync,
                       "0 rows", keys=[(ki[:0], None)])
    check(int(z[1].sum()) == 0, "segments 0 rows: counts")
    top = float((B.splitmix64_plain(SP.as_int64(ki)) < 0)
                .to(torch.float64).mean())
    check(top > 0.4, f"segments: {top} of the hashes >= 2^63")
    return rows


class MeshRecorder:
    """What the mesh paths did in each query run, read by wrapping (not
    changing) the port's functions while the paths run: the device ms of
    the `segments` calls and of the exchanges (CUDA events around each
    call), and the inputs of two `segments` calls that `segments_phase`
    times, taken on cold runs: the probe-row routing of a shuffle join
    with the most live rows, and q18's routing of its subquery's
    l_orderkey groups on the distributed lane.
    `view(suite)` is the recorder a suite of `slice_phase` takes."""

    def __init__(self, bindings):
        import torch

        from ydb_tpu_torch.parallel import shuffle, shuffle_join
        self.calls = {}
        self.grace = []                 # no GraceJoin on the mesh lanes
        self.query = self.suite = ""
        self.in_join = self.cold = False
        self._events = {"segments": [], "exchange": []}
        self.exchange_bytes = 0
        self._restore = []
        rec = self

        def timed(kind, real, record=False):
            def fn(*a, **k):
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                out = real(*a, **k)
                e.record()
                rec._events[kind].append((s, e))
                if record:
                    rec._record(*a, **k)
                return out
            return fn

        def exchanged(real):
            inner = timed("exchange", real)

            def fn(per_dev, names, devices):
                # K15b's byte bound: every stacked segment (data, valid,
                # counts) read once and written once
                rec.exchange_bytes += 2 * sum(
                    t.numel() * t.element_size() for d, v, c in per_dev
                    for t in [*d.values(), *v.values(), c] if t is not None)
                return inner(per_dev, names, devices)
            return fn

        def joining(real):
            def run(*a, **k):
                rec.in_join = True
                try:
                    return real(*a, **k)
                finally:
                    rec.in_join = False
            return run

        for owner, name, wrapper in (
                (bindings, "segments",
                 lambda r: timed("segments", r, True)),
                (shuffle, "exchange_segments", exchanged),
                (shuffle_join, "exchange_segments", exchanged),
                (shuffle_join.ShuffleJoin, "run", joining)):
            real = getattr(owner, name)
            self._restore.append((owner, name, real))
            setattr(owner, name, wrapper(real))

    def _record(self, length, ndev, seg, cols, *, keys=None, targets=None):
        if not self.cold:
            return
        if self.in_join:
            tag = "join"
        elif self.suite == "tpch_mesh" and self.query == "q18" \
                and len(keys) == 1:
            tag = "q18"              # its subquery's l_orderkey groups
        else:
            return
        # the live rows decide (read on cold runs only, whose walls the
        # builds dominate anyway)
        size = (int(length), len(cols))
        old = self.calls.get(tag)
        if old is None or size > old[2]:
            self.calls[tag] = (self.query, (length, ndev, seg, list(cols),
                                            list(keys)), size)

    def view(self, suite: str):
        rec = self

        class View:
            grace = rec.grace

            def start(self, query: str) -> None:
                rec.cold = (suite, query) != (rec.suite, rec.query)
                rec.suite, rec.query = suite, query
                rec.exchange_bytes = 0
                for v in rec._events.values():
                    v.clear()

            def note(self) -> str:
                return rec.note()
        return View()

    def note(self) -> str:
        parts = []
        for kind, evs in self._events.items():
            ms = sum(s.elapsed_time(e) for s, e in evs)
            parts.append(f"{kind}_ms={ms:.3f} ({len(evs)} calls)")
            evs.clear()
        parts.append(f"exchange_bytes={self.exchange_bytes} "
                     f"exchange_bound_ms="
                     f"{bound_ms(self.exchange_bytes):.4f}")
        self.exchange_bytes = 0
        return " ".join(parts)

    def close(self) -> None:
        for owner, name, real in reversed(self._restore):
            setattr(owner, name, real)
        self._restore = []
        self.calls = {k: v[:2] for k, v in self.calls.items()}


class LaneRecorder:
    """What the beyond-budget lanes did in each query run, read by
    wrapping (not changing) the port's functions while the path runs:
    the partition counts of each GraceJoin build (`build_partitioned`)
    and spill store (`PartitionStore`), the tiles streamed
    (`Executor._stack_tile`) and the host time spent stacking and
    queueing their uploads, the spilled rows (`executor/spilled_rows`),
    and the largest spill feed of the whole path (by live rows times
    columns),
    which the kernel phase then checks and times."""

    def __init__(self, executor):
        from ydb_tpu_torch.ops import join as J
        from ydb_tpu_torch.ops import spill as SP
        self.largest = None
        self.query = ""
        self._restore = []
        rec = self

        def wrap(owner, name, fn):
            real = getattr(owner, name)
            self._restore.append((owner, name, real))
            setattr(owner, name, fn(real))

        def builds(real):
            def bp(*a, **k):
                out = real(*a, **k)
                rec.grace.append(out.n_partitions)
                return out
            return bp

        def feed(real):
            def fd(store, dblock):
                if not any(s is store for s in rec.stores):
                    rec.stores.append(store)
                # the feed reads its block back right after: reading the
                # live length here adds no wait of its own
                size = (int(dblock.length) * (len(dblock.arrays)
                                              + len(dblock.valids)),
                        dblock.capacity)
                if rec.largest is None or size > rec.largest[0]:
                    rec.largest = (size, (dblock, store.key_names,
                                          store.nparts, rec.query))
                return real(store, dblock)
            return fd

        def tiles(real):
            def st(*a, **k):
                t0 = time.perf_counter()
                out = real(*a, **k)
                rec.tiles += 1
                rec.stack_s += time.perf_counter() - t0
                return out
            return st
        wrap(J, "build_partitioned", builds)
        wrap(SP.PartitionStore, "feed", feed)
        self._restore.append((executor, "_stack_tile", None))
        executor._stack_tile = tiles(executor._stack_tile)
        self.start("")

    def start(self, query: str) -> None:
        from ydb_tpu_torch.utils.metrics import GLOBAL
        self.query = query
        self.grace, self.stores, self.tiles, self.stack_s = [], [], 0, 0.0
        self._spilled0 = GLOBAL.get("executor/spilled_rows")

    def note(self) -> str:
        from ydb_tpu_torch.utils.metrics import GLOBAL
        return (f"spilled_rows={GLOBAL.get('executor/spilled_rows') - self._spilled0} "
                f"tiles={self.tiles} stack_ms={self.stack_s * 1e3:.2f} "
                f"grace_partitions={self.grace} "
                f"spill_partitions={[s.nparts for s in self.stores]}")

    def close(self) -> None:
        for owner, name, real in reversed(self._restore):
            if real is None:
                delattr(owner, name)
            else:
                setattr(owner, name, real)


class MediumLaneRecorder:
    """The medium-domain lane (K4) in each query run, read by wrapping
    (not changing) `torch_exec._groupby_medium_domain` while the path
    runs: its calls, and its device ms between CUDA events recorded at
    the lane's entry and at its return (the card's time from the lane's
    first queued kernel to its last)."""

    def __init__(self):
        import torch

        from ydb_tpu_torch.ops import torch_exec as X
        self._X, self._real = X, X._groupby_medium_domain
        self.calls = 0
        rec = self

        def lane(*a, **k):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = rec._real(*a, **k)
            e.record()
            rec.events.append((s, e))
            return out
        X._groupby_medium_domain = lane
        self.start("")

    def start(self, query: str) -> None:
        self.grace, self.events = [], []

    def note(self) -> str:
        for _s, e in self.events:
            e.synchronize()
        self.calls += len(self.events)
        return (f"medium_lane_calls={len(self.events)} lane_device_ms="
                f"{sum(s.elapsed_time(e) for s, e in self.events):.4f}")

    def close(self) -> None:
        self._X._groupby_medium_domain = self._real


# the two extra queries of the reference's tiled-lane test
# (tests/test_tiled.py), run on the beyond-budget path
BEYOND_EXTRA = {
    "spill1": "select l_orderkey, sum(l_quantity) as q from lineitem "
              "group by l_orderkey order by q desc, l_orderkey limit 25",
    "union1": "select l_orderkey, l_quantity from lineitem "
              "where l_quantity >= 49",
}


def beyond_oracle(name: str, data):
    """The answers of `BEYOND_EXTRA`'s queries."""
    import pandas as pd
    li = pd.DataFrame({c: data.tables["lineitem"][c]
                       for c in ("l_orderkey", "l_quantity")})
    if name == "spill1":
        w = li.groupby("l_orderkey").l_quantity.sum().reset_index()
        w = w.sort_values(["l_quantity", "l_orderkey"],
                          ascending=[False, True], kind="stable").head(25)
        return w.rename(columns={"l_quantity": "q"})
    return li[li.l_quantity >= 49]


# the device budgets of the beyond-budget path: the reference's defaults
# (ydb_tpu/query/executor.py:106-121) over 100, so SF1 crosses them as
# SF100 crosses the defaults on one card
BEYOND_BUDGETS = {"fused_scan_budget_bytes": (6 << 30) // 100,
                  "tile_budget_bytes": (1 << 30) // 100,
                  "merge_budget_bytes": (1 << 30) // 100,
                  "grace_budget_bytes": (1 << 29) // 100}


# --------------------------------------------------------------------------
# the batched serving lane: member-axis kernel entries
# --------------------------------------------------------------------------


def batched_agg_bytes(kid, nb: int, masks, aggs) -> int:
    """bucket_agg_batched's distinct input bytes (a shared column once)
    plus its (B, nb) outputs."""
    Bm = masks.shape[0]
    ins = [kid, masks] + [t for (_f, d, v, _u) in aggs for t in (d, v)]
    return distinct_bytes(ins) + Bm * nb * 8 * (2 * len(aggs) + 1)


def check_bucket_agg_batched(B, kid, nb, masks, aggs, sync, tag) -> float:
    """bucket_agg_batched against its plain version; returns the largest
    absolute difference of a float sum."""
    import torch
    kv, kc, kp = B.bucket_agg_batched(kid, nb, masks, aggs)
    pv, pc, pp = B.bucket_agg_batched_plain(kid, nb, masks, aggs)
    sync()
    check(torch.equal(kp, pp), f"bucket_agg_batched {tag} present")
    err = 0.0
    for i, (f, d, _v, _u) in enumerate(aggs):
        check(torch.equal(kc[i], pc[i]), f"bucket_agg_batched {tag} cnt {i}")
        if f == "sum" and d.dtype == torch.float64:
            torch.testing.assert_close(kv[i], pv[i], rtol=RTOL, atol=0)
            err = max(err, float((kv[i] - pv[i]).abs().max()))
        else:
            check(torch.equal(kv[i], pv[i]),
                  f"bucket_agg_batched {tag} {f} {i}")
    return err


def check_segment_agg_batched(B, perm, keys, masks, aggs, oc, sync,
                              tag) -> float:
    import torch
    kn, kl, kp, kv, kc = B.segment_agg_batched(perm, keys, masks, aggs, oc)
    pn, pl, pp, pv, pc = B.segment_agg_batched_plain(perm, keys, masks,
                                                     aggs, oc)
    sync()
    check(torch.equal(kn, pn), f"segment_agg_batched {tag} ngroups")
    check(torch.equal(kl, pl), f"segment_agg_batched {tag} lead")
    check(torch.equal(kp, pp), f"segment_agg_batched {tag} present")
    err = 0.0
    for i, (f, d, _v, _u) in enumerate(aggs):
        check(torch.equal(kc[i], pc[i]), f"segment_agg_batched {tag} cnt {i}")
        if f == "sum" and d.dtype == torch.float64:
            torch.testing.assert_close(kv[i], pv[i], rtol=RTOL, atol=0)
            err = max(err, float((kv[i] - pv[i]).abs().max()))
        else:
            check(torch.equal(kv[i], pv[i]),
                  f"segment_agg_batched {tag} {f} {i}")
    return err


def check_compact_batched(B, cols, masks, lengths, n, new_cap, sync, tag):
    """compact_batched against its plain version: live, new_len and
    overflow exactly, and every member's live prefix [0, new_len)
    exactly (the kernel leaves the rest of its row undefined)."""
    import torch
    Bm = masks.shape[0]
    ko, kl, kn, kf = B.compact_batched(cols, masks, lengths, n, new_cap, Bm)
    po, pl, pn, pf = B.compact_batched_plain(cols, masks, lengths, n,
                                             new_cap, Bm)
    sync()
    check(torch.equal(kl, pl) and torch.equal(kn, pn)
          and torch.equal(kf, pf), f"compact_batched {tag} lengths")
    live = torch.arange(new_cap, device=kn.device)[None, :] \
        < kn.to(torch.int64)[:, None]
    for a, b in zip(ko, po):
        zero = torch.zeros((), dtype=a.dtype, device=a.device)
        check(torch.equal(torch.where(live, a, zero),
                          torch.where(live, b, zero)),
              f"compact_batched {tag} column")
    return int(kl.sum())


def zero_fill_bytes(fn) -> int:
    """Bytes that one call of `fn` allocates through `torch.zeros` (after
    a first call, so per-stream scratch made once is not counted): what a
    wrapper clears beyond its kernel's own writes."""
    import torch
    fn()
    real, seen = torch.zeros, []

    def zeros(*a, **k):
        t = real(*a, **k)
        seen.append(t.numel() * t.element_size())
        return t
    torch.zeros = zeros
    try:
        fn()
    finally:
        torch.zeros = real
    return sum(seen)


def compact_batched_bytes(masks, live: int, cols) -> int:
    """compact's bound extended by the member axis: each member's mask
    read once, each live row of every column read once and written
    once (n + 2 * nlive * width per member)."""
    return masks.numel() + 2 * live * sum(c.element_size() for c in cols)


def batched_kernel_phase(B, n: int, hits: dict, orders_n: int,
                         point_members: int, device: str = "cuda") -> list:
    """The three member-axis entries against their plain versions at the
    serving lane's shapes, timed with their plain versions, a PyTorch
    library call (or short sequence) for the same function, and B
    launches of the single-query kernel; the bound counts a shared
    input once. `hits`: c40's columns at 1M rows (URLHash, EventDate,
    CounterID, IsRefresh, TraficSourceID, RefererHash) as device
    tensors."""
    import torch
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(4321)
    rows = []

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def rand(shape, dtype=torch.float64):
        return torch.rand(shape, generator=g, device=dev, dtype=dtype)

    def randint(lo, hi, shape, dtype=torch.int64):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=dtype)

    def line(name, shape, k, p, lib, singles, bound, extra=""):
        libs = "—" if lib is None else f"{lib:.4f}"
        log(f"kernel {name} {shape}: kernel_ms={k:.4f} plain_ms={p:.4f} "
            f"library_ms={libs} b_single_launches_ms={singles:.4f} "
            f"bound_us={bound * 1e3:.2f} (bytes){extra}")

    # -- bucket_agg_batched at Q1's shape: 12 buckets, the 10 kernel
    #    aggregates (7 float64 sums, 3 counts), 8 members whose masks
    #    are 8 DELTAs of l_shipdate <= date '1998-12-01' - DELTA
    Bm = 8
    u = rand((n,))
    kid = torch.where(u < 0.49, 10, torch.where(
        u < 0.74, 5, torch.where(u < 0.993, 7, 6))).to(torch.int32)
    sd = randint(0, 2526, (n,))
    live = rand((n,)) < 0.98
    deltas = randint(60, 121, (Bm,))
    masks = (live[None, :] & (sd[None, :] <= 2526 - deltas[:, None])) \
        .contiguous()
    aggs = [("sum", rand((n,)) * 1e5, None, False) for _ in range(7)] \
        + [("count", None, None, False) for _ in range(3)]
    err = check_bucket_agg_batched(B, kid, 12, masks, aggs, sync, "Q1")
    sums = [d for (f, d, _v, _u) in aggs if f == "sum"]
    member = torch.arange(Bm, device=dev, dtype=torch.int64)[:, None]

    def lib_q1():
        # one histogram over flat (member, bucket) ids, a dump bin for
        # the rows no member keeps: a weighted bincount per sum, one
        # bincount for the counts (Q1's counts are all count(*))
        flat = torch.where(masks, member * 12 + kid.to(torch.int64)[None, :],
                           Bm * 12).reshape(-1)
        return [torch.bincount(flat, weights=d.repeat(Bm),
                               minlength=Bm * 12 + 1) for d in sums] \
            + [torch.bincount(flat, minlength=Bm * 12 + 1)]
    k = time_ms(lambda: B.bucket_agg_batched(kid, 12, masks, aggs))
    p = time_ms(lambda: B.bucket_agg_batched_plain(kid, 12, masks, aggs))
    lib = time_ms(lib_q1)
    singles = time_ms(lambda: [B.bucket_agg(kid, 12, masks[b], aggs)
                               for b in range(Bm)])
    bound = bound_ms(batched_agg_bytes(kid, 12, masks, aggs))
    rows.append(dict(
        name="bucket_agg_batched", route="cuda",
        source="ydb_tpu_torch/ops/cuda/csrc/bucket_agg.cu",
        replaces="ydb_tpu/ops/fused.py:299",
        shape=f"n={n} nb=12 aggs={len(aggs)} B={Bm} (Q1, 8 DELTAs)",
        max_abs_err=err, ms=k, plain_ms=p, library_ms=lib, bound_ms=bound,
        bound_by="bytes"))
    line("bucket_agg_batched", f"Q1 n={n} nb=12 aggs=10 B={Bm}", k, p, lib,
         singles, bound, f" kernel/library={k / lib:.3f} "
         f"kernel/bound={k / bound:.3f}")

    def flat(r):
        return list(r[0]) + list(r[1]) + [r[2]]

    def members_are_singles(kid_, nb_, masks_, aggs_, tag):
        # the keyed member form: member b equals a single bucket_agg over
        # its mask bit for bit, and two calls repeat bit for bit
        got = B.bucket_agg_batched(kid_, nb_, masks_, aggs_)
        again = B.bucket_agg_batched(kid_, nb_, masks_, aggs_)
        sync()
        check(same_bits(flat(got), flat(again)),
              f"bucket_agg_batched {tag}: two calls differ")
        for b in range(masks_.shape[0]):
            one = B.bucket_agg(kid_ if kid_.dim() == 1 else kid_[b], nb_,
                               masks_[b], aggs_)
            sync()
            check(same_bits([x[b] for x in flat(got)], flat(one)),
                  f"bucket_agg_batched {tag}: member {b} is not a single "
                  "call")
    members_are_singles(kid, 12, masks, aggs, "Q1")
    # every function, NULLs, a per-member value column and per-member
    # ids, checked
    v = rand((n,)) > 0.05
    per_val = rand((Bm, n)) * 1e3
    funcs = [("sum", aggs[0][1], v, False), ("count", None, v, False),
             ("min", aggs[0][1], v, False), ("max", aggs[1][1], v, False),
             ("first", None, v, False), ("sum", per_val, None, False),
             ("sum", randint(-(1 << 40), 1 << 40, (n,)), v, False),
             ("min", randint(-(1 << 62), 1 << 62, (n,)), None, True),
             ("max", randint(-(1 << 62), 1 << 62, (n,)), v, True)]
    check_bucket_agg_batched(B, kid, 12, masks, funcs, sync, "funcs")
    kid_pm = randint(0, 12, (Bm, n), torch.int32)
    check_bucket_agg_batched(B, kid_pm, 12, masks, funcs, sync,
                             "per-member ids")

    # -- keyless at Q6's shape: sum(l_extendedprice * l_discount) under 8
    #    members' (DATE, DISCOUNT, QUANTITY) masks: the streaming member
    #    body (bucket_agg_keyless_batched, one launch); every function,
    #    per-member values and unaligned inputs take the keyed body with
    #    one bucket
    q6 = [("sum", aggs[0][1], None, False)]
    q6_masks = (live[None, :] & (rand((Bm, n)) < 0.02)).contiguous()
    err6 = check_bucket_agg_batched(B, None, 1, q6_masks, q6, sync,
                                    "Q6 keyless")
    check_bucket_agg_batched(B, None, 1, q6_masks, funcs, sync,
                             "keyless funcs")
    stream_before = B.LAUNCHES["bucket_agg_keyless_batched"]
    ints = randint(-(1 << 40), 1 << 40, (n,))
    cnt = ("count", None, None, False)
    for i, spec in enumerate([[], [cnt], q6 + [cnt], aggs[:2],
                              aggs[:2] + [("sum", ints, None, False), cnt],
                              [("sum", ints, None, True)] + aggs[:3]]):
        check_bucket_agg_batched(B, None, 1, q6_masks, spec, sync,
                                 f"keyless stream {i}")
    check(B.LAUNCHES["bucket_agg_keyless_batched"] - stream_before == 6,
          "keyless members: the streaming body did not take the common "
          "spec")
    first6 = B.bucket_agg_batched(None, 1, q6_masks, aggs[:2])
    again6 = B.bucket_agg_batched(None, 1, q6_masks, aggs[:2])
    sync()
    check(same_bits(flat(first6), flat(again6)),
          "bucket_agg_batched keyless: two calls differ")
    check_bucket_agg_batched(B, None, 1, q6_masks[:, 1:],
                             [("sum", aggs[0][1][:-1], None, False)], sync,
                             "keyless unaligned masks")
    check_bucket_agg_batched(B, None, 1, q6_masks[:, :-1],
                             [("sum", aggs[0][1][1:], None, False)], sync,
                             "keyless unaligned column")
    q6mf = q6_masks.to(torch.float64)
    k6 = time_ms(lambda: B.bucket_agg_batched(None, 1, q6_masks, q6))
    lib6 = time_ms(lambda: q6mf @ aggs[0][1])
    bound6 = bound_ms(batched_agg_bytes(None, 1, q6_masks, q6))
    rows.append(dict(
        name="bucket_agg_keyless_batched", route="cuda",
        source="ydb_tpu_torch/ops/cuda/csrc/bucket_agg.cu",
        replaces="ydb_tpu/ops/fused.py:299",
        shape=f"n={n} aggs=1 B={Bm} (Q6 keyless)", max_abs_err=err6,
        ms=k6, plain_ms=time_ms(
            lambda: B.bucket_agg_batched_plain(None, 1, q6_masks, q6)),
        library_ms=lib6, bound_ms=bound6, bound_by="bytes"))
    line("bucket_agg_batched", f"Q6 keyless n={n} aggs=1 B={Bm}", k6,
         rows[-1]["plain_ms"], lib6,
         time_ms(lambda: [B.bucket_agg(None, 1, q6_masks[b], q6)
                          for b in range(Bm)]), bound6,
         f" kernel/library={k6 / lib6:.3f} kernel/bound={k6 / bound6:.3f}")

    # -- 512 buckets x 16 aggregates, 8 members
    kid5 = randint(0, 512, (n,), torch.int32)
    wide = []
    for a in range(16):
        f = ("sum", "sum", "count", "min", "max", "first")[a % 6]
        d = None if f in ("count", "first") else (
            rand((n,)) * 1e5 if a % 4 else randint(-(1 << 40), 1 << 40,
                                                   (n,)))
        wide.append((f, d, rand((n,)) > 0.05 if a % 3 else None, False))
    check_bucket_agg_batched(B, kid5, 512, masks, wide, sync, "nb=512")

    def lib_512():
        # as at Q1: a weighted bincount per sum (and one per count) over
        # flat (member, bucket) ids; min, max and first have no bincount,
        # so this is a floor of the library's time
        flat = torch.where(masks, member * 512 + kid5.to(torch.int64)[None, :],
                           Bm * 512).reshape(-1)
        out = []
        for f, d, v, _u in wide:
            if f not in ("sum", "count"):
                continue
            w = None if f == "count" else d.to(torch.float64)
            if v is not None:
                w = v.to(torch.float64) if w is None \
                    else torch.where(v, w, 0.0)
            out.append(torch.bincount(
                flat, weights=None if w is None else w.repeat(Bm),
                minlength=Bm * 512 + 1))
        return out
    k5 = time_ms(lambda: B.bucket_agg_batched(kid5, 512, masks, wide))
    lib5 = time_ms(lib_512)
    bound5 = bound_ms(batched_agg_bytes(kid5, 512, masks, wide))
    line("bucket_agg_batched", f"nb=512 n={n} aggs=16 B={Bm}", k5,
         time_ms(lambda: B.bucket_agg_batched_plain(kid5, 512, masks,
                                                    wide)),
         lib5,
         time_ms(lambda: [B.bucket_agg(kid5, 512, masks[b], wide)
                          for b in range(Bm)]),
         bound5, " library: bincounts of the sums and counts only (a "
         f"floor) kernel/library={k5 / lib5:.3f} "
         f"kernel/bound={k5 / bound5:.3f}")
    members_are_singles(kid5, 512, masks, wide, "nb=512")

    # -- B = 1, 3, 8 and 32 at an odd row count, Q1's and the 512-bucket
    #    specs, shared and per-member ids, against the plain version
    ms_ = min((1 << 18) + 333, n - 1)
    for Bs in (1, 3, 8, 32):
        bm = (rand((Bs, ms_)) < 0.9) & (rand((1, ms_)) < 0.98)
        check_bucket_agg_batched(B, kid[:ms_], 12, bm, [
            (f, None if d is None else d[:ms_], v, u)
            for (f, d, v, u) in aggs], sync, f"Q1 B={Bs} odd")
        check_bucket_agg_batched(B, kid5[:ms_], 512, bm, [
            (f, None if d is None else d[:ms_],
             None if v is None else v[:ms_], u) for (f, d, v, u) in wide],
            sync, f"nb=512 B={Bs} odd")
        check_bucket_agg_batched(B, randint(0, 40, (Bs, ms_), torch.int32),
                                 40, bm, [(f, None if d is None else d[:ms_],
                                           None if v is None else v[:ms_], u)
                                          for (f, d, v, u) in funcs[:5]],
                                 sync, f"per-member ids B={Bs} odd")
        check_bucket_agg_batched(B, None, 1, bm, [
            ("sum", aggs[0][1][:ms_], None, False),
            ("sum", ints[:ms_], None, False), cnt], sync,
            f"keyless stream B={Bs} odd")
    log("kernel bucket_agg_batched checks: member b = a single call bit "
        "for bit at Q1 and nb=512, two calls bit for bit (keyed, keyless), "
        "keyless streaming specs of 0-4 sums, unaligned inputs, B=1,3,8,32 "
        "at an odd row count (shared and per-member ids, keyless) ok")

    # -- segment_agg_batched at the batch c40 sends over the 1M hits rows
    #    (c36's URL groups fit the 512-bucket lane, so its batch takes
    #    bucket_agg_batched): the sorted lane over (URLHash, EventDate),
    #    8 members (CounterID, EventDate window), one sort of the union
    #    of their masks, count(*) only
    from ydb_tpu_torch.ops.sort import encode_key
    nh = hits["URLHash"].shape[0]
    cid = randint(1, 101, (Bm,))
    cid[0] = 1                             # the busiest counter
    lo = randint(0, 16, (Bm,))
    hi = torch.clamp(lo + randint(7, 31, (Bm,)), max=30)
    day = hits["EventDate"].to(torch.int64) - 19530
    tsid = hits["TraficSourceID"]
    hmasks = ((hits["CounterID"][None, :] == cid[:, None])
              & (day[None, :] >= lo[:, None]) & (day[None, :] <= hi[:, None])
              & (hits["IsRefresh"] == 0)[None, :]
              & ((tsid == -1) | (tsid == 6))[None, :]
              & (hits["RefererHash"] == 1417906597943049265)[None, :]
              ).contiguous()
    words = [encode_key(hits["URLHash"].to(torch.int64)).contiguous(),
             encode_key(hits["EventDate"].to(torch.int64)).contiguous()]
    union = hmasks.any(0)
    perm = B.sort_perm([encode_key((~union).to(torch.int64))] + words, nh,
                       dev)
    oc = nh
    c40 = []                               # count(*) only: no kernel agg
    serr = check_segment_agg_batched(B, perm, words, hmasks, c40, oc, sync,
                                     "c40")
    hv = rand((nh,)) > 0.1
    hfuncs = [("sum", rand((nh,)) * 1e3, hv, False),
              ("count", None, hv, False), ("min", rand((nh,)), None, False),
              ("max", randint(-(1 << 62), 1 << 62, (nh,)), hv, True),
              ("first", None, hv, False),
              ("sum", rand((Bm, nh)), None, False)]
    serr = max(serr, check_segment_agg_batched(
        B, perm, words, hmasks, hfuncs, oc, sync, "c40 funcs"))
    # two chunks of aggregates (the hidden first and 7, then 3)
    serr = max(serr, check_segment_agg_batched(
        B, perm, words, hmasks, hfuncs + hfuncs[:4], oc, sync,
        "c40 ten funcs"))
    # two calls bit for bit (float sums included), with the caller's union
    a1 = B.segment_agg_batched(perm, words, hmasks, hfuncs, oc, union=union)
    a2 = B.segment_agg_batched(perm, words, hmasks, hfuncs, oc, union=union)
    sync()
    check(same_bits(a1, a2), "segment_agg_batched c40 funcs: two calls "
          "differ")
    del a1, a2
    perms = [B.sort_perm([encode_key((~hmasks[b]).to(torch.int64))] + words,
                         nh, dev) for b in range(Bm)]
    member = torch.arange(Bm, device=dev)[:, None].expand(Bm, nh)
    flat = torch.stack([member.reshape(-1),
                        hits["URLHash"].repeat(Bm),
                        hits["EventDate"].to(torch.int64).repeat(Bm)])

    def lib_c40():
        return torch.unique(flat[:, hmasks.reshape(-1)], dim=1,
                            return_counts=True)
    # as the serving lane calls it: with the union it sorted by
    k = time_ms(lambda: B.segment_agg_batched(perm, words, hmasks, c40, oc,
                                              union=union))
    p = time_ms(lambda: B.segment_agg_batched_plain(perm, words, hmasks,
                                                    c40, oc))
    lib = time_ms(lib_c40)
    singles = time_ms(lambda: [B.segment_agg(perms[b], words, hmasks[b],
                                             c40, oc) for b in range(Bm)])
    # the device work of one call, counted in a graph capture of three:
    # the fold, the fix and the member compaction, and nothing else (no
    # torch pass over (B, oc))
    plan = B.segment_agg_batched_plan(nh, Bm, oc, len(c40))
    captured = captured_kernels(lambda: B.segment_agg_batched(
        perm, words, hmasks, c40, oc, union=union), calls=3)
    ours = {k_: c for k_, c in captured.items()
            if any(f in k_ for f in ("seg_fold", "seg_fix", "seg_members"))}
    rest = {k_: c for k_, c in captured.items() if k_ not in ours}
    n_kern = sum(ours.values()) / 3
    check(n_kern == plan["launches"] <= 3,
          f"segment_agg_batched c40: {n_kern} kernels a call captured, the "
          f"plan says {plan['launches']}: {captured}")
    check(not rest, f"segment_agg_batched c40: device work besides its "
          f"kernels: {rest}")
    # segment_agg's bound extended by the member axis: the distinct
    # inputs, and per member oc slots of lead (4), present (8) and a
    # value and a count per aggregate (16 each)
    bound = bound_ms(distinct_bytes([perm, hmasks] + words)
                     + Bm * oc * (4 + 8 + 16 * len(c40)))
    rows.append(dict(
        name="segment_agg_batched", route="cuda",
        source="ydb_tpu_torch/ops/cuda/csrc/segment_agg.cu",
        replaces="ydb_tpu/ops/fused.py:299",
        shape=f"n={nh} B={Bm} (c40: (URLHash, EventDate) groups, count(*); "
              f"captured: {n_kern:g} kernel launches a call)",
        max_abs_err=serr, ms=k, plain_ms=p, library_ms=lib, bound_ms=bound,
        bound_by="bytes"))
    line("segment_agg_batched", f"c40 n={nh} B={Bm} live="
         f"{[int(x) for x in hmasks.sum(1)]} captured_3_calls={captured}", k, p,
         lib, singles, bound)
    # c40 funcs: 6 aggregates, one a per-member sum; timed, not tabled
    kf = time_ms(lambda: B.segment_agg_batched(perm, words, hmasks, hfuncs,
                                               oc, union=union))
    pf = time_ms(lambda: B.segment_agg_batched_plain(perm, words, hmasks,
                                                     hfuncs, oc))
    sf = time_ms(lambda: [B.segment_agg(perms[b], words, hmasks[b],
                                        [(f, d if d is None or d.dim() == 1
                                          else d[b], v, u)
                                         for f, d, v, u in hfuncs], oc)
                          for b in range(Bm)])
    ins = [perm, hmasks] + words + [t for (_f, d, v, _u) in hfuncs
                                    for t in (d, v) if t is not None]
    line("segment_agg_batched", f"c40 funcs n={nh} B={Bm} aggs="
         f"{len(hfuncs)}", kf, pf, None, sf,
         bound_ms(distinct_bytes(ins) + Bm * oc * (4 + 8 + 16 * len(hfuncs))))

    # -- compact_batched at the point-lookup batch: orders' capacity, one
    #    live row per member; and at 8 top-k masks over lineitem
    Bp = point_members
    ok = torch.arange(orders_n, device=dev, dtype=torch.int64) * 4 + 1
    ocols = [ok, rand((orders_n,)) * 5e5,
             randint(8035, 10592, (orders_n,), torch.int32)]
    keys = ok[randint(0, orders_n - 1000, (Bp,))]
    pmasks = (ok[None, :] == keys[:, None]).contiguous()
    plen = orders_n - 1000
    plive = check_compact_batched(B, ocols, pmasks, plen, orders_n,
                                  orders_n, sync, "point")

    def lib_point():
        idx = torch.nonzero(pmasks)
        return [c[idx[:, 1]] for c in ocols]
    k = time_ms(lambda: B.compact_batched(ocols, pmasks, plen, orders_n,
                                          orders_n, Bp))
    p = time_ms(lambda: B.compact_batched_plain(ocols, pmasks, plen,
                                                orders_n, orders_n, Bp))
    lib = time_ms(lib_point)
    singles = time_ms(lambda: [B.compact(ocols, pmasks[b], plen, orders_n,
                                         orders_n) for b in range(Bp)])
    bound = bound_ms(compact_batched_bytes(pmasks, plive, ocols))
    # what the wrapper clears beyond the bound (it used to zero-fill B
    # full-capacity outputs before the kernels ran)
    zf = zero_fill_bytes(lambda: B.compact_batched(ocols, pmasks, plen,
                                                   orders_n, orders_n, Bp))
    check(zf == 0, f"compact_batched point: {zf} bytes zero-filled")
    fill = (f" zero_fill_bytes={zf} live_rows={plive} kernel/library="
            f"{k / lib:.3f} kernel/bound={k / bound:.3f}")
    rows.append(dict(
        name="compact_batched", route="cuda",
        source="ydb_tpu_torch/ops/cuda/csrc/compact.cu",
        replaces="ydb_tpu/ops/fused.py:299",
        shape=f"n={orders_n} B={Bp} (point lookups, one live row each)",
        max_abs_err=0.0, ms=k, plain_ms=p, library_ms=lib, bound_ms=bound,
        bound_by="bytes"))
    line("compact_batched", f"point n={orders_n} B={Bp}", k, p, lib,
         singles, bound, fill)
    lcols = [aggs[0][1], randint(0, 6_000_000, (n,))]
    tmasks = (live[None, :] & (sd[None, :] == randint(0, 2526, (Bm,))
                               [:, None])).contiguous()
    tlive = check_compact_batched(B, lcols, tmasks, n, n, n, sync, "top-k")

    def lib_topk():
        idx = torch.nonzero(tmasks)
        return [c[idx[:, 1]] for c in lcols]
    k = time_ms(lambda: B.compact_batched(lcols, tmasks, n, n, n, Bm))
    lib = time_ms(lib_topk)
    bound = bound_ms(compact_batched_bytes(tmasks, tlive, lcols))
    zf = zero_fill_bytes(lambda: B.compact_batched(lcols, tmasks, n, n, n,
                                                   Bm))
    check(zf == 0, f"compact_batched top-k: {zf} bytes zero-filled")
    line("compact_batched", f"top-k n={n} B={Bm}", k,
         time_ms(lambda: B.compact_batched_plain(lcols, tmasks, n, n, n,
                                                 Bm)),
         lib,
         time_ms(lambda: [B.compact(lcols, tmasks[b], n, n, n)
                          for b in range(Bm)]),
         bound, f" zero_fill_bytes={zf} live_rows={tlive} kernel/library="
         f"{k / lib:.3f} kernel/bound={k / bound:.3f}")
    # the look-back's other shapes: no mask (every row to its length),
    # one shared mask, more columns than one launch takes (a second
    # launch reads the first one's offsets), and two calls held equal
    many = [lcols[i % 2] for i in range(B._MAX_COLS + 3)]
    check_compact_batched(B, many, tmasks, n - 3, n, 1 << 16, sync,
                          "top-k chunked")
    pm = tmasks[0]
    ko, kl, kn, _kf = B.compact_batched(lcols, pm, n - 9, n, n, Bm)
    po, pl, pn, _pf = B.compact_batched_plain(lcols, pm, n - 9, n, n, Bm)
    sync()
    check(torch.equal(kl, pl) and all(torch.equal(a[:, :int(pn[0])],
                                                  b[:, :int(pn[0])])
                                      for a, b in zip(ko, po)),
          "compact_batched shared mask")
    m = min(100_003, n - 1)
    ko, kl, kn, _kf = B.compact_batched([lcols[1][:m]], None,
                                        torch.randint(0, m, (Bm,),
                                                      generator=g,
                                                      device=dev,
                                                      dtype=torch.int32),
                                        m, m, Bm)
    sync()
    check(all(torch.equal(ko[0][b, :int(kn[b])], lcols[1][:int(kn[b])])
              for b in range(Bm)) and torch.equal(kl, kn),
          "compact_batched no mask")

    # -- edge cases, checked: B = 1, every member identical, a member
    #    with no live row, B = 64 (a member per block row)
    m = 200_003
    e_kid = randint(0, 300, (m,), torch.int32)
    e_val = [("sum", rand((m,)), None, False), ("count", None, None, False),
             ("first", None, None, False)]
    e_words = [encode_key(e_kid.to(torch.int64))]
    for tag, mk in (("B=1", lambda: rand((1, m)) < 0.5),
                    ("identical", lambda: (rand((m,)) < 0.5)[None, :]
                     .expand(4, m).contiguous()),
                    ("empty member", lambda: torch.cat(
                        [rand((3, m)) < 0.5,
                         torch.zeros(1, m, dtype=torch.bool, device=dev)])),
                    ("B=64", lambda: rand((64, m)) < 0.3)):
        em = mk()
        check_bucket_agg_batched(B, e_kid, 300, em, e_val, sync, tag)
        check_bucket_agg_batched(B, None, 1, em, e_val, sync, f"{tag} keyless")
        eu = em.any(0)
        ep = B.sort_perm([encode_key((~eu).to(torch.int64))] + e_words, m,
                         dev)
        check_segment_agg_batched(B, ep, e_words, em, e_val, 512, sync, tag)
        check_compact_batched(B, [e_kid, e_val[0][1]], em, m - 7, m, m,
                              sync, tag)
        check_compact_batched(B, [e_kid], em, m, m, 1024, sync,
                              f"{tag} overflow")
    log("kernel batched edge cases: B=1, identical members, an empty "
        "member, B=64 (bucket_agg_batched keyed and keyless, "
        "segment_agg_batched, compact_batched with an overflow) ok")
    return rows


# --------------------------------------------------------------------------
# the batched serving path
# --------------------------------------------------------------------------

SERVING_SEED = 20261017
SERVING_TEMPLATES = (("q1", "tpch", 8), ("q6", "tpch", 8),
                     ("q12", "tpch", 8), ("q14", "tpch", 8),
                     ("q19", "tpch", 8), ("q3", "tpch", 8),
                     ("point", "tpch", 64), ("c36", "clickbench", 8),
                     ("c37", "clickbench", 8), ("c40", "clickbench", 8),
                     ("c42", "clickbench", 8))
SERVING_KERNELS = ("bucket_agg_batched", "bucket_agg_keyless_batched",
                   "segment_agg_batched", "compact_batched", "probe", "sort",
                   "k1")


def _storm(eng, texts):
    """One thread per text, released together; returns (wall ms,
    {i: (frame, last_path)})."""
    import threading
    out, errs = {}, []
    barrier = threading.Barrier(len(texts) + 1)

    def one(i, sql):
        try:
            barrier.wait()
            df = eng.query(sql)
            out[i] = (df, eng.executor.last_path)
        except Exception as e:             # noqa: BLE001 — reported below
            errs.append((i, repr(e)))
    threads = [threading.Thread(target=one, args=(i, q))
               for i, q in enumerate(texts)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = (time.perf_counter() - t0) * 1e3
    check(not errs, f"storm failed: {errs[:3]}")
    return wall, out


@contextlib.contextmanager
def _sort_sizes(bindings):
    """The row counts of the `sort_perm` calls made inside the block
    (each is one wrapper call: one launch up to 8,192 rows, else the
    census and 8 digit passes a key word, those that the census finds
    dead returning at entry)."""
    real, sizes = bindings.sort_perm, []

    def recording(keys, n, device):
        sizes.append(n)
        return real(keys, n, device)
    bindings.sort_perm = recording
    try:
        yield sizes
    finally:
        bindings.sort_perm = real


def _batched_call(eng, texts):
    """One direct `execute_fused_batched` of `texts` (the lane's call)."""
    import dataclasses

    from ydb_tpu_torch.sql import parse
    plans = [eng.planner.plan_select(parse(q)) for q in texts]
    p0 = plans[0]
    pipe = p0.pipeline
    pb = dataclasses.replace(p0, pipeline=dataclasses.replace(
        pipe, scan=dataclasses.replace(pipe.scan, prune=[])))
    return eng.executor.execute_fused_batched(
        pb, [(p, dict(p.params)) for p in plans], eng.snapshot())


_GRAPH_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
                     4: "child graph", 12: "batch mem op", 13: "conditional"}


def captured_kernels(fn, calls: int = 3) -> dict:
    """The device work of `calls` calls of `fn`, read from a CUDA graph
    capture of them: {kernel name (mangled) or node kind: nodes}. The
    capture records every kernel, memset and copy the calls enqueue on
    the stream and runs none of them; a host sync inside `fn` makes it
    fail. One call on the capture stream first makes the wrappers'
    per-stream state outside the capture. Nodes that do no device work
    (events, empty nodes, the pool's allocations) are left out.
    (torch.profiler traces of the same calls were seen to drop launches,
    and once to show none.)"""
    import ctypes

    import torch
    cu = ctypes.CDLL("libcuda.so.1")
    vp, u32 = ctypes.c_void_p, ctypes.c_uint

    class KernelParams(ctypes.Structure):        # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", vp)] + [(f, u32) for f in (
            "gx", "gy", "gz", "bx", "by", "bz", "smem")] + [
            ("params", vp), ("extra", vp), ("kern", vp), ("ctx", vp)]

    def ok(rc, what):
        check(rc == 0, f"captured_kernels: {what} returned CUresult {rc}")

    def node_name(node):
        kind = ctypes.c_int()
        ok(cu.cuGraphNodeGetType(node, ctypes.byref(kind)),
           "cuGraphNodeGetType")
        if kind.value != 0:
            return _GRAPH_NODE_KINDS.get(kind.value)
        kp, name = KernelParams(), ctypes.c_char_p()
        ok(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(kp)),
           "cuGraphKernelNodeGetParams_v2")
        if kp.func:
            ok(cu.cuFuncGetName(ctypes.byref(name), vp(kp.func)),
               "cuFuncGetName")
        else:
            ok(cu.cuKernelGetName(ctypes.byref(name), vp(kp.kern)),
               "cuKernelGetName")
        return name.value.decode()

    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        fn()
    s.synchronize()
    g, counts = torch.cuda.CUDAGraph(), {}
    with torch.cuda.graph(g, stream=s, capture_error_mode="thread_local"):
        for _ in range(calls):
            fn()
        status, cid, graph = ctypes.c_int(), ctypes.c_uint64(), vp()
        deps, ndeps = vp(), ctypes.c_size_t()
        ok(cu.cuStreamGetCaptureInfo_v2(
            vp(s.cuda_stream), ctypes.byref(status), ctypes.byref(cid),
            ctypes.byref(graph), ctypes.byref(deps), ctypes.byref(ndeps)),
           "cuStreamGetCaptureInfo_v2")
        check(status.value == 1, "captured_kernels: the stream is not "
              f"capturing (status {status.value})")
        nn = ctypes.c_size_t()
        ok(cu.cuGraphGetNodes(graph, None, ctypes.byref(nn)),
           "cuGraphGetNodes")
        nodes = (vp * max(nn.value, 1))()
        ok(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(nn)),
           "cuGraphGetNodes")
        for i in range(nn.value):
            name = node_name(vp(nodes[i]))
            if name is not None:
                counts[name] = counts.get(name, 0) + 1
    del g
    return counts


def _device_ms(fn) -> float:
    """Device time of one call of `fn` under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(float(getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0) or 0)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3


def admitted_batch(eng, text: str, Bn: int):
    """The largest B <= Bn, halving, that the lane's own gates admit for
    `text` (est x B against the fused scan budget, and for plans with no
    LIMIT and no GROUP BY against the merge budget, `batch_lane.
    _group_key`). Returns (B, est, [the gates that declined])."""
    from ydb_tpu_torch.query.admission import estimate_plan_bytes
    from ydb_tpu_torch.query.batch_lane import _has_groupby
    from ydb_tpu_torch.sql import parse
    plan = eng.planner.plan_select(parse(text))
    est = max(estimate_plan_bytes(eng.catalog, plan, eng.snapshot()),
              1 << 20)
    ex = eng.executor
    declined = []
    while True:
        if est * Bn > ex.fused_scan_budget_bytes:
            declined.append(f"est x {Bn} > fused_scan_budget")
        elif plan.limit is None and not _has_groupby(plan) \
                and est * Bn > ex.merge_budget_bytes:
            declined.append(f"est x {Bn} > merge_budget (no LIMIT, no "
                            "GROUP BY)")
        else:
            return Bn, est, declined
        Bn //= 2
        check(Bn >= 2, f"the lane's gates admit no batch: {declined}")


def serving_phase(bindings, engines: dict, oracles: dict,
                  order_keys) -> dict:
    """The batched serving path: per template, B client threads released
    together send one variant each (`bench/serving.py`, parameters drawn
    from SERVING_SEED) to an engine with the lane on
    (`YDB_TPU_BATCH_WINDOW=500`, `YDB_TPU_BATCH_MAX=B`) and to the
    lane-off engine over the same catalog. Every member must equal the
    lane-off answer, the validation member its oracle; batched templates
    must coalesce (`batch/batches`, `last_path`), Q3 (literals on its
    build sides) must run as singles; a direct execute_fused_batched
    must call the same kernel wrappers, as many times, at B = 2 and
    B = 8 (a sort over B x cap rows sorts more rows inside its one
    call; the rows sorted are logged).
    Returns this path's launches."""
    import torch

    from ydb_tpu_torch.bench import serving
    from ydb_tpu_torch.bench.tpch_oracle import assert_frames_match
    from ydb_tpu_torch.query import QueryEngine
    from ydb_tpu_torch.utils.metrics import GLOBAL
    os.environ["YDB_TPU_LATE_MAT"] = "1"
    os.environ["YDB_TPU_BATCH_WINDOW"] = "500"
    lanes = {}
    for suite, off in engines.items():
        lanes[suite] = QueryEngine(catalog=off.catalog)
    os.environ.pop("YDB_TPU_BATCH_WINDOW", None)
    log(f"batched serving: window 500 ms, seed {SERVING_SEED}; templates "
        + ", ".join(f"{n} B={b}" for n, _s, b in SERVING_TEMPLATES))
    bindings.reset_launches()
    for name, suite, Bn in SERVING_TEMPLATES:
        off, on = engines[suite], lanes[suite]
        if name == "point":
            texts_all = serving.point_variants(order_keys, Bn, SERVING_SEED)
        else:
            texts_all = serving.variants(name, Bn, SERVING_SEED)
        # the reference's own gates: est x B against the fused scan and
        # merge budgets; halve B until they admit the template
        Bn, est, declined = admitted_batch(on, texts_all[0], Bn)
        for gate in declined:
            log(f"serving {name}: declined at {gate}; halving B")
        gate = f"admitted at B={Bn}"
        texts = texts_all[:Bn]
        on._batch_lane.max_batch = Bn
        want = [off.query(q) for q in texts]          # lane off, warm
        for q in texts:        # plans cached, device warm (each alone)
            on.query(q)
        # one untimed storm builds the batched stages' K1 kernels (a
        # per-member param is another signature), as the texts alone
        # built the single ones: the timed storms hold no NVRTC build
        _storm(on, texts)
        k1_b0 = GLOBAL.get("k1/builds")
        t_off, _ = _storm(off, texts)
        b0 = {k: GLOBAL.get(k) for k in ("batch/batches", "batch/singles",
                                         "batch/coalesced_queries")}
        t_on, got = _storm(on, texts)
        d = {k: GLOBAL.get(k) - v for k, v in b0.items()}
        for i, q in enumerate(texts):
            assert_frames_match(got[i][0], want[i], ordered=True)
        if name != "point":
            ref = oracles[suite](name)
            if suite == "clickbench":
                ref.columns = list(got[0][0].columns)
            assert_frames_match(got[0][0], ref, ordered=True)
        paths = sorted({p for (_df, p) in got.values()})
        if name == "q3":
            check(d["batch/batches"] == 0 and "fused-batched" not in paths,
                  f"q3 must run as singles: {d} {paths}")
        else:
            check(d["batch/batches"] >= 1 and "fused-batched" in paths,
                  f"{name}: no batch ({d}, paths {paths})")
        note = ""
        if name != "q3":
            per_b, merges = {}, {}
            for b in (2, 8) if Bn >= 8 else (2, Bn):
                before = dict(bindings.LAUNCHES)
                with _sort_sizes(bindings) as sizes:
                    blocks = _batched_call(on, texts[:b])
                torch.cuda.synchronize()
                check(blocks is not None, f"{name}: batched call declined")
                per_b[b] = {k: v - before[k]
                            for k, v in bindings.LAUNCHES.items()
                            if v > before[k]}
                merges[b] = sum(sizes)
            b_lo, b_hi = sorted(per_b)
            check(per_b[b_lo] == per_b[b_hi],
                  f"{name}: wrapper calls per batch depend on B: {per_b}")
            dev_ms = _device_ms(lambda: _batched_call(on, texts))
            note = (f" wrapper_calls_per_batch={sum(per_b[b_hi].values())} "
                    f"{json.dumps(per_b[b_hi])} (equal at B={b_lo} and "
                    f"B={b_hi}) sort_rows={merges[b_lo]} at "
                    f"B={b_lo}, {merges[b_hi]} at B={b_hi} "
                    f"traced_batch_device_ms={dev_ms:.3f}")
        k1_storm = GLOBAL.get("k1/builds") - k1_b0
        log(f"serving {name}: B={Bn} est={est} gate={gate} "
            f"storm_lane_off_ms={t_off:.2f} storm_lane_on_ms={t_on:.2f} "
            f"k1_builds_in_storms={k1_storm} "
            f"batches={d['batch/batches']} singles={d['batch/singles']} "
            f"coalesced={d['batch/coalesced_queries']} paths={paths} "
            f"ok{note}")
    launches = dict(bindings.LAUNCHES)
    log(f"launches (batched serving): {json.dumps(launches)}")
    missing = [k for k in SERVING_KERNELS if launches[k] <= 0]
    check(not missing, f"kernels not launched on batched serving: {missing}")
    return launches


# --------------------------------------------------------------------------
# main
# --------------------------------------------------------------------------


# --------------------------------------------------------------------------
# the DQ path: TPC-H as stage graphs over in-process worker engines
# --------------------------------------------------------------------------

DQ_WORKERS = 4
# each worker engine's device-cache budget: four engines share one card
DQ_CACHE_BUDGET = 8 << 30
# the queries whose stage graph the reference's cluster answers; of the
# 11 that lower, q7, q8 and q9 fail in their join stage in both packages
# (`unknown column`: the stage keeps a derived table's aliases)
DQ_ANSWERED = ("q1", "q3", "q5", "q6", "q10", "q12", "q14", "q19")
DQ_RUN_REFUSED = ("q7", "q8", "q9")
# the queries with ICI hash-shuffle edges (lineitem and orders both
# sharded)
DQ_SHUFFLE = ("q3", "q5", "q7", "q8", "q9", "q10", "q12")
DQ_HOST_CHECK = ("q3", "q10", "q12")
# the quant pass: the answered shuffle queries, each held row by row
# against the exact answer of its full group-by (the query without its
# top-k), looked up by its group key: a top-k by a quantized sum may trade
# ranks within the codec's tolerance, the rows it returns may not differ
# from their exact values past it
DQ_QUANT = {"q3": ("l_orderkey", "order by revenue desc, o_orderdate\n"
                   "limit 10"),
            "q5": ("n_name", None),
            "q10": ("c_custkey", "order by revenue desc\nlimit 20"),
            "q12": ("l_shipmode", None)}
DQ_QUANT_RTOL = 2e-2                 # the reference's declared tolerance
DQ_KERNELS = ("dq_bucket_plane", "dq_counts", "segments", "compact",
              "quantize_blocked", "dequantize_blocked", "k1")


class DqRecorder:
    """What the DQ path did in each query run, read by wrapping (not
    changing) the port's functions while the path runs: the device ms of
    the count exchange (`dq_bucket_plane` + `dq_counts`), the send
    segments, the int8 codec (`quantize_blocked` + `dequantize_blocked`),
    the exchange of segments and the compaction of the received rows
    (CUDA events around each call), and the inputs of the largest calls
    of the DQ kernels, which `dq_kernel_phase` checks and times."""

    KINDS = ("counts", "segments", "quantize", "exchange", "compact")

    def __init__(self, bindings):
        import torch

        from ydb_tpu_torch.dq import ici
        self.events = {k: [] for k in self.KINDS}
        self.calls = {}
        self._restore = []
        rec = self

        def timed(kind, real, key=None):
            def fn(*a, **k):
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                out = real(*a, **k)
                e.record()
                rec.events[kind].append((s, e))
                if key is not None:
                    rec._keep(key(*a, **k), a, k)
                return out
            return fn

        def plane_key(keys, *a, **k):
            return ("dq_bucket_plane", keys.numel())

        def counts_key(planes, ndev):
            return (f"dq_counts nch={planes.shape[0]}", planes.numel())

        def quant_key(x, *a, **k):
            return ("quantize_blocked", x.numel())

        for owner, name, kind, key in (
                (bindings, "dq_bucket_plane", "counts", plane_key),
                (bindings, "dq_counts", "counts", counts_key),
                (bindings, "segments", "segments", None),
                (bindings, "quantize_blocked", "quantize", quant_key),
                (bindings, "dequantize_blocked", "quantize", None),
                (ici, "exchange_segments", "exchange", None),
                (ici, "compact_segments", "compact", None)):
            real = getattr(owner, name)
            self._restore.append((owner, name, real))
            setattr(owner, name, timed(kind, real, key))

    def _keep(self, key, a, k) -> None:
        name, size = key
        old = self.calls.get(name)
        if old is None or size > old[0]:
            self.calls[name] = (size, a, k)

    def note(self) -> str:
        parts = []
        for kind in self.KINDS:
            evs = self.events[kind]
            ms = sum(s.elapsed_time(e) for s, e in evs)
            parts.append(f"{kind}_ms={ms:.3f}({len(evs)})")
            evs.clear()
        return " ".join(parts)

    def start(self) -> None:
        for v in self.events.values():
            v.clear()

    def close(self) -> None:
        for owner, name, real in reversed(self._restore):
            setattr(owner, name, real)
        self._restore = []


def frames_bit_equal(a, b, tag) -> None:
    """Two answers equal column by column: floats bit for bit (NaN for
    NaN), everything else exactly."""
    import numpy as np
    check(list(a.columns) == list(b.columns), f"{tag}: columns")
    check(len(a) == len(b), f"{tag}: rows {len(a)} != {len(b)}")
    for col in a.columns:
        x, y = a[col].to_numpy(), b[col].to_numpy()
        if x.dtype.kind == "f" or y.dtype.kind == "f":
            same = np.array_equal(x.astype(np.float64), y.astype(np.float64),
                                  equal_nan=True)
        else:
            same = np.array_equal(x, y)
        check(same, f"{tag}: column {col} differs")


def _dq_channel_stats(cluster) -> str:
    rows = [r for r in cluster.last_stage_stats if r["state"] == "channel"]
    return (f"ici_bytes={sum(r['ici_bytes'] for r in rows)} "
            f"seg={[r.get('seg', 0) for r in rows]} "
            f"pad_efficiency={[r['pad_efficiency'] for r in rows]}")


def dq_phase(B, data, sf: float, oracle, recorder) -> dict:
    """The DQ path: TPC-H at `sf` over DQ_WORKERS worker engines
    (`QueryEngine()`, on the card) filled by the port's loader (lineitem
    and orders split by the reference router's INSERT rule, the other six
    tables replicated), through `ShardedCluster.query` on
    `YDB_TPU_DQ_PLANE=auto`: the 8 answered queries against their oracle,
    the 14 others refused with `ClusterError`, the shuffle queries on the
    ICI plane; q3, q10 and q12 again on the host plane (byte-equal); the
    quant pass; a hand-built Broadcast ICI graph and a stage with two ICI
    hash-shuffle outputs. The launch counters are set to 0 before the
    path and read after it; returns them."""
    import numpy as np

    from ydb_tpu_torch.bench.cluster_load import load_tpch_cluster, worker_of
    from ydb_tpu_torch.bench.tpch_oracle import QUERIES, assert_frames_match
    from ydb_tpu_torch.cluster import ShardedCluster
    from ydb_tpu_torch.cluster.router import ClusterError
    from ydb_tpu_torch.dq.graph import (BROADCAST, HASH_SHUFFLE, UNION_ALL,
                                        Channel, Stage, StageGraph)
    from ydb_tpu_torch.dq.runner import DqTaskRunner, LocalWorker
    from ydb_tpu_torch.query import QueryEngine
    from ydb_tpu_torch.utils.metrics import GLOBAL

    t0 = time.perf_counter()
    engines = [QueryEngine() for _ in range(DQ_WORKERS)]
    for e in engines:
        check(e.device.type == "cuda", e.device)
        e.executor.device_cache.budget = DQ_CACHE_BUDGET
    _d, replicated, keys = load_tpch_cluster([e.catalog for e in engines],
                                             sf, data=data)
    cluster = ShardedCluster([LocalWorker(e, name=f"dq{i}")
                              for i, e in enumerate(engines)],
                             merge_engine=engines[0])
    cluster.replicated, cluster.key_columns = replicated, keys
    li = [e.catalog.table("lineitem").num_rows for e in engines]
    log(f"dq: TPC-H sf={sf} over {DQ_WORKERS} worker engines on one card "
        f"(lineitem rows per worker {li}; {sorted(replicated)} "
        f"replicated), {time.perf_counter() - t0:.1f} s")
    check(cluster._ici_devices() == DQ_WORKERS, "dq: no ICI plane")

    def env(plane="auto", quant="0"):
        os.environ["YDB_TPU_DQ_PLANE"] = plane
        os.environ["YDB_TPU_DQ_QUANT"] = quant

    def run(sql):
        recorder.start()
        t = time.perf_counter()
        got = cluster.query(sql)
        ms = (time.perf_counter() - t) * 1e3
        return got, ms, recorder.note(), _dq_channel_stats(cluster)

    t_path = time.perf_counter()
    B.reset_launches()
    answers = {}
    try:
        env()
        for i in range(1, 23):
            q = f"q{i}"
            graph = cluster.plan(QUERIES[q]) if q in DQ_ANSWERED \
                or q in DQ_RUN_REFUSED else None
            ib0, cb0 = GLOBAL.get("dq/ici_bytes"), \
                GLOBAL.get("dq/channel_bytes")
            if q not in DQ_ANSWERED:
                try:
                    cluster.query(QUERIES[q])
                except ClusterError as e:
                    why = str(e).splitlines()[0][:90]
                else:
                    raise AssertionError(f"dq {q}: answered, expected "
                                         "ClusterError")
                if q in DQ_SHUFFLE:
                    check(GLOBAL.get("dq/ici_bytes") > ib0,
                          f"dq {q}: no ICI bytes before the refusal")
                check(GLOBAL.get("dq/channel_bytes") == cb0,
                      f"dq {q}: host-plane bytes")
                log(f"query dq {q}: refused (ClusterError: {why}) ok")
                continue
            shuffle = any(ch.kind == HASH_SHUFFLE
                          for ch in graph.channels.values())
            check(shuffle == (q in DQ_SHUFFLE), f"dq {q}: shuffle edges")
            before = dict(B.LAUNCHES)
            runs = [run(QUERIES[q]) for _ in range(3)]
            per_query = {k: v - before[k] for k, v in B.LAUNCHES.items()
                         if v > before[k]}
            got = runs[0][0]
            assert_frames_match(got, oracle(q), ordered=True)
            for r in runs[1:]:
                frames_bit_equal(r[0], got, f"dq {q} warm")
            answers[q] = got
            if shuffle:
                check(GLOBAL.get("dq/ici_bytes") > ib0,
                      f"dq {q}: dq/ici_bytes did not grow")
            check(GLOBAL.get("dq/channel_bytes") == cb0,
                  f"dq {q}: dq/channel_bytes moved")
            warm = min(range(1, 3), key=lambda j: runs[j][1])
            log(f"query dq {q}: lane=dq plane="
                f"{'ici' if shuffle else 'none (no worker-bound edge)'} "
                f"stages={len(graph.stages)} cold_ms={runs[0][1]:.2f} "
                f"warm_ms={runs[warm][1]:.2f} rows={len(got)} "
                f"{runs[warm][3]} cold: {runs[0][2]} warm: {runs[warm][2]} "
                f"ok launches_3_runs={json.dumps(per_query)}")

        # the host plane: frames through the workers' exchange buffers
        for q in DQ_HOST_CHECK:
            env(plane="host")
            cb0 = GLOBAL.get("dq/channel_bytes")
            t = time.perf_counter()
            got = cluster.query(QUERIES[q])
            ms = (time.perf_counter() - t) * 1e3
            check(GLOBAL.get("dq/channel_bytes") > cb0,
                  f"dq {q} host: no channel bytes")
            frames_bit_equal(got, answers[q], f"dq {q} host vs ici")
            log(f"query dq {q} host plane: wall_ms={ms:.2f} byte-equal to "
                f"the ICI answer ok")
        env()

        # the quant pass
        saved0 = GLOBAL.get("dq/quant_bytes_saved")
        refused0 = GLOBAL.get("dq/quant_refused")
        for q, (key, topk) in DQ_QUANT.items():
            full = QUERIES[q] if topk is None else QUERIES[q].replace(topk,
                                                                     "")
            check(topk is None or full != QUERIES[q], f"dq quant {q}: sql")
            exact, ms_exact, _n, _s = run(full)
            env(quant="1")
            s0, r0 = GLOBAL.get("dq/quant_bytes_saved"), \
                GLOBAL.get("dq/quant_refused")
            got, ms, note, stats = run(QUERIES[q])
            env()
            check(list(got.columns) == list(exact.columns)
                  and len(got) == len(answers[q]), f"dq quant {q}: shape")
            check(got[key].is_unique, f"dq quant {q}: keys repeat")
            want = exact.set_index(key).loc[got[key].to_numpy()] \
                .reset_index()[list(got.columns)]
            worst = 0.0
            for col in got.columns:
                x, y = got[col].to_numpy(), want[col].to_numpy()
                if col == "revenue":     # the one sum of quantized inputs
                    np.testing.assert_allclose(x, y, rtol=DQ_QUANT_RTOL,
                                               err_msg=f"dq quant {q} {col}")
                    worst = max(worst, float(np.max(
                        np.abs(x - y) / np.maximum(np.abs(y), 1e-300))))
                else:                    # keys, counts, exact columns
                    frames_bit_equal(got[[col]], want[[col]],
                                     f"dq quant {q}")
            log(f"query dq {q} quant: rows={len(got)} exact_full_group_by_ms="
                f"{ms_exact:.2f} quant_ms={ms:.2f} max_rel_err={worst:.3g} "
                f"quant_bytes_saved="
                f"{GLOBAL.get('dq/quant_bytes_saved') - s0} quant_refused="
                f"{GLOBAL.get('dq/quant_refused') - r0} {stats} {note} ok")
        check(GLOBAL.get("dq/quant_bytes_saved") > saved0,
              "dq quant: no bytes saved")
        check(GLOBAL.get("dq/quant_refused") > refused0,
              "dq quant: q12's o_orderpriority not refused")

        # a hand-built Broadcast ICI edge over an orders projection
        n_orders = len(data.tables["orders"]["o_orderkey"])
        total = float(np.sum(data.tables["orders"]["o_totalprice"]))
        workers = cluster.workers
        ch = Channel(id="dqc_chip_b1", kind=BROADCAST, src_stage="s0",
                     dst_stage="s1", columns=["o_orderkey", "o_totalprice"],
                     table="__xj_dq_chip_bcast", plane="ici")
        out = Channel(id="dqc_chip_b2", kind=UNION_ALL, src_stage="s1")
        g = StageGraph(
            stages=[Stage(id="s0", sql="select o_orderkey, o_totalprice "
                          "from orders", outputs=[ch.id]),
                    Stage(id="s1", sql="select count(*) as c, "
                          f"sum(o_totalprice) as s from {ch.table}",
                          inputs=[ch.id], outputs=[out.id]),
                    Stage(id="merge", inputs=[out.id], on="router")],
            channels={ch.id: ch, out.id: out}, tag="chipb")
        recorder.start()
        t = time.perf_counter()
        got = DqTaskRunner(workers, engines[0]).run(g)
        ms = (time.perf_counter() - t) * 1e3
        check(ch.plane == "ici", "dq broadcast: fell back")
        check(list(got.c) == [n_orders] * DQ_WORKERS,
              f"dq broadcast: counts {list(got.c)}")
        np.testing.assert_allclose(got.s, total, rtol=RTOL)
        log(f"dq broadcast: every worker saw all {n_orders} orders rows, "
            f"wall_ms={ms:.2f} {recorder.note()} ok")

        # a stage with two ICI hash-shuffle outputs: the batched count
        # exchange (one dq_counts launch over both planes)
        c1 = Channel(id="dqc_chip_h1", kind=HASH_SHUFFLE, src_stage="s0",
                     dst_stage="s1", key="o_orderkey",
                     columns=["o_orderkey", "o_custkey", "o_totalprice"],
                     table="__xj_dq_chip_h1", plane="ici")
        c2 = Channel(id="dqc_chip_h2", kind=HASH_SHUFFLE, src_stage="s0",
                     dst_stage="s2", key="o_custkey",
                     columns=["o_orderkey", "o_custkey", "o_totalprice"],
                     table="__xj_dq_chip_h2", plane="ici")
        o1 = Channel(id="dqc_chip_o1", kind=UNION_ALL, src_stage="s1")
        o2 = Channel(id="dqc_chip_o2", kind=UNION_ALL, src_stage="s2")
        g = StageGraph(
            stages=[Stage(id="s0", sql="select o_orderkey, o_custkey, "
                          "o_totalprice from orders",
                          outputs=[c1.id, c2.id]),
                    Stage(id="s1", sql="select count(*) as c, "
                          f"sum(o_totalprice) as s from {c1.table}",
                          inputs=[c1.id], outputs=[o1.id]),
                    Stage(id="s2", sql="select count(*) as c, "
                          f"sum(o_totalprice) as s from {c2.table}",
                          inputs=[c2.id], outputs=[o2.id]),
                    Stage(id="merge", inputs=[o1.id, o2.id], on="router")],
            channels={c.id: c for c in (c1, c2, o1, o2)}, tag="chiph")
        nb0 = GLOBAL.get("dq/count_exchange_batched")
        recorder.start()
        t = time.perf_counter()
        got = DqTaskRunner(workers, engines[0]).run(g)
        ms = (time.perf_counter() - t) * 1e3
        check(GLOBAL.get("dq/count_exchange_batched") == nb0 + 1,
              "dq two outputs: no batched count exchange")
        check(c1.plane == c2.plane == "ici", "dq two outputs: fell back")
        check("dq_counts nch=2" in recorder.calls,
              "dq two outputs: no nch=2 counts launch")
        # each consumer's rows are the ones its key routes to: counts
        # and sums per (edge, consumer) from the generated orders
        orders = data.tables["orders"]
        want_c, want_s = [], []
        for key in ("o_orderkey", "o_custkey"):
            dst = worker_of(orders[key], DQ_WORKERS)
            want_c += np.bincount(dst, minlength=DQ_WORKERS).tolist()
            want_s += np.bincount(dst, weights=orders["o_totalprice"],
                                  minlength=DQ_WORKERS).tolist()
        c = list(got.c)
        check(c == want_c, f"dq two outputs: counts {c}, want {want_c}")
        np.testing.assert_allclose(got.s.to_numpy(), want_s, rtol=RTOL)
        log(f"dq two outputs: per-consumer rows {c}, wall_ms={ms:.2f} "
            f"{recorder.note()} ok")
    finally:
        os.environ.pop("YDB_TPU_DQ_PLANE", None)
        os.environ.pop("YDB_TPU_DQ_QUANT", None)
    launches = dict(B.LAUNCHES)
    log(f"launches (dq): {json.dumps(launches)} "
        f"path_s={time.perf_counter() - t_path:.1f}")
    missing = [k for k in DQ_KERNELS if launches[k] <= 0]
    check(not missing, f"kernels not launched on the DQ path: {missing}")
    return launches


def _bits(t):
    import torch
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def check_quant(B, x, sync, tag):
    """quantize_blocked and dequantize_blocked against their plain
    versions: codes, scales and the decoded values bit for bit (NaN for
    NaN)."""
    import torch
    q, s = B.quantize_blocked(x)
    pq, ps = B.quantize_blocked_plain(x)
    sync()
    check(torch.equal(q, pq), f"quantize {tag}: codes")
    check(torch.equal(_bits(s), _bits(ps)), f"quantize {tag}: scales")
    d = B.dequantize_blocked(q, s, x.dtype)
    pd_ = B.dequantize_blocked_plain(q, s, x.dtype)
    sync()
    nan = torch.isnan(pd_)
    check(torch.equal(torch.isnan(d), nan), f"dequantize {tag}: NaN")
    check(torch.equal(_bits(d)[~nan], _bits(pd_)[~nan]),
          f"dequantize {tag}: values")
    return q, s


def dq_kernel_phase(B, calls: dict, device: str = "cuda") -> list:
    """The DQ kernels against their plain versions, at the largest calls
    the DQ path gave them (`DqRecorder.calls`, timed: the table's rows):
    `quantize_blocked` / `dequantize_blocked` at the largest quantized
    send stack, `dq_bucket_plane` at the largest key plane, `dq_counts`
    at the largest [1, ndev, cap] and [2, ndev, cap] planes; then checked
    on NaN, +-inf, all-zero blocks, exact ties, float32, float64, 0 rows
    and planes with -1 rows."""
    import torch
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    rows = []
    for name in ("quantize_blocked", "dq_bucket_plane", "dq_counts nch=1",
                 "dq_counts nch=2"):
        check(name in calls, f"dq kernels: no {name} call recorded")
    # the int8 codec at the largest quantized stack
    x = calls["quantize_blocked"][1][0]
    q, s = check_quant(B, x, sync, "largest stack")
    n = x.numel()
    shape = f"{tuple(x.shape)} {str(x.dtype)[6:]} (the DQ path's largest)"
    xb = x.reshape(-1, 128)
    rows.append(dict(
        name="quantize_blocked", route="cuda",
        source="ydb_tpu_torch/ops/cuda/csrc/quant.cu",
        replaces="ydb_tpu/parallel/collective.py:160", shape=shape,
        max_abs_err=0.0, ms=time_ms(lambda: B.quantize_blocked(x)),
        plain_ms=time_ms(lambda: B.quantize_blocked_plain(x)),
        # a floor: the block max-abs alone (no NaN mask, no codes)
        library_ms=time_ms(lambda: xb.abs().amax(dim=1)),
        bound_ms=bound_ms(n * x.element_size() + n + s.numel() * 4),
        bound_by="bytes"))
    rows.append(dict(
        name="dequantize_blocked", route="cuda",
        source="ydb_tpu_torch/ops/cuda/csrc/quant.cu",
        replaces="ydb_tpu/parallel/collective.py:176", shape=shape,
        max_abs_err=0.0,
        ms=time_ms(lambda: B.dequantize_blocked(q, s, x.dtype)),
        plain_ms=time_ms(lambda: B.dequantize_blocked_plain(q, s,
                                                            x.dtype)),
        # a floor: the int8 -> float conversion alone
        library_ms=time_ms(lambda: q.to(x.dtype)),
        bound_ms=bound_ms(n + s.numel() * 4 + n * x.element_size()),
        bound_by="bytes"))
    # the bucket plane at the largest key plane
    a, k = calls["dq_bucket_plane"][1], calls["dq_bucket_plane"][2]
    got = B.dq_bucket_plane(*a, **k)
    want = B.dq_bucket_plane_plain(*a, **k)
    sync()
    check(torch.equal(got, want), "dq_bucket_plane: largest plane")
    keys, valid, lengths = a[0], a[1], a[2]
    rows.append(dict(
        name="dq_bucket_plane", route="cuda",
        source="ydb_tpu_torch/ops/cuda/csrc/dq_counts.cu",
        replaces="ydb_tpu/dq/ici.py:763", max_abs_err=0.0,
        shape=f"{tuple(keys.shape)} {str(keys.dtype)[6:]} keys, "
              f"valid={valid is not None}, ndev={a[3]}",
        ms=time_ms(lambda: B.dq_bucket_plane(*a, **k)),
        plain_ms=time_ms(lambda: B.dq_bucket_plane_plain(*a, **k)),
        library_ms=None,            # no PyTorch call computes splitmix64
        bound_ms=bound_ms(distinct_bytes([keys, valid, lengths])
                          + keys.numel() * 4),
        bound_by="bytes"))
    # the count exchange, solo and batched
    for nch in (1, 2):
        (planes, ndev), _k = calls[f"dq_counts nch={nch}"][1:]
        got = B.dq_counts(planes, ndev)
        want = B.dq_counts_plain(planes, ndev)
        sync()
        check(torch.equal(got, want), f"dq_counts nch={nch}")
        nch_, nprod, cap = planes.shape
        # one flat id per (channel, producer, bucket + 1), -1 included
        ids = (planes.to(torch.int64) + 1 + (ndev + 1) * torch.arange(
            nch_ * nprod, device=planes.device).reshape(nch_, nprod, 1)
               ).reshape(-1)
        row = dict(
            name="dq_counts", route="cuda",
            source="ydb_tpu_torch/ops/cuda/csrc/dq_counts.cu",
            replaces="ydb_tpu/dq/ici.py:457", max_abs_err=0.0,
            shape=f"[{nch_}, {nprod}, {cap}] planes, ndev={ndev}",
            ms=time_ms(lambda: B.dq_counts(planes, ndev)),
            plain_ms=time_ms(lambda: B.dq_counts_plain(planes, ndev)),
            library_ms=time_ms(lambda: torch.bincount(
                ids, minlength=nch_ * nprod * (ndev + 1))),
            bound_ms=bound_ms(planes.numel() * 4 + nch_ * nprod * ndev * 4),
            bound_by="bytes")
        if nch == 1:
            rows.append(row)
        else:
            log(f"kernel dq_counts nch=2: {row['shape']} "
                f"kernel_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                f"library_ms={row['library_ms']:.4f} "
                f"bound_us={row['bound_ms'] * 1e3:.2f} (bytes)")
    # -- checked, not timed
    g = torch.Generator(device=dev)
    g.manual_seed(1616)
    for dt in (torch.float64, torch.float32):
        x = torch.randn((4, 2048), generator=g, device=dev,
                        dtype=torch.float64).mul_(13.0).to(dt)
        f = x.view(-1)
        f[:128] = torch.arange(128, device=dev, dtype=dt) - 63.5  # ties
        f[127] = 127.0
        f[130], f[131] = float("nan"), float("inf")
        f[256:384] = 0.0
        f[389], f[390] = float("-inf"), float("nan")
        f[512:640] = float("nan")
        f[640:768] *= 1e-30
        check_quant(B, x, sync, f"edge cases {dt}")
        check_quant(B, x[:, :0].contiguous(), sync, f"0 rows {dt}")
        check_quant(B, x[:1, :128].contiguous(), sync, f"one block {dt}")
    planes = torch.randint(-1, 4, (2, 4, 100_003), generator=g, device=dev,
                           dtype=torch.int32)
    check(torch.equal(B.dq_counts(planes, 4), B.dq_counts_plain(planes, 4)),
          "dq_counts: -1 rows")
    check(torch.equal(B.dq_counts(planes[:, :, :0].contiguous(), 4),
                      B.dq_counts_plain(planes[:, :, :0], 4)),
          "dq_counts: 0 rows")
    kk = torch.randint(-(1 << 62), 1 << 62, (4, 70_001), generator=g,
                       device=dev)
    kv = torch.rand((4, 70_001), generator=g, device=dev) > 0.2
    ln = torch.tensor([70_001, 5, 0, 69_999], dtype=torch.int32, device=dev)
    check(torch.equal(B.dq_bucket_plane(kk, kv, ln, 4),
                      B.dq_bucket_plane_plain(kk, kv, ln, 4)),
          "dq_bucket_plane: int keys")
    codes = torch.randint(-3, 40, (4, 70_001), generator=g, device=dev,
                          dtype=torch.int32)
    lut = torch.randint(0, 4, (37,), generator=g, device=dev,
                        dtype=torch.int32)
    check(torch.equal(B.dq_bucket_plane(codes, None, ln, 4, lut),
                      B.dq_bucket_plane_plain(codes, None, ln, 4, lut)),
          "dq_bucket_plane: string codes")
    log("kernel dq edge cases: NaN, +-inf, all-zero and all-NaN blocks, "
        "ties, float32/float64, 0 rows; planes with -1 rows; int and "
        "string keys ok")
    return rows


PTXAS_CHECKED = ("segment_agg", "bucket_sort", "sort", "window_scan",
                 "bucket_agg", "compact", "expand", "partition", "probe",
                 "segments")
# the kernels whose every function must keep its state in registers: a
# stack frame or a spill fails the run
PTXAS_NO_SPILL = ("segment_agg", "sort", "window_scan", "partition",
                  "probe", "segments")
# and in bucket_agg, compact and expand, the kernels of K2, K2/K3 xB,
# K3, K6 xB and K8's counts (by name)
PTXAS_NO_SPILL_FUNCTIONS = ("keyless_stream", "keyless_fold",
                            "keyless_members", "bucket_agg_members",
                            "compact_members", "ex_counts")


def ptxas_functions(text: str) -> list:
    """Per kernel function of an ``nvcc -Xptxas -v`` log: its (mangled)
    name, registers, stack frame and spill bytes."""
    import re
    out, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = {"name": m.group(1), "registers": None}
            out.append(cur)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None and cur["registers"] is None:
            cur["registers"] = int(m.group(1))
    return [f for f in out if "stack" in f and f["name"].startswith("_Z")]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", type=float, default=1.0,
                    help="TPC-H scale factor (TPC-DS runs at SF1)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one warm run of each TPC-H query with "
                    "torch.profiler and print where its time goes")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, HERE)

    from ydb_tpu_torch.bench import clickbench_oracle, tpcds_oracle
    from ydb_tpu_torch.bench.clickbench_gen import load_hits
    from ydb_tpu_torch.bench.tpcds_gen import load_tpcds
    from ydb_tpu_torch.bench.tpch_gen import load_tpch
    from ydb_tpu_torch.bench.tpch_oracle import QUERIES, oracle
    from ydb_tpu_torch.ops.cuda import bindings, build
    from ydb_tpu_torch.ops.device import bucket_capacity
    from ydb_tpu_torch.progstore.buckets import bucket_segment, bucket_sources
    from ydb_tpu_torch.query import QueryEngine
    from ydb_tpu_torch.sql import parse

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)

    # 2. build
    t0 = time.perf_counter()
    built = build.build_all(verbose=True)
    build_s = time.perf_counter() - t0
    log(f"build: {len(built)} kernels in {build_s:.2f} s "
        + " ".join(f"{k}={v['seconds']}s" for k, v in built.items()))
    for k, v in built.items():
        if k in PTXAS_CHECKED:
            continue
        for line in v["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {k}: {line.strip()}")
    # K2, K3, K4, K5 (and its member compaction), K6, K9, K13 and K15a:
    # each kernel function's registers, stack frame and spills;
    # segment_agg's accumulators, the sort's tile, the window scan's rows,
    # the keyless folds' loads, the member compaction's bitmaps and the
    # segments scatter's targets and ranks must live in registers
    spilled = []
    for k in PTXAS_CHECKED:
        for fn in ptxas_functions(built[k]["log"]):
            log(f"  ptxas {k} {fn['name']}: registers={fn['registers']} "
                f"stack_frame={fn['stack']} spill_stores={fn['spill_stores']} "
                f"spill_loads={fn['spill_loads']}")
            strict = k in PTXAS_NO_SPILL or any(
                f in fn["name"] for f in PTXAS_NO_SPILL_FUNCTIONS)
            if strict and (fn["stack"] or fn["spill_stores"]
                           or fn["spill_loads"]):
                spilled.append(fn["name"])
    check(not spilled, f"a stack frame or spills in {spilled}")
    # K1: NVRTC at first use; a trivial stage first, so a missing
    # libnvrtc or a failed compile ends the run here
    from ydb_tpu_torch.ops import ir, k1
    from ydb_tpu_torch.ops.cuda import nvrtc
    t0 = time.perf_counter()
    x = torch.arange(1 << 10, dtype=torch.int64, device="cuda")
    env = {"x": (x, None)}
    k1.run_stage((ir.Assign("y", ir.call("add", ir.Col("x"), ir.Col("x"))),),
                 env, {}, None, 1 << 10, "cuda")
    torch.cuda.synchronize()
    check(torch.equal(env["y"][0], x * 2), "k1: the trivial stage is wrong")
    log(f"build: k1 NVRTC {'.'.join(map(str, nvrtc.version()))}, one "
        f"trivial stage in {time.perf_counter() - t0:.3f} s")

    # 3. data: TPC-H at --sf, TPC-DS at SF1 and ClickBench's hits at
    # 1,000,000 rows (the reference bench's sizes), each in its engine
    t0 = time.perf_counter()
    eng = QueryEngine()
    check(eng.device.type == "cuda", eng.device)
    data = load_tpch(eng.catalog, sf=args.sf)
    li = eng.catalog.table("lineitem")
    portions = [p for s in li.shards for p in s.portions]
    K = bucket_sources(len(portions))
    CAP = max(bucket_capacity(max(p.num_rows, 1)) for p in portions)
    n = K * CAP
    log(f"data: sf={args.sf} lineitem={li.num_rows} rows, superblock "
        f"K={K} CAP={CAP} n={n}, {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    eng_ds = QueryEngine()
    raw_ds = load_tpcds(eng_ds.catalog, sf=1.0)
    log(f"data: TPC-DS sf=1 store_sales="
        f"{eng_ds.catalog.table('store_sales').num_rows} rows, "
        f"{time.perf_counter() - t0:.1f} s")
    # the TPC-DS queries' oracle answers, in worker processes beside the
    # card's phases: pandas takes about 2 s a query at SF1, the card
    # about 0.1 (daemonic workers: they end with this process)
    import multiprocessing
    ds_names = tuple(dict.fromkeys(TPCDS_QUERIES + TPCDS_REST))
    oracle_pool = multiprocessing.get_context("spawn").Pool(
        TPCDS_ORACLE_WORKERS)
    ds_parts = oracle_pool.map_async(
        tpcds_oracles, [ds_names[i::TPCDS_ORACLE_WORKERS]
                        for i in range(TPCDS_ORACLE_WORKERS)])
    ds_answers = {}

    def tpcds_answer(q):
        if q == "k13":
            return k13_oracle(raw_ds)
        if not ds_answers:
            for part in ds_parts.get():
                ds_answers.update(part)
        return ds_answers[q].copy()
    t0 = time.perf_counter()
    eng_cb = QueryEngine()
    raw_cb = load_hits(eng_cb.catalog, n_rows=CLICKBENCH_ROWS)
    log(f"data: ClickBench hits={CLICKBENCH_ROWS} rows, "
        f"{time.perf_counter() - t0:.1f} s")

    # 4. kernels vs plain at the queries' shapes: Q6's compact capacity
    # is sized as the executor sizes it (CBO estimate, 25% headroom, the
    # segment ladder); Q14's LUT spans part's dense p_partkey range
    q6 = eng.planner.plan_select(parse(QUERIES["q6"]))
    est_q6 = min(float(li.num_rows), float(q6.pipeline.scan.est_rows))
    q6_cap = bucket_segment(max(int(est_q6 * 1.25) + 1, 1024))
    n_part = eng.catalog.table("part").num_rows
    lut_span = bucket_capacity(n_part, minimum=1024)
    rows = kernel_phase(bindings, n, q6_cap, n_part, lut_span)
    rows += sorted_lane_phase(bindings, n, CAP,
                              max(p.num_rows for p in portions))
    sort_checks(bindings)
    f1_phase(bindings)
    rows += k8_phase(bindings)
    ss = {c: torch.as_tensor(raw_ds["store_sales"][c], device="cuda")
          for c in ("ss_item_sk", "ss_sold_date_sk", "ss_ext_sales_price",
                    "ss_sales_price", "ss_net_profit")}
    rows += k13_phase(bindings, ss)
    del ss
    # the serving lane's member-axis entries: c40's columns over the 1M
    # hits rows, orders' capacity and the point-lookup batch as the
    # serving path runs it
    import numpy as np

    from ydb_tpu_torch.bench import serving
    hits = {c: torch.as_tensor(np.asarray(raw_cb[c]), device="cuda")
            for c in ("URLHash", "EventDate", "CounterID", "IsRefresh",
                      "TraficSourceID", "RefererHash")}
    orders = eng.catalog.table("orders")
    o_portions = [p for s in orders.shards for p in s.portions]
    orders_n = bucket_sources(len(o_portions)) * max(
        bucket_capacity(max(p.num_rows, 1)) for p in o_portions)
    order_keys = data.tables["orders"]["o_orderkey"]
    point_b, _est, _gates = admitted_batch(
        eng, serving.point_variants(order_keys, 1, SERVING_SEED)[0], 64)
    rows += batched_kernel_phase(bindings, n, hits, orders_n, point_b)
    del hits
    rows += k1_phase(bindings, eng, QUERIES)
    # F1 through the main path: the 16-column queries on the card, each
    # held against the oracle and against the plain path (the CPU)
    t0 = time.perf_counter()
    f1_query_phase(bindings, eng, QueryEngine(catalog=eng.catalog,
                                              device="cpu"), data)
    log(f"f1 queries: {time.perf_counter() - t0:.1f} s")

    # 5. the main path, path by path, through QueryEngine.query; the
    # beyond-budget path runs a second engine over the TPC-H data with
    # the device budgets cut to a hundredth
    eng_bb = QueryEngine(catalog=eng.catalog)
    for k, v in BEYOND_BUDGETS.items():
        setattr(eng_bb.executor, k, v)
    log(f"beyond the budgets: TPC-H sf={args.sf} with the budgets over "
        "100 (" + ", ".join(f"{k}={v}" for k, v in BEYOND_BUDGETS.items())
        + "), as SF100 meets the defaults on one card (SF100's 600M "
        "lineitem rows are beyond the host generator and this run's time "
        "limit)")
    # the mesh path: TPC-H again, loaded with MESH_SHARDS shards, through
    # an engine whose mesh lists the card once per shard, and through a
    # second engine over the same catalog whose broadcast budget is 1
    from ydb_tpu_torch.parallel import make_mesh
    t0 = time.perf_counter()
    eng_mesh = QueryEngine(mesh=make_mesh(MESH_SHARDS, device="cuda:0"))
    load_tpch(eng_mesh.catalog, sf=args.sf, shards=MESH_SHARDS)
    eng_sj = QueryEngine(catalog=eng_mesh.catalog,
                         mesh=make_mesh(MESH_SHARDS, device="cuda:0"))
    eng_sj.executor.dist_broadcast_budget_bytes = 1
    log(f"mesh: TPC-H sf={args.sf}, {MESH_SHARDS} shards, "
        f"{sum(len(s.portions) for s in eng_mesh.catalog.table('lineitem').shards)}"
        f" lineitem portions, mesh {eng_mesh.executor.mesh}, "
        f"{time.perf_counter() - t0:.1f} s; exchanges are copies within "
        "one card")
    mesh_rec = MeshRecorder(bindings)
    recorder = LaneRecorder(eng_bb.executor)
    # the medium-domain lane at full width: q10 over TPC-H at Q10_SF
    t0 = time.perf_counter()
    eng_q10 = QueryEngine()
    data_q10 = load_tpch(eng_q10.catalog, sf=Q10_SF)
    log(f"q10 medium domain: TPC-H sf={Q10_SF}, "
        f"{eng_q10.catalog.table('customer').num_rows} customers, "
        f"{time.perf_counter() - t0:.1f} s")
    q10_rec = MediumLaneRecorder()
    answers = {}

    def tpch_oracle(q):
        # pandas takes seconds a query at SF1: each TPC-H answer is
        # computed once and shared by the paths over the same data
        if q not in answers:
            answers[q] = oracle(q, data)
        return answers[q].copy()
    suites = {
        "tpch": (eng, QUERIES, tpch_oracle),
        "tpcds": (eng_ds, {**tpcds_oracle.QUERIES, "k13": K13_SQL},
                  tpcds_answer),
        "clickbench": (eng_cb, clickbench_oracle.QUERIES,
                       lambda q: clickbench_oracle.oracle(q, raw_cb)),
        "tpch_beyond": (eng_bb, {**QUERIES, **BEYOND_EXTRA},
                        lambda q: beyond_oracle(q, data) if q in BEYOND_EXTRA
                        else tpch_oracle(q), recorder),
        "tpch_mesh": (eng_mesh, QUERIES, tpch_oracle,
                      mesh_rec.view("tpch_mesh")),
        "tpch_mesh_sj": (eng_sj, QUERIES, tpch_oracle,
                         mesh_rec.view("tpch_mesh_sj")),
        "tpch_q10": (eng_q10, QUERIES, lambda q: oracle(q, data_q10),
                     q10_rec),
    }
    try:
        launches = slice_phase(bindings, suites)
    finally:
        recorder.close()
        mesh_rec.close()
        q10_rec.close()
        oracle_pool.terminate()
        oracle_pool.join()
    check(q10_rec.calls >= 3, "q10 at SF 0.4 did not take the "
          "medium-domain lane")
    del suites["tpch_mesh"], suites["tpch_mesh_sj"], eng_mesh, eng_sj
    del suites["tpch_q10"], eng_q10, data_q10
    served = serving_phase(
        bindings, {"tpch": eng, "clickbench": eng_cb},
        {"tpch": lambda q: oracle(q, data),
         "clickbench": lambda q: clickbench_oracle.oracle(q, raw_cb)},
        order_keys)
    for k, v in served.items():
        launches[k] += v
    # the DQ path: TPC-H at --sf as stage graphs over DQ_WORKERS engines
    dq_rec = DqRecorder(bindings)
    try:
        dq_launches = dq_phase(bindings, data, args.sf, tpch_oracle, dq_rec)
    finally:
        dq_rec.close()
    for k, v in dq_launches.items():
        launches[k] += v
    log(f"launches (all paths): {json.dumps(launches)}")
    if args.profile:
        profile_phase(eng, QUERIES)
        # the store_sales window query: K9's partition sorts, K13
        profile_phase(eng_ds, {"k13": K13_SQL}, names=["k13"])
        profile_beyond_phase(eng_bb, {**QUERIES, **BEYOND_EXTRA})
    os.environ.pop("YDB_TPU_LATE_MAT", None)

    # 6. the partition kernel at the largest spill feed of the
    # beyond-budget path and at a GraceJoin routing of lineitem
    check(recorder.largest is not None, "beyond the budgets: no spill feed")
    li_cols = {}
    for c in ("l_orderkey", "l_partkey", "l_extendedprice", "l_discount"):
        col = torch.zeros(n, dtype=torch.float64 if c in (
            "l_extendedprice", "l_discount") else torch.int64)
        col[:li.num_rows] = torch.from_numpy(data.tables["lineitem"][c])
        li_cols[c] = col.to("cuda")
    li_cols["big"] = (li_cols["l_extendedprice"] > 50_000).contiguous()
    rows += partition_phase(bindings, recorder.largest[1], li_cols, n,
                            li.num_rows)
    # 7. the probe kernel at q9's sorted-keys probe (partsupp)
    rows += probe_q9_phase(bindings, record_probes(bindings, eng,
                                                   QUERIES["q9"]))
    # 9. the segments kernel at the shapes the mesh paths gave it
    rows += segments_phase(bindings, mesh_rec.calls)
    # 10. the DQ kernels at the largest calls the DQ path gave them
    rows += dq_kernel_phase(bindings, dq_rec.calls)
    for r in rows:
        lib = "—" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"kernel {r['name']}: {r['shape']} kernel_ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms={lib} "
            f"bound_us={r['bound_ms'] * 1e3:.2f} "
            f"max_abs_err={r['max_abs_err']:.3g}")

    table = [{k: r[k] for k in ("name", "route", "source", "replaces",
                                "shape")}
             | {"launches": launches[r["name"]],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
             for r in rows]
    from ydb_tpu_torch.utils.metrics import GLOBAL
    log(f"k1: {GLOBAL.get('k1/builds')} NVRTC builds in "
        f"{GLOBAL.get('k1/build_ms') / 1e3:.2f} s, "
        f"{GLOBAL.get('k1/cache_hits')} cubin cache hits")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": table}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


CLICKBENCH_ROWS = 1_000_000        # the reference bench's BENCH_CLICKBENCH_ROWS

# TPC-DS: the 25 queries this slice opened (windows, SELECT without FROM,
# set operations, the expanding probe), then the reference bench's subset
TPCDS_WINDOWED = ("ds12", "ds20", "ds44", "ds47", "ds53", "ds63", "ds67",
                  "ds70", "ds89", "ds98")
TPCDS_QUERIES = tuple(dict.fromkeys(
    TPCDS_WINDOWED
    + ("ds9", "ds28", "ds61", "ds77", "ds88", "ds90",
       "ds33", "ds56", "ds60", "ds71", "ds76",
       "ds25", "ds29", "ds59", "ds72")
    + ("ds3", "ds7", "ds27", "ds42", "ds43", "ds52", "ds55", "ds62",
       "ds67", "ds70", "ds89", "ds94", "ds96", "ds97", "ds98")))
# the other 37 of the port's 73 TPC-DS queries, in the oracle's order:
# each runs once, cold (the keyed bucket_agg body under their
# small-domain group-bys)
TPCDS_REST = ("ds19", "ds65", "ds73", "ds13", "ds15", "ds18", "ds21",
              "ds22", "ds26", "ds32", "ds34", "ds37", "ds40", "ds45",
              "ds46", "ds48", "ds50", "ds58", "ds69", "ds79", "ds82",
              "ds85", "ds92", "ds93", "ds6", "ds8", "ds35", "ds38", "ds41",
              "ds66", "ds68", "ds74", "ds78", "ds80", "ds87", "ds95",
              "ds99")
TPCDS_ORACLE_WORKERS = 4


def tpcds_oracles(names) -> dict:
    """The port's TPC-DS oracle answers of `names` at SF1 (a worker
    process's job): the tables made again from the generator's seed, as
    the engine's were."""
    from ydb_tpu_torch.bench import tpcds_oracle
    from ydb_tpu_torch.bench.tpcds_gen import gen_tpcds
    raw = gen_tpcds(1.0)
    return {q: tpcds_oracle.oracle(q, raw) for q in names}


# the execution path each query must end on, where a slice fixes it
EXPECT_PATH = {
    "tpcds": {"ds25": "portioned", "ds29": "portioned", "ds59": "portioned",
              **{q: "literal" for q in ("ds9", "ds28", "ds61", "ds77",
                                        "ds88", "ds90")}},
    # at SF1 with the budgets over 100 (the seven others stay fused)
    "tpch_beyond": {
        **{q: "fused-tiled" for q in ("q1", "q5", "q6", "q14", "q17",
                                      "q19")},
        **{q: "fused-tiled-spill" for q in ("q3", "q8", "q10", "spill1")},
        "union1": "fused-tiled-union",
        **{q: "portioned" for q in ("q4", "q7", "q9", "q12", "q18",
                                    "q21")}},
    # each mesh lane is taken at least once
    "tpch_mesh": {"q1": "distributed", "q18": "distributed",
                  "q15": "distributed-map"},
    "tpch_mesh_sj": {"q14": "distributed-shuffle-join",
                     "q12": "distributed-shuffle-join"},
    "tpch_q10": {"q10": "fused"},
}
# q10 groups by c_name alone: its domain is the name dictionary, 150,000
# names per SF, so SF 0.4 gives 60,000 buckets, inside the medium-domain
# lane's 513 to 65,535 (at SF1 the sorted lane takes it)
Q10_SF = 0.4
# the mesh path: TPC-H on a mesh that lists the card once per shard
MESH_SHARDS = 4
# the queries whose last join the shuffle join accepts (the rest decline
# to the distributed lane: no join, or a duplicate-key build)
MESH_SHUFFLE_JOIN = tuple(f"q{i}" for i in (2, 3, 4, 5, 7, 8, 9, 10, 11,
                                             12, 14, 17, 18, 19, 20, 21,
                                             22))
# beyond-budget queries whose cold run must build a GraceJoin partitioned
# build (their portioned path probes it through the partition routing)
EXPECT_GRACE = ("q4", "q7", "q9", "q12", "q18", "q21")
CLICKBENCH_QUERIES = tuple(f"c{i}" for i in range(43))

# The main path, path by path: each path's queries run with the launch
# counters set to 0 just before and read just after, and each of the
# kernels it names must have launched in that run. A run is (query,
# options): "late" sets YDB_TPU_LATE_MAT (default on), "window_min_rows"
# the engine's window_device_min_rows for that query.
PATHS = (
    ("q1 q6 q14, late materialization on and off", "tpch",
     [("q1", {"late": "1"}), ("q6", {"late": "1"}), ("q14", {"late": "1"}),
      ("q1", {"late": "0"}), ("q14", {"late": "0"})],
     ("bucket_agg", "bucket_agg_keyless", "compact", "probe", "sort",
      "k1")),
    ("the other 19 queries: sorted and medium-domain group-by, hashing, "
     "CTEs and derived tables", "tpch",
     [(f"q{i}", {}) for i in range(2, 23) if i not in (6, 14)],
     ("bucket_agg", "compact", "probe", "sort", "segment_agg", "hash64",
      "k1")),
    ("TPC-DS at SF1: windows (the ten windowed queries again on the "
     "device lane), the expanding probe on the portioned path, set "
     "operations, SELECT without FROM, and the store_sales window query",
     "tpcds",
     [(q, {}) for q in TPCDS_QUERIES]
     + [(q, {"window_min_rows": 0}) for q in TPCDS_WINDOWED]
     + [("k13", {})],
     ("window_scan", "expand_counts", "expand_gather", "sort", "hash64",
      "probe", "compact", "k1")),
    ("TPC-DS at SF1: the other 37 queries, once each, cold", "tpcds",
     [(q, {"once": True}) for q in TPCDS_REST],
     ("bucket_agg", "compact", "probe", "sort", "segment_agg", "k1")),
    ("ClickBench, 1,000,000 rows", "clickbench",
     [(q, {}) for q in CLICKBENCH_QUERIES],
     ("bucket_agg", "compact", "sort", "segment_agg", "k1")),
    ("TPC-H beyond the budgets (the defaults over 100): the tiled lane, "
     "GraceJoin builds with partition routing, the spill merge", "tpch_beyond",
     [(f"q{i}", {}) for i in range(1, 23)]
     + [("spill1", {}), ("union1", {"unordered": True})],
     ("partition", "hash64", "probe", "compact", "bucket_agg", "sort",
      "segment_agg", "k1")),
    ("TPC-H on a mesh of 4 shards on one card: two-phase aggregations "
     "merged over the mesh, non-aggregating plans unioned", "tpch_mesh",
     [(f"q{i}", {}) for i in range(1, 23)],
     ("segments", "compact", "bucket_agg", "probe", "sort", "segment_agg",
      "k1")),
    ("TPC-H on the mesh with the broadcast budget 1: the shuffle join",
     "tpch_mesh_sj", [(q, {}) for q in MESH_SHUFFLE_JOIN],
     ("segments", "compact", "probe", "sort", "segment_agg", "k1")),
    ("TPC-H q10 at SF 0.4: the medium-domain lane (its 60,000 customer "
     "names, bucket_perm then segment_agg)", "tpch_q10", [("q10", {})],
     ("bucket_perm", "segment_agg", "probe", "k1")),
)


def slice_phase(bindings, suites: dict) -> dict:
    """Every path of `PATHS` through its suite's engine, each query
    checked against its oracle; returns each kernel's launches summed
    over the paths' runs (and nothing else)."""
    from ydb_tpu_torch.bench.tpch_oracle import assert_frames_match
    from ydb_tpu_torch.utils.metrics import GLOBAL
    total = {k: 0 for k in bindings.LAUNCHES}
    for label, suite, runs, kernels in PATHS:
        eng, queries, oracle, *recorder = suites[suite]
        recorder = recorder[0] if recorder else None
        k1_before = (GLOBAL.get("k1/builds"), GLOBAL.get("k1/build_ms"))
        t_path = time.perf_counter()
        bindings.reset_launches()
        for name, opts in runs:
            os.environ["YDB_TPU_LATE_MAT"] = opts.get("late", "1")
            saved = eng.config.window_device_min_rows
            if "window_min_rows" in opts:
                eng.config.window_device_min_rows = opts["window_min_rows"]
            walls, notes = [], []
            b0 = (GLOBAL.get("k1/builds"), GLOBAL.get("k1/build_ms"))
            try:
                for _ in range(1 if opts.get("once") else 3):
                    if recorder is not None:
                        recorder.start(name)
                    before = dict(bindings.LAUNCHES)
                    t0 = time.perf_counter()
                    got = eng.query(queries[name])
                    walls.append((time.perf_counter() - t0) * 1e3)
                    if recorder is not None:
                        notes.append((recorder.note(), list(recorder.grace)))
            finally:
                eng.config.window_device_min_rows = saved
            per_query = {k: v - before[k]
                         for k, v in bindings.LAUNCHES.items() if v > before[k]}
            path = eng.executor.last_path
            want_path = "fused" if suite == "tpch" \
                else EXPECT_PATH.get(suite, {}).get(name)
            check(want_path is None or path == want_path,
                  f"{name}: path {path}, expected {want_path}")
            if suite == "tpch_beyond" and name in EXPECT_GRACE:
                check(notes[0][1], f"{name}: no GraceJoin partitioned build")
            want = oracle(name)
            if suite in ("tpcds", "clickbench"):
                want.columns = list(got.columns)
            assert_frames_match(got, want, ordered=not opts.get("unordered"))
            tag = " ".join(f"{k}={v}" for k, v in opts.items()
                           if k != "once")
            lanes = f" cold: {notes[0][0]} warm: {notes[-1][0]}" \
                if notes else ""
            builds = (f" k1_builds={GLOBAL.get('k1/builds') - b0[0]} "
                      f"k1_build_ms="
                      f"{GLOBAL.get('k1/build_ms') - b0[1]:.1f}")
            warm = f"{min(walls[1:]):.2f}" if walls[1:] else "—"
            log(f"query {name}{' ' + tag if tag else ''}: "
                f"cold_ms={walls[0]:.2f} warm_ms={warm} "
                f"rows={len(got)} path={path} ok "
                f"{'launches' if opts.get('once') else 'warm_launches'}="
                f"{json.dumps(per_query)}{lanes}{builds}")
        launches = dict(bindings.LAUNCHES)
        log(f"launches ({label}): {json.dumps(launches)} k1_builds="
            f"{GLOBAL.get('k1/builds') - k1_before[0]} k1_build_s="
            f"{(GLOBAL.get('k1/build_ms') - k1_before[1]) / 1e3:.2f} "
            f"path_s={time.perf_counter() - t_path:.1f}")
        missing = [k for k in kernels if launches[k] <= 0]
        check(not missing, f"kernels not launched on {label}: {missing}")
        for k, v in launches.items():
            total[k] += v
    log(f"launches: {json.dumps(total)}")
    return total


# --------------------------------------------------------------------------
# K1: the generated expression-stage kernels
# --------------------------------------------------------------------------

K1_QUERIES = ("q1", "q6", "q19")
K1_ENTRY = "k1_stage"              # the generated kernels' name (ops/k1.py)
K1_SWEEP_ROWS = 1 << 20
K1_SWEEP_SEED = 20261017


class StageCapture:
    """The K1 stages a run hands to `k1.run_stage`, each with its inputs
    (wrapping, not changing, the function while the block runs)."""

    def __init__(self):
        self.stages = []

    def __enter__(self):
        from ydb_tpu_torch.ops import k1
        self._k1, self._real = k1, k1.run_stage

        def record(stage, env, params, sel, cap, device):
            self.stages.append((tuple(stage), dict(env), dict(params), sel,
                                cap))
            return self._real(stage, env, params, sel, cap, device)
        k1.run_stage = record
        return self

    def __exit__(self, *exc):
        self._k1.run_stage = self._real


def _k1_run(stage, env, params, sel, cap, device, plain: bool):
    """(outputs [(data, valid)] per Assign, selection) of one run."""
    from ydb_tpu_torch.ops import ir, k1
    e = dict(env)
    fn = k1.run_stage_plain if plain else k1.run_stage
    s = fn(stage, e, params, sel, cap, device)
    return [e[c.name] for c in stage if isinstance(c, ir.Assign)], s


def _k1_compare(got, want, tag) -> tuple:
    """Equal storage dtype, shape and validity presence; ints, bools and
    validity exactly; floats bit for bit (any NaN for any NaN), held at
    RTOL. Returns (largest float difference, bit-equal)."""
    import torch
    err, bits = 0.0, True
    for i, (g, w) in enumerate(zip(got, want)):
        check(g is not None and w is not None or g is w, f"{tag} {i}")
        if g is None:
            continue
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{tag} {i}: {g.dtype}{tuple(g.shape)} vs "
              f"{w.dtype}{tuple(w.shape)}")
        if not g.dtype.is_floating_point:
            check(torch.equal(g, w), f"{tag} {i}: values differ")
            continue
        gn, wn = torch.isnan(g), torch.isnan(w)
        check(torch.equal(gn, wn), f"{tag} {i}: NaN positions differ")
        gg, ww = g[~gn], w[~wn]
        torch.testing.assert_close(gg, ww, rtol=RTOL, atol=0)
        iv = torch.int32 if g.dtype == torch.float32 else torch.int64
        bits = bits and torch.equal(gg.view(iv), ww.view(iv))
        if gg.numel():
            fin = torch.isfinite(ww)
            if bool(fin.any()):
                err = max(err, float((gg[fin] - ww[fin]).abs().max()))
    return err, bits


def _k1_bytes(stage, env, params, sel, outs, s_out) -> int:
    """Distinct input tensors the stage reads, once, and its outputs."""
    import torch

    from ydb_tpu_torch.ops import k1
    from ydb_tpu_torch.ops.torch_exec import PerMember
    names, ps = k1.stage_inputs(stage)
    ins = [t for n in names if n in env for t in env[n]]
    for p in ps:
        v = params[p.name]
        v = v.t if isinstance(v, PerMember) else v
        if isinstance(v, torch.Tensor):
            ins.append(v)
    if s_out is not None:
        ins.append(sel)
    written = sum(t.numel() * t.element_size() for pair in outs
                  for t in pair if t is not None)
    if s_out is not None and s_out is not sel:
        written += s_out.numel()
    return distinct_bytes(ins) + written


def check_k1_stage(B, stage, env, params, sel, cap, tag, device) -> dict:
    """One stage through its kernel and its plain version on the card:
    checked, timed, its launches counted and its byte bound."""
    import torch
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    before = B.LAUNCHES["k1"]
    got, gs = _k1_run(stage, env, params, sel, cap, device, plain=False)
    launches = B.LAUNCHES["k1"] - before
    want, ws = _k1_run(stage, env, params, sel, cap, device, plain=True)
    sync()
    flat_g = [t for pair in got for t in pair] + [gs]
    flat_w = [t for pair in want for t in pair] + [ws]
    err, bits = _k1_compare(flat_g, flat_w, f"k1 {tag}")
    from ydb_tpu_torch.ops import k1
    ms = time_ms(lambda: k1.run_stage(stage, dict(env), params, sel, cap,
                                      device), iters=9, warmup=2)
    plain_ms = time_ms(lambda: k1.run_stage_plain(
        stage, dict(env), params, sel, cap, device), iters=9, warmup=2)
    nbytes = _k1_bytes(stage, env, params, sel, got, gs)
    return {"ms": ms, "plain_ms": plain_ms, "launches": launches,
            "bound_ms": bound_ms(nbytes), "max_abs_err": err,
            "bit_equal": bits}


def _k1_line(tag, stage, cap, r) -> None:
    from ydb_tpu_torch.ops import ir
    na = sum(isinstance(c, ir.Assign) for c in stage)
    log(f"kernel k1 {tag}: rows={cap} assigns={na} "
        f"filters={len(stage) - na} kernel_ms={r['ms']:.4f} "
        f"plain_ms={r['plain_ms']:.4f} launches={r['launches']} "
        f"bound_us={r['bound_ms'] * 1e3:.2f} bit_equal={r['bit_equal']} "
        f"max_abs_err={r['max_abs_err']:.3g}")


def k1_phase(B, eng, queries: dict, device: str = "cuda") -> list:
    """K1 against its plain version on the card: the stages q1, q6 and
    q19 hand over on the fused path (late materialization on), q19's
    batched stages at B = 8 with per-member params, and the op sweep of
    `bench/k1_sweep.py` (every op over each storage dtype it takes, with
    NULLs, NaN, +-inf, -0.0, zero divisors, negative floor operands,
    codes of -1, a `null_neg` LUT, hash inputs >= 2^63) at 2^20 rows and
    at 0 rows. Returns the kernel-table row: q19's stages, their time
    and their byte bound summed (`k1_bound_bytes`, the query-level
    formula, is logged beside it)."""
    import numpy as np
    import torch

    from ydb_tpu_torch.bench import k1_sweep, serving
    from ydb_tpu_torch.ops import ir, k1
    os.environ["YDB_TPU_LATE_MAT"] = "1"
    err, totals = 0.0, {}
    for q in K1_QUERIES:
        eng.query(queries[q])                       # warm: plans, builds
        before = B.LAUNCHES["k1"]
        with StageCapture() as cap_:
            eng.query(queries[q])
        warm = B.LAUNCHES["k1"] - before
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "launches": warm, "stages": len(cap_.stages)}
        for i, (stage, env, params, sel, n) in enumerate(cap_.stages):
            r = check_k1_stage(B, stage, env, params, sel, n,
                               f"{q} stage {i}", device)
            _k1_line(f"{q} stage {i}", stage, n, r)
            for k in ("ms", "plain_ms", "bound_ms"):
                tot[k] += r[k]
            err = max(err, r["max_abs_err"])
        totals[q] = tot
        log(f"kernel k1 {q}: stages={tot['stages']} "
            f"launches_per_warm_query={warm} kernel_ms={tot['ms']:.4f} "
            f"plain_ms={tot['plain_ms']:.4f} stage_bound_ms="
            f"{tot['bound_ms']:.4f} (bytes: each stage's inputs once and "
            f"outputs once, at its rows) k1_bound_ms="
            f"{bound_ms(k1_bound_bytes(eng, queries[q])):.4f} (bytes: "
            "k1_bound_bytes)")
    # q19's batched stages: 8 qgen variants, per-member params
    texts = serving.variants("q19", 8, SERVING_SEED)
    _batched_call(eng, texts)
    with StageCapture() as cap_:
        check(_batched_call(eng, texts) is not None, "q19 batch declined")
    for i, (stage, env, params, sel, n) in enumerate(cap_.stages):
        r = check_k1_stage(B, stage, env, params, sel, n,
                           f"q19 batched B=8 stage {i}", device)
        _k1_line(f"q19 batched B=8 stage {i}", stage, n, r)
        err = max(err, r["max_abs_err"])
    # the op sweep
    cols = k1_sweep.columns(K1_SWEEP_ROWS, K1_SWEEP_SEED)
    prm = k1_sweep.params(K1_SWEEP_SEED)

    def tensors(c, n, dev):
        return {k: (torch.from_numpy(np.ascontiguousarray(d[:n])).to(dev),
                    None if v is None else torch.from_numpy(
                        np.ascontiguousarray(v[:n])).to(dev))
                for k, (d, v) in c.items()}

    def params_on(dev):
        return {k: (torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray)
                    else v) for k, v in prm.items()}

    one, p_cpu = tensors(cols, 1, "cpu"), params_on("cpu")
    cases = k1_sweep.cases(K1_SWEEP_ROWS, K1_SWEEP_SEED,
                           supported=lambda e, _c, _p: k1.supports(
                               (ir.Assign("r", e),), one, p_cpu))
    env_d, p_d = tensors(cols, K1_SWEEP_ROWS, device), params_on(device)
    n_bits = 0
    for case in cases:
        r = check_k1_stage(B, case.stage, env_d, p_d, None, K1_SWEEP_ROWS,
                           f"sweep {case.name}", device)
        _k1_line(f"sweep {case.name}", case.stage, K1_SWEEP_ROWS, r)
        n_bits += r["bit_equal"]
        err = max(err, r["max_abs_err"])
    mask = (torch.arange(K1_SWEEP_ROWS, device=device) % 3) > 0
    for nf in (1, 2):
        for sel in (None, mask):
            st = k1_sweep.filter_stage(nf)
            r = check_k1_stage(B, st, env_d, p_d, sel, K1_SWEEP_ROWS,
                               f"sweep filters={nf}", device)
            _k1_line(f"sweep filters={nf} mask={sel is not None}", st,
                     K1_SWEEP_ROWS, r)
    zero = tensors(cols, 0, device)
    for case in cases:
        got, gs = _k1_run(case.stage, zero, p_d, None, 0, device, False)
        want, ws = _k1_run(case.stage, zero, p_d, None, 0, device, True)
        _k1_compare([t for p in got for t in p], [t for p in want for t in p],
                    f"k1 sweep {case.name} at 0 rows")
    log(f"kernel k1 sweep: {len(cases)} stages over {K1_SWEEP_ROWS} rows "
        f"and 0 rows, {sum(len(c.stage) for c in cases)} assigns, "
        f"{n_bits} bit-equal, every op of KERNELS ok")
    q19 = totals["q19"]
    return [{"name": "k1", "route": "cuda", "source": "ydb_tpu_torch/ops/k1.py",
             "replaces": "ydb_tpu/ops/xla_exec.py:75",
             "shape": f"q19 at SF1: {q19['stages']} stages, "
                      f"{q19['launches']} launches a warm query",
             "ms": q19["ms"], "plain_ms": q19["plain_ms"],
             "library_ms": None, "bound_ms": q19["bound_ms"],
             "bound_by": "bytes", "max_abs_err": err}]


def k1_bound_bytes(eng, sql: str) -> int:
    """The least bytes K1's elementwise work must move in a query: each
    scan column that a scan-level Assign or Filter reads, read once, and
    each Assign's output and each Filter's mask written once, over the
    scan's live rows (join payloads and later stages not counted)."""
    import numpy as np

    from ydb_tpu_torch.ops import ir
    from ydb_tpu_torch.sql import parse
    plan = eng.planner.plan_select(parse(sql))
    pipe = plan.pipeline
    table = eng.catalog.table(pipe.scan.table)
    width = {i: np.dtype(table.schema.dtype(s).np).itemsize
             for (s, i) in pipe.scan.columns}
    progs = [pipe.pre_program] + [s for k, s in pipe.steps if k != "join"]
    if pipe.partial is not None:
        progs.append(ir.Program([c for c in pipe.partial.commands
                                 if not isinstance(c, ir.GroupBy)]))
    read, written = set(), 0
    for prog in progs:
        for cmd in (prog.commands if prog is not None else ()):
            refs: set = set()
            if isinstance(cmd, ir.Assign):
                ir.expr_columns(cmd.expr, refs)
                written += 8
            elif isinstance(cmd, ir.Filter):
                ir.expr_columns(cmd.pred, refs)
                written += 1
            read |= {r for r in refs if r in width}
    return table.num_rows * (sum(width[r] for r in read) + written)


def profile_phase(eng, queries: dict, names=None) -> None:
    """One warm run per query (TPC-H's 22 unless `names`) under
    torch.profiler: host wall time, the summed device time of its
    kernels, the device's idle share of the wall, the kernels that took
    most of it, the time and count of K1's generated kernels
    (`k1_stage`), of K9's (`rs_*`), of K7's (`probe_rows`,
    `probe_table`) and of torch's elementwise kernels
    that remain (index gathers and the like), with, for q6 and q19, K1's
    byte bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    os.environ["YDB_TPU_LATE_MAT"] = "1"
    for name in names or [f"q{i}" for i in range(1, 23)]:
        eng.query(queries[name])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.query(queries[name])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        def dev_us(e) -> float:
            return float(getattr(e, "self_device_time_total", None)
                         or getattr(e, "self_cuda_time_total", 0) or 0)
        # device-side events only: an operator's own row repeats the
        # time of the kernels it launched
        evs = [e for e in prof.key_averages() if dev_us(e) > 0
               and e.device_type == DeviceType.CUDA]
        dev_ms = sum(dev_us(e) for e in evs) / 1e3
        top = sorted(evs, key=lambda e: -dev_us(e))[:8]
        elem = [e for e in evs if "elementwise" in e.key]
        # K9's kernels (sort.cu: rs_census, rs_pass, rs_block); K7's
        # (probe.cu: probe_rows, probe_table)
        sorts = [e for e in evs if e.key.startswith("rs_")]
        probes = [e for e in evs if "probe_rows" in e.key
                  or "probe_table" in e.key]
        check(not any("merge_pass" in e.key for e in evs),
              f"profile {name}: a merge_pass kernel ran")
        k1e = [e for e in evs if e.key.startswith(K1_ENTRY)]
        k1 = ""
        if name in ("q6", "q19"):
            k1 = (f" k1_bound_ms={bound_ms(k1_bound_bytes(eng, queries[name])):.4f}"
                  " (bytes)")
        log(f"profile {name}: wall_ms={wall:.3f} device_ms={dev_ms:.3f} "
            f"idle_share={max(0.0, 1 - dev_ms / wall):.3f} kernels="
            f"{sum(e.count for e in evs)} k1_ms="
            f"{sum(dev_us(e) for e in k1e) / 1e3:.3f} "
            f"(x{sum(e.count for e in k1e)}){k1} torch_elementwise_ms="
            f"{sum(dev_us(e) for e in elem) / 1e3:.3f} "
            f"(x{sum(e.count for e in elem)}) sort_ms="
            f"{sum(dev_us(e) for e in sorts) / 1e3:.3f} "
            f"(x{sum(e.count for e in sorts)}) probe_ms="
            f"{sum(dev_us(e) for e in probes) / 1e3:.3f} "
            f"(x{sum(e.count for e in probes)}) top: "
            + "; ".join(f"{e.key[:48]}={dev_us(e) / 1e3:.3f}ms x{e.count}"
                        for e in top))


def profile_beyond_phase(eng, queries: dict) -> None:
    """One warm run of each beyond-budget query that takes a tiled lane,
    under torch.profiler: the wall, the device time of its kernels, of
    its host→device copies (the tiles' uploads) and of its device→host
    copies, and the device's idle share of the wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    os.environ["YDB_TPU_LATE_MAT"] = "1"
    names = [f"q{i}" for i in range(1, 23)] + list(BEYOND_EXTRA)
    for name in names:
        eng.query(queries[name])
        torch.cuda.synchronize()
        if not eng.executor.last_path.startswith("fused-tiled"):
            continue
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.query(queries[name])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3

        def dev_us(e) -> float:
            return float(getattr(e, "self_device_time_total", None)
                         or getattr(e, "self_cuda_time_total", 0) or 0)
        evs = [e for e in prof.key_averages() if dev_us(e) > 0
               and e.device_type == DeviceType.CUDA]
        h2d = sum(dev_us(e) for e in evs if "HtoD" in e.key) / 1e3
        d2h = sum(dev_us(e) for e in evs if "DtoH" in e.key) / 1e3
        dev_ms = sum(dev_us(e) for e in evs) / 1e3
        log(f"profile beyond {name}: path={eng.executor.last_path} "
            f"wall_ms={wall:.3f} device_ms={dev_ms:.3f} "
            f"htod_ms={h2d:.3f} dtoh_ms={d2h:.3f} "
            f"compute_ms={dev_ms - h2d - d2h:.3f} "
            f"idle_share={max(0.0, 1 - dev_ms / wall):.3f}")


if __name__ == "__main__":
    sys.exit(main())
