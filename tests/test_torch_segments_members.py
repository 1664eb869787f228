"""K15a's `segments` and K5 xB's member compaction as their CUDA kernels
compute them: the launch plans, and plain-torch emulations of the
kernels' arithmetic held against the plain versions.

`segments_plan` gives a call's launches (one scatter a chunk of 32
planes, one without columns), its 4,096-row tiles, the zero tail's
items of 4,096 slots, the scatter's shared memory (within the H100's
227 KB), the control words kept per stream and the blocks of the
targets-alone kernel; `segment_agg_batched_plan` the
three kernels a chunk of 8 aggregates (the hidden `first` the first
chunk's first), the fold's tiles, the compaction's items and the
control words.

The K15a emulation follows segments.cu: each row's target (a power of
two of targets by a mask of the hash, any other count by the uint64
remainder), each tile's stable ranks (a warp's 512 rows, the warps' and
the earlier targets' counts), the look-back's sum over earlier tiles,
the last tile's sums as the clamped counts and the overflow flag, each
plane staged at its slot
plus its target's shift and written out by 16-byte lines (the staged
line aligned as the output line, inside the buffer, the targets'
regions apart), the run clamped at seg, and the zero tail by items of
4,096 slots; the outputs start poisoned, as `torch.empty` leaves them.
The K5 xB emulation follows seg_members over the per-(member, run)
partials the fold writes: 4,096 runs a tile, ballot ranks in a warp's
512, the warps' bases, the member's earlier tiles, lead as int32, and
the zero items from each member's ngroups. Both must equal
`segments_plain` / `segment_agg_batched_plain` bit for bit. On fake CUDA
tensors (`FakeTensorMode`, no card) the wrappers launch what the plans
say and never take the plain versions; the sources' `#define`s are the
bindings' constants.
"""

import re

import numpy as np
import pytest
import torch

from ydb_tpu_torch.ops import spill as SP
from ydb_tpu_torch.ops.cuda import bindings as K
from ydb_tpu_torch.ops.cuda import build
from tests import torch_threads  # noqa: F401,E402

TILE = 4096                      # segments.cu STILE
WARP = 512                       # rows (runs) a warp of a tile
ZROWS = 4096                     # segments.cu ZROWS
SBUF = 34848                     # segments.cu SBUF_BYTES
MTILE = 4096                     # segment_agg.cu MTILE
MZROWS = 16384                   # segment_agg.cu MZROWS
SMEM_LIMIT = 232_448             # bytes of shared memory a block can use
POISON = 0xA5


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: real CUDA tensors launch the kernel")


def _fake_launch(monkeypatch):
    """Record the launches' names and arguments instead of running them;
    a pointer is the tensor's id (0 for none)."""
    launched = []
    monkeypatch.setattr(K, "_launch", lambda name, *a:
                        launched.append((name, a)))
    monkeypatch.setattr(K, "_ptr", lambda t: 0 if t is None else id(t))
    monkeypatch.setattr(K, "_stream", lambda: 0)
    monkeypatch.setattr(K, "_SG_CTL", {})
    monkeypatch.setattr(K, "_SA_CTL", {})
    for name in ("segments_plain", "segment_targets_plain",
                 "segment_agg_batched_plain"):
        monkeypatch.setattr(K, name, lambda *a, _n=name, **k: pytest.fail(
            f"a CUDA tensor took {_n}"))
    return launched


def _same_bits(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def _poisoned(numel: int, dtype) -> torch.Tensor:
    """What torch.empty may hold: every byte POISON."""
    size = torch.empty((), dtype=dtype).element_size()
    return torch.full((numel * size,), POISON, dtype=torch.uint8).view(dtype)


# ------------------------------------------------------------------ plans


@pytest.mark.parametrize("n_cols,launches", [(0, 1), (1, 1), (7, 1),
                                             (16, 1), (17, 2), (32, 2),
                                             (33, 3), (40, 3)])
@pytest.mark.parametrize("ndev", [1, 3, 4, 256])
def test_segments_plan_launches(n_cols, launches, ndev):
    n = 3 * TILE + 5
    plan = K.segments_plan(n, ndev, n, n_cols)
    assert plan["launches"] == plan["chunks"] == launches
    assert plan["tiles"] == 4
    assert plan["ctl_words"] == 1 + 4 * ndev
    assert plan["zero_items"] == 4 * ndev
    assert plan["smem"] == SBUF + 3 * TILE + 4 * 8 * ndev
    assert plan["smem"] <= SMEM_LIMIT
    assert plan["scatter_blocks"] == min(4 + 4 * ndev, 264)
    assert plan["target_blocks"] == 7


@pytest.mark.parametrize("n,ndev,seg,tiles,zero,blocks", [
    (0, 4, 0, 0, 4, 4), (0, 4, 16, 0, 4, 4), (1, 1, 1, 1, 1, 2),
    (TILE, 8, TILE, 1, 8, 9), (TILE + 1, 3, 100, 2, 3, 5),
    (2_097_152, 4, 2_097_152, 512, 2048, 264),
    (6_291_456, 4, 6_291_456, 1536, 6144, 264)])
def test_segments_plan_items(n, ndev, seg, tiles, zero, blocks):
    plan = K.segments_plan(n, ndev, seg, 2)
    assert (plan["tiles"], plan["zero_items"], plan["scatter_blocks"]) == \
        (tiles, zero, blocks)
    assert plan["launches"] == 1


@pytest.mark.parametrize("n_aggs,calls", [(0, 1), (6, 1), (7, 1), (8, 2),
                                          (15, 2), (16, 3)])
def test_segment_agg_batched_plan(n_aggs, calls):
    n, B, oc = 1_000_000, 8, 1_000_000
    plan = K.segment_agg_batched_plan(n, B, oc, n_aggs)
    assert plan["calls"] == plan["chunks"] == calls
    assert plan["launches"] == 3 * calls
    assert plan["fold_tiles"] == 489 and plan["fold_words"] == 490
    assert plan["fold_blocks"] == 489 * 8
    assert plan["member_tiles"] == 8 * 245
    assert plan["member_words"] == 1 + 8 * 245
    assert plan["zero_items"] == 8 * 62
    assert plan["member_blocks"] == 528


@pytest.mark.parametrize("B,blocks", [(1, 3), (2, 6), (8, 24), (64, 24)])
def test_segment_agg_batched_plan_fold_blocks(B, blocks):
    """Up to 8 fold blocks a tile share its members."""
    plan = K.segment_agg_batched_plan(3 * 2048, B, 100, 2)
    assert plan["fold_tiles"] == 3 and plan["fold_blocks"] == blocks


def test_segment_agg_batched_plan_zero_rows():
    plan = K.segment_agg_batched_plan(0, 8, 100, 3)
    assert plan["launches"] == 0 and plan["fold_words"] == 0


def test_source_constants_match_the_bindings():
    def define(name, src):
        return int(re.search(r"#define " + name + r" (\d+)", src).group(1))
    seg = (build.CSRC / "segments.cu").read_text()
    assert define("ST", seg) * define("SI", seg) == K._SG_TILE == TILE
    assert define("ST", seg) // 32 == K._SG_WARPS
    assert define("SI", seg) * 32 == WARP
    assert define("MAX_COLS", seg) == K._SG_COLS
    assert define("MAX_TARGETS", seg) == K._SEG_MAX_TARGETS
    assert define("MAX_KEYS", seg) == K._SEG_MAX_KEYS
    assert define("ZROWS", seg) == K._SG_ZROWS == ZROWS
    assert define("CT", seg) * define("CR", seg) == K._SG_TARGET_ROWS
    assert define("TBLOCKS", seg) == K._SG_TARGET_BLOCKS
    assert define("SBLOCKS", seg) == K._SG_SCATTER_BLOCKS
    assert define("CTL_HEAD", seg) == K._SG_CTL_HEAD
    assert define("LB_EPOCH", seg) == 64 - 30 == \
        64 - K._SG_EPOCHS.bit_length()
    # SBUF_BYTES: the larger of the 1-byte and 8-byte staging layouts,
    # rounded up to 16 bytes
    t = K._SEG_MAX_TARGETS + 1
    want = max(TILE + t * 15 + 16, (TILE + t + 2) * 8)
    assert -(-want // 16) * 16 == K._SG_SBUF == SBUF
    agg = (build.CSRC / "segment_agg.cu").read_text()
    assert define("MT", agg) * define("MPT", agg) == K._SM_TILE == MTILE
    assert define("MZROWS", agg) == K._SM_ZROWS == MZROWS
    assert define("MBLOCKS", agg) == K._SM_BLOCKS
    assert define("MGROUPS", agg) == K._SM_GROUPS
    assert define("MAX_AGGS", agg) == K._SEG_MAX_AGGS
    assert define("THREADS", agg) * define("STRIPS", agg) == K._SEG_TILE \
        == FOLD_TILE
    for src in (seg, agg):
        assert "#ifndef" not in src
    # bin_scan.cuh serves bucket_sort.cu alone
    users = [p.name for p in build.CSRC.glob("*.cu")
             if '#include "bin_scan.cuh"' in p.read_text()]
    assert users == ["bucket_sort.cu"]


# ------------------------------------------------------------------ K15a


def _targets(keys, given, n: int, ndev: int) -> torch.Tensor:
    """segments.cu's row_targets: -1 for a given target outside [0, ndev);
    a power of two of targets by the hash's low bits, any other count by
    its uint64 remainder."""
    if given is not None:
        t = given.to(torch.int64)
        return torch.where((t >= 0) & (t < ndev), t, torch.full_like(t, -1))
    h = None
    for d, v in keys:
        x = K.splitmix64_plain(SP.as_int64(d))
        if v is not None:
            x = torch.where(v, x, torch.zeros_like(x))
        h = x if h is None else K.hash_combine_plain(h, x)
    if ndev & (ndev - 1) == 0:
        return h & (ndev - 1)
    return K.umod64_plain(h, ndev)


def _emulate_segments(length: int, ndev: int, seg: int, cols, keys=None,
                      targets=None):
    """segments.cu's arithmetic in plain torch: (outs, counts, overflow)."""
    ref = targets if targets is not None else keys[0][0]
    n = ref.shape[0]
    ln = max(0, min(length, n))
    t = _targets(keys, targets, n, ndev)
    planes, outs = [], []
    for d, v in cols:
        od = _poisoned(ndev * seg, d.dtype)
        ov = _poisoned(ndev * seg, torch.bool)
        planes += [(d, od), (v, ov)]
        outs.append((od, ov))
    bins = torch.arange(ndev)
    before = torch.zeros(ndev, dtype=torch.int64)     # the look-back's sum
    for tile in range(-(-ln // TILE)):
        row0 = tile * TILE
        rows = min(ln - row0, TILE)
        td = t[row0:row0 + rows]
        inn = td >= 0
        tdc = td.clamp(min=0)
        oh = torch.nn.functional.one_hot(tdc, ndev) * inn[:, None]
        rank = torch.empty(rows, dtype=torch.int64)
        wcnt = []
        for w0 in range(0, rows, WARP):
            ohw = oh[w0:w0 + WARP]
            rank[w0:w0 + WARP] = (torch.cumsum(ohw, 0) - ohw).gather(
                1, tdc[w0:w0 + WARP, None])[:, 0]
            wcnt.append(ohw.sum(0))
        wcnt = torch.stack(wcnt)
        tc = wcnt.sum(0)
        wexcl = torch.cumsum(wcnt, 0) - wcnt
        ls = torch.cumsum(tc, 0) - tc
        warp = torch.arange(rows) // WARP
        slot = (ls[tdc] + wexcl[warp, tdc] + rank)[inn]
        m = torch.clamp(seg - before, min=0).minimum(tc)      # the run clamp
        g0 = bins * seg + torch.clamp(before, max=seg)
        for src, dst in planes:
            size = dst.element_size()
            V = 16 // size
            R = ls + bins * (V - 1)
            shift = bins * (V - 1) + (g0 - R) % V
            sb = ls + shift                                   # run starts
            assert torch.all(sb % V == g0 % V)
            assert torch.all(sb + m <= R + tc + V - 1)        # regions apart
            buf = _poisoned(SBUF // size, dst.dtype)
            pos = slot + shift[tdc[inn]]
            assert pos.numel() == 0 or int(pos.max()) < buf.numel()
            if src is not None:
                buf[pos] = src[row0:row0 + rows][inn]
            for b in range(ndev):
                mb = int(m[b])
                if mb == 0:
                    continue
                gb, s0 = int(g0[b]), int(sb[b])
                # the 16-byte lines: the staged line starts where the
                # output line starts, inside the buffer
                first, last = gb // V * V, (gb + mb - 1) // V * V
                assert (s0 - (gb - first)) % V == 0
                assert s0 - (gb - first) >= 0
                assert s0 + (last + V - gb) <= buf.numel()
                dst[gb:gb + mb] = 1 if src is None else buf[s0:s0 + mb]
        before += tc
    # the last tile's inclusive sums: the counts, clamped, and the flag
    counts = torch.clamp(before, max=seg).to(torch.int32)
    overflow = bool((before > seg).any())
    for b in range(ndev):                             # the zero tail
        for j in range(max(1, -(-seg // ZROWS))):
            lo = max(j * ZROWS, int(counts[b]))
            hi = min((j + 1) * ZROWS, seg)
            for _s, dst in planes:
                if lo < hi:
                    dst[b * seg + lo:b * seg + hi] = 0
    return ([(d.view(ndev, seg), v.view(ndev, seg)) for d, v in outs],
            counts, overflow)


def _cols(rng, n: int, k: int):
    """k columns of widths 8, 4, 2, 1 and bool in turn (float64 with NaN,
    ±inf and -0.0 among them), every third with a valid."""
    out = []
    for i in range(k):
        w = i % 5
        if w == 0:
            d = torch.from_numpy(rng.choice([np.nan, np.inf, -np.inf, -0.0,
                                             0.0, 1.5, -2.5], n))
        elif w == 1:
            d = torch.from_numpy(rng.integers(-2**31, 2**31, n,
                                              dtype=np.int32))
        elif w == 2:
            d = torch.from_numpy(rng.integers(-2**15, 2**15, n,
                                              dtype=np.int16))
        elif w == 3:
            d = torch.from_numpy(rng.integers(0, 255, n, dtype=np.uint8))
        else:
            d = torch.from_numpy(rng.random(n) < 0.5)
        v = torch.from_numpy(rng.random(n) < 0.8) if i % 3 == 0 else None
        out.append((d, v))
    return out


def _keys(rng, n: int, variant: int):
    ki = torch.from_numpy(rng.integers(-2**62, 2**62, n))
    kv = torch.from_numpy(rng.random(n) < 0.9)
    kc = torch.from_numpy(rng.integers(-1, 5000, n, dtype=np.int32))
    kf = torch.from_numpy(rng.choice([np.nan, np.inf, -np.inf, -0.0, 1.5,
                                      -2.5, 1e300, 9.3e18], n))
    return [[(ki, None)], [(ki, kv)], [(kf, None), (kc, kv)]][variant % 3]


N_SEG = 2 * TILE + 333
LENGTHS = [0, 1, TILE - 1, TILE, TILE + 1, N_SEG]


def _same_segments(got, want) -> None:
    assert torch.equal(got[1], want[1])
    assert bool(got[2]) == bool(want[2])
    for (gd, gv), (wd, wv) in zip(got[0], want[0]):
        assert _same_bits(gd, wd) and _same_bits(gv, wv)


@pytest.mark.parametrize("seg_kind", ["clamped", "full"])
@pytest.mark.parametrize("ndev", [1, 3, 4, 8, 256])
@pytest.mark.parametrize("length", LENGTHS)
def test_segments_emulation_is_the_plain_version(length, ndev, seg_kind):
    rng = np.random.default_rng(length * 31 + ndev * 7 + len(seg_kind))
    n = N_SEG
    # every target's share, clamped a third of the way
    seg = n if seg_kind == "full" else max(1, length // (3 * ndev))
    cols = _cols(rng, n, 33 if ndev <= 8 else 3)
    keys = _keys(rng, n, length + ndev)
    got = _emulate_segments(length, ndev, seg, cols, keys=keys)
    want = K.segments_plain(length, ndev, seg, cols, keys=keys)
    _same_segments(got, want)
    if seg_kind == "clamped" and length >= TILE:
        assert got[2]                      # a target overflowed


@pytest.mark.parametrize("ndev", [3, 4])
def test_segments_emulation_given_targets(ndev):
    """Given targets, some outside [0, ndev): those rows go nowhere."""
    rng = np.random.default_rng(ndev)
    n = N_SEG
    tg = torch.from_numpy(rng.integers(-1, ndev + 2, n, dtype=np.int32))
    cols = _cols(rng, n, 6)
    got = _emulate_segments(n - 17, ndev, n, cols, targets=tg)
    want = K.segments_plain(n - 17, ndev, n, cols, targets=tg)
    _same_segments(got, want)


@pytest.mark.parametrize("ndev", [1, 3, 4, 8, 256])
def test_target_emulation_is_segment_targets(ndev):
    rng = np.random.default_rng(ndev + 100)
    for variant in range(3):
        keys = _keys(rng, 5000, variant)
        assert torch.equal(_targets(keys, None, 5000, ndev).to(torch.int32),
                           K.segment_targets_plain(keys, ndev))


# ------------------------------------------------------------------ K5 xB


def _union_runs(perm, keys, union):
    """The union's runs along perm: the run id of every original row
    (-1 outside the union) and their count."""
    n = perm.shape[0]
    p = perm.to(torch.int64)
    u = union[p]
    changed = torch.ones(n, dtype=torch.bool)
    if n:
        changed[1:] = ~u[:-1]
        for k in keys:
            ks = k[p]
            changed[1:] |= ks[1:] != ks[:-1]
    run_sorted = torch.cumsum((u & changed).to(torch.int64), 0) - 1
    run = torch.full((n,), -1, dtype=torch.int64)
    run[p] = torch.where(u, run_sorted, torch.full_like(run_sorted, -1))
    return run, int((u & changed).sum())


def _emulate_members(perm, keys, masks, aggs, oc: int):
    """seg_members over the partials the fold writes at the union's runs:
    (ngroups, lead, present, vals, cnts)."""
    B, n = masks.shape
    union = masks.any(0)
    run, ngu = _union_runs(perm, keys, union)
    nb = max(ngu, 1)
    kid = torch.where(run >= 0, run, torch.zeros_like(run)).to(torch.int32)
    specs = [("first", None, None, False)] + list(aggs)
    pv, pc, pp = K.bucket_agg_batched_plain(kid, nb, masks & union[None, :],
                                            specs)
    ngc = min(ngu, oc)
    TM = -(-ngc // MTILE)
    ngroups = torch.zeros(B, dtype=torch.int32)
    lead = _poisoned(B * oc, torch.int32).view(B, oc)
    present = _poisoned(B * oc, torch.int64).view(B, oc)
    vals = [_poisoned(B * oc, torch.int64).view(B, oc) for _ in aggs]
    cnts = [_poisoned(B * oc, torch.int64).view(B, oc) for _ in aggs]
    for b in range(B):
        before = 0
        for t in range(TM):
            g = torch.arange(t * MTILE, min((t + 1) * MTILE, ngc))
            keep = pp[b, g] != 0
            # a warp's 512 runs ranked by ballots, then the warps' bases
            w = (g - t * MTILE) // WARP
            wcnt = torch.bincount(w[keep], minlength=MTILE // WARP)
            wbase = torch.cumsum(wcnt, 0) - wcnt
            wrank = torch.zeros_like(g)
            for wi in range(MTILE // WARP):
                sel = w == wi
                wrank[sel] = torch.cumsum(keep[sel].to(torch.int64), 0) \
                    - keep[sel].to(torch.int64)
            dst = before + wbase[w] + wrank
            gk, dk = g[keep], dst[keep]
            lead[b, dk] = pv[0][b, gk].to(torch.int32)
            present[b, dk] = pp[b, gk]
            for a in range(len(aggs)):
                vals[a][b, dk] = pv[a + 1][b, gk].view(torch.int64)
                cnts[a][b, dk] = pc[a + 1][b, gk]
            before += int(wcnt.sum())
        ngroups[b] = before
        for j in range(-(-oc // MZROWS)):              # the zero items
            lo, hi = j * MZROWS, min((j + 1) * MZROWS, oc)
            ng = before if lo < ngc and TM > 0 else 0
            frm = max(lo, ng)
            if frm < hi:
                for o in [lead, present] + vals + cnts:
                    o[b, frm:hi] = 0
    for a, (f, d, _v, _u) in enumerate(aggs):
        if d is not None and d.dtype == torch.float64 \
                and f in ("sum", "min", "max"):
            vals[a] = vals[a].view(torch.float64)
    return ngroups, lead, present, vals, cnts


FOLD_TILE = 2048                 # segment_agg.cu TILE: sorted rows a tile


def _fold_tile_roles(active_sorted: torch.Tensor):
    """seg_fold's member form: which tiles stop at once, which run the
    look-back, and which one writes the union's group count. A tile whose
    first row is inactive holds no active row (the active rows come
    first); the first such tile (the tile before it starts active) still
    runs the look-back, and counts the groups unless the last tile is
    live and does."""
    n = active_sorted.shape[0]
    T = -(-n // FOLD_TILE)
    first = active_sorted[::FOLD_TILE][:T]            # each tile's first row
    dead = ~first
    first_dead = dead & torch.cat([torch.ones(1, dtype=torch.bool),
                                   first[:-1]])
    look_back = ~dead | first_dead
    writer = torch.zeros(T, dtype=torch.bool)
    writer[T - 1] = bool(look_back[T - 1])
    writer |= first_dead
    return look_back, writer


@pytest.mark.parametrize("live", [0, 1, FOLD_TILE - 1, FOLD_TILE,
                                  FOLD_TILE + 1, 3559, 2 * FOLD_TILE,
                                  5 * FOLD_TILE - 7, 5 * FOLD_TILE])
def test_fold_counts_the_groups_once(live):
    """Exactly one tile writes the union's group count, and its look-back
    covers every tile with an active row."""
    n = 5 * FOLD_TILE
    active_sorted = torch.arange(n) < live
    look_back, writer = _fold_tile_roles(active_sorted)
    assert int(writer.sum()) == 1
    w = int(writer.nonzero()[0])
    live_tiles = -(-live // FOLD_TILE)
    assert bool(look_back[:live_tiles].all())
    assert w == (live_tiles if live_tiles < 5 else 4)
    assert int(look_back.sum()) == min(live_tiles + 1, 5)


def _members_case(rng, B: int, n: int, distinct: int):
    words = [torch.from_numpy(rng.integers(0, distinct, n)),
             torch.from_numpy(rng.integers(0, 3, n))]
    masks = torch.from_numpy(rng.random((B, n)) < 0.6)
    if B > 1:
        masks[1] = False                   # a member with no rows
    union = masks.any(0)
    order = np.lexsort([np.arange(n)] + [w.numpy() for w in words[::-1]]
                       + [(~union).numpy()])
    perm = torch.from_numpy(order.astype(np.int32))
    hv = torch.from_numpy(rng.random(n) < 0.9)
    aggs = [("sum", torch.from_numpy(rng.random(n) * 1e3), hv, False),
            ("count", None, hv, False),
            ("min", torch.from_numpy(rng.random(n)), None, False),
            ("max", torch.from_numpy(rng.integers(-2**62, 2**62, n)), hv,
             True),
            ("first", None, hv, False),
            ("sum", torch.from_numpy(rng.random((B, n))), None, False)]
    return perm, words, masks, aggs


@pytest.mark.parametrize("B", [1, 3, 8, 64])
@pytest.mark.parametrize("n,distinct", [(3 * MTILE + 77, 1 << 20),
                                        (5000, 700)])
def test_members_emulation_is_the_plain_version(B, n, distinct):
    rng = np.random.default_rng(B * 13 + n)
    perm, words, masks, aggs = _members_case(rng, B, n, distinct)
    oc = n
    got = _emulate_members(perm, words, masks, aggs, oc)
    want = K.segment_agg_batched_plain(perm, words, masks, aggs, oc)
    assert torch.equal(got[0], want[0])
    assert _same_bits(got[1], want[1]) and _same_bits(got[2], want[2])
    for g, w in zip(got[3] + got[4], want[3] + want[4]):
        assert _same_bits(g, w)
    if n > MTILE and B > 1:
        assert int(masks.any(0).sum()) > MTILE     # runs cross tiles
        assert int(got[0][1]) == 0


def test_members_plain_takes_the_union():
    rng = np.random.default_rng(3)
    perm, words, masks, aggs = _members_case(rng, 3, 2000, 300)
    a = K.segment_agg_batched_plain(perm, words, masks, aggs, 2000)
    b = K.segment_agg_batched_plain(perm, words, masks, aggs, 2000,
                                    union=masks.any(0))
    c = K.segment_agg_batched(perm, words, masks, aggs, 2000,
                              union=masks.any(0))
    for x, y, z in zip(a[:3], b[:3], c[:3]):
        assert _same_bits(x, y) and _same_bits(x, z)


# -------------------------------------------------- the wrappers on CUDA


@pytest.mark.parametrize("n_cols", [0, 3, 16, 17, 40])
@pytest.mark.parametrize("key_kind", ["int64", "valid", "targets"])
def test_segments_launches_on_cuda_tensors(monkeypatch, n_cols, key_kind):
    from torch._subclasses.fake_tensor import FakeTensorMode
    _no_gpu()
    launched = _fake_launch(monkeypatch)
    n, ndev = 2 * TILE + 9, 4
    with FakeTensorMode():
        cuda = dict(device="cuda")
        key = torch.empty(n, dtype=torch.int64, **cuda)
        kv = torch.empty(n, dtype=torch.bool, **cuda)
        keys = targets = None
        if key_kind == "targets":
            targets = torch.empty(n, dtype=torch.int32, **cuda)
        else:
            keys = [(key, kv if key_kind == "valid" else None)]
        cols = [(torch.empty(n, dtype=(torch.float64, torch.int32,
                                       torch.bool)[i % 3], **cuda),
                 kv if i % 2 else None) for i in range(n_cols)]
        length = torch.empty((), dtype=torch.int32, **cuda)
        outs, counts, ovf = K.segments(length, ndev, n, cols, keys=keys,
                                       targets=targets)
        outs2 = K.segments(length, ndev, n, cols, keys=keys,
                           targets=targets)[0]
    plan = K.segments_plan(n, ndev, n, n_cols)
    calls = plan["launches"]
    assert [name for name, _a in launched] == ["segments"] * (2 * calls)
    # one C call a chunk of 32 planes, the first writing the counts
    assert [a[20] for _n, a in launched] == 2 * list(range(calls))
    assert all(a[12] == plan["ctl_words"] and a[14] == id(counts)
               and a[15] == id(ovf) for _n, a in launched[:calls])
    assert sum(a[16] for _n, a in launched[:calls]) == 2 * n_cols
    # a call's launches share its epoch, the next call takes the next
    assert {a[13] for _n, a in launched[:calls]} == {1}
    assert {a[13] for _n, a in launched[calls:]} == {2}
    # the keys, or the given targets
    assert all((a[1] == 0) == (targets is not None)
               and a[5] == (0 if targets is None else id(targets))
               for _n, a in launched)
    # a device length goes by pointer
    assert all(a[7] != 0 and a[8] == 0 for _n, a in launched)
    assert counts.shape == (ndev,) and ovf.shape == ()
    assert [d.shape for d, _v in outs] == [(ndev, n)] * n_cols
    assert len(outs2) == n_cols


def test_segments_host_length_goes_by_value(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    _no_gpu()
    launched = _fake_launch(monkeypatch)
    with FakeTensorMode():
        key = torch.empty(9000, dtype=torch.int64, device="cuda")
        K.segments(8765, 3, 9000, [(key, None)], keys=[(key, None)])
        targets = K.segment_targets([(key, None)], 3)
    (_n1, a), (_n2, b) = launched
    assert a[7] == 0 and a[8] == 8765 and a[14] != 0
    # the targets alone: no counts, no columns
    assert b[6] == id(targets) and b[14] == 0 and b[16] == 0
    assert b[8] == 9000 and targets.dtype == torch.int32


@pytest.mark.parametrize("n_aggs", [0, 6, 7, 8, 16])
def test_segment_agg_batched_launches_on_cuda_tensors(monkeypatch, n_aggs):
    from torch._subclasses.fake_tensor import FakeTensorMode
    _no_gpu()
    launched = _fake_launch(monkeypatch)
    n, B, oc = 3 * TILE + 5, 8, 3 * TILE + 5
    with FakeTensorMode():
        cuda = dict(device="cuda")
        perm = torch.empty(n, dtype=torch.int32, **cuda)
        words = [torch.empty(n, dtype=torch.int64, **cuda)
                 for _ in range(2)]
        masks = torch.empty((B, n), dtype=torch.bool, **cuda)
        union = torch.empty(n, dtype=torch.bool, **cuda)
        # int64 sums: a float64 output would be a new view of its buffer
        aggs = [("sum", torch.empty(n, dtype=torch.int64, **cuda), None,
                 False) if i % 2 else ("count", None, None, False)
                for i in range(n_aggs)]
        ng, lead, present, vals, cnts = K.segment_agg_batched(
            perm, words, masks, aggs, oc, union=union)
    plan = K.segment_agg_batched_plan(n, B, oc, n_aggs)
    assert [name for name, _a in launched] == \
        ["segment_agg_batched"] * plan["calls"]
    # the caller's union is the runs' activity
    assert all(a[4] == id(union) for _n, a in launched)
    # the first chunk carries lead (its first aggregate), present and
    # ngroups; no output for the hidden first
    assert [a[31] for _n, a in launched] == [0] + [-1] * (plan["calls"] - 1)
    assert [a[30] for _n, a in launched] == [1] + [0] * (plan["calls"] - 1)
    outs = [list(a[35]) for _n, a in launched]
    assert outs[0][0] == 0
    assert [p for o in outs for p in o if p] == [id(v) for v in vals]
    assert [p for a in launched for p in list(a[1][36]) if p] == \
        [id(c) for c in cnts]
    assert lead.dtype == torch.int32 and lead.shape == (B, oc)
    assert ng.shape == (B,) and present.shape == (B, oc)
    assert len(vals) == len(cnts) == n_aggs
    # every launch counts its chunk's aggregates, the hidden first in the
    # first
    assert [a[8] for _n, a in launched] == [
        min(8, n_aggs + 1 - 8 * j) for j in range(plan["calls"])]
