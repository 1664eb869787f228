"""K14's `partition` and K7's `probe` as their CUDA kernels compute them:
the launch plans, and plain-torch emulations of the kernels' arithmetic
held against the plain versions.

`partition_plan` gives a call's launches (the census and one scatter for
up to 32 columns, one more scatter a further 32), its 4,096-row tiles,
the zero tail's chunks, the scatter's shared memory (within the H100's
227 KB) and the control words zeroed; `probe_plan` the rows a thread,
the grid, the search levels staged in shared memory and their bytes,
the levels below them (a key a load, three a node, the last window) and
the node table's words.

The K14 emulation follows partition.cu: the census of the live rows'
digits and its exclusive scan (the bins' bases), each tile's per-bin
counts and the exclusive sum over the earlier tiles (what the look-back
adds up), each live row's stable rank among its warp's rows of its
digit plus the earlier warps' counts and the tile's earlier bins, the
suffix past the length copied in place and the zero tail. The K7
emulation follows probe.cu's search: the pivot table keys[i * W - 1] in
breadth-first order, the first L levels down it, then levels a key a
load, three-level nodes from the table probe_table fills and the last
three levels from the 8 keys at pos, and the final
comparison on the last key read that was not below the probe (which
must be the key at the answer, bit for bit). Both must equal
`partition_plain` / `probe_plain` bit for bit at the shapes the card
checks (lengths at 0, 1, a tile - 1, a tile, a tile + 1 and n; 1, 2, 8
and 256 partitions; 33 columns of mixed widths; every kcap = 2^k for k
up to 24, int64 and float64 keys with sentinels, NaN, +-inf and -0.0).
The CUDA wrappers, on fake CUDA tensors (`FakeTensorMode`, no card),
launch what the plans say and never take the plain versions.
"""

import numpy as np
import pytest
import torch

from ydb_tpu_torch.ops.cuda import bindings as K
from tests import torch_threads  # noqa: F401,E402

TILE = 4096
WARP_ROWS = 512
SMEM_LIMIT = 232_448             # bytes of shared memory a block can use


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: real CUDA tensors launch the kernel")


def _fake_launch(monkeypatch):
    """Record the launches' names and arguments instead of running them
    (pointers as 0)."""
    launched = []
    monkeypatch.setattr(K, "_launch", lambda name, *a:
                        launched.append((name, a)))
    monkeypatch.setattr(K, "_ptr", lambda t: 0)
    monkeypatch.setattr(K, "_stream", lambda: 0)
    return launched


# ------------------------------------------------------------------ plans


@pytest.mark.parametrize("n_cols,launches", [(0, 2), (1, 2), (5, 2),
                                             (32, 2), (33, 3), (64, 3),
                                             (65, 4)])
@pytest.mark.parametrize("nparts", [1, 2, 8, 256])
def test_partition_plan_launches(n_cols, launches, nparts):
    n = 3 * TILE + 5
    plan = K.partition_plan(n, nparts, n_cols, 2 * n)
    assert plan["launches"] == launches
    assert plan["tiles"] == 4 and plan["chunks"] == launches - 1
    assert plan["zero_chunks"] == 4
    assert plan["smem"] <= SMEM_LIMIT
    assert plan["ctl_words"] == 4 * nparts + 2 * nparts + 1 + launches - 1


@pytest.mark.parametrize("n,out_rows,tiles,zero", [
    (1, 1, 1, 0), (TILE - 1, TILE, 1, 1), (TILE, TILE, 1, 0),
    (TILE + 1, 2 * TILE + 1, 2, 1), (TILE + 1, 2 * TILE + 2, 2, 2),
    (6_291_456, 2 * 6_291_456, 1536, 1536)])
def test_partition_plan_tiles(n, out_rows, tiles, zero):
    plan = K.partition_plan(n, 8, 5, out_rows)
    assert (plan["tiles"], plan["zero_chunks"]) == (tiles, zero)
    assert plan["launches"] == 2


def test_partition_plan_zero_rows_launches_nothing():
    assert K.partition_plan(0, 8, 40, 100)["launches"] == 0


@pytest.mark.parametrize("kcap,levels,plain,groups,table", [
    (1, 0, 0, 0, 0), (2, 1, 0, 0, 0), (1024, 10, 0, 0, 0),
    (16384, 14, 0, 0, 0), (1 << 16, 14, 2, 0, 0), (1 << 17, 14, 0, 0, 0),
    (1 << 18, 14, 1, 0, 0), (1 << 20, 14, 0, 1, 1 << 17),
    (1 << 21, 14, 1, 1, 1 << 18), (1 << 22, 14, 2, 1, 1 << 19),
    (1 << 23, 14, 0, 2, (1 << 17) + (1 << 20)),
    (1 << 24, 14, 1, 2, (1 << 18) + (1 << 21)),
    (1 << 26, 14, 0, 3, (1 << 17) + (1 << 20) + (1 << 23)),
    (1 << 29, 14, 0, 4, (1 << 17) + (1 << 20) + (1 << 23) + (1 << 26)),
    (1 << 30, 14, 1, 4, (1 << 18) + (1 << 21) + (1 << 24) + (1 << 27))])
def test_probe_plan_search_levels(kcap, levels, plain, groups, table):
    plan = K.probe_plan(6_291_456, kcap, True, 0)
    assert (plan["levels"], plan["plain"], plan["groups"],
            plan["table_words"]) == (levels, plain, groups, table)
    assert plan["smem"] == 8 << levels and plan["smem"] <= 128 * 1024
    assert plan["rows_per_thread"] == 8 and plan["threads"] == 384
    assert plan["tiles"] == 2048 and plan["grid"] == 132
    assert plan["launches"] == 1 + (table > 0)


@pytest.mark.parametrize("n,payloads,grid,launches", [
    (0, 0, 0, 0), (1, 0, 1, 1), (4096, 16, 1, 1), (4097, 17, 2, 2),
    (1 << 22, 33, 264, 3)])
def test_probe_plan_grid_and_launches(n, payloads, grid, launches):
    plan = K.probe_plan(n, 262_144, False, payloads)
    assert plan["levels"] == 0 and plan["smem"] == 0
    assert plan["table_words"] == 0 and plan["rows_per_thread"] == 8
    assert plan["threads"] == 512
    assert plan["grid"] == grid and plan["launches"] == launches


def test_source_constants_match_the_plans():
    """The plans' constants are the kernels'."""
    import re
    from ydb_tpu_torch.ops.cuda import build

    def define(name, src):
        return int(re.search(r"#define " + name + r" (\d+)", src).group(1))
    probe = (build.CSRC / "probe.cu").read_text()
    for bsearch, mode in ((False, "LUT"), (True, "SEARCH")):
        assert define(mode + "_PT", probe) == K._PROBE_THREADS[bsearch]
        assert define(mode + "_R", probe) == K._PROBE_ROWS[bsearch]
        assert define(mode + "_BLOCKS", probe) == \
            K._PROBE_BLOCKS_PER_SM[bsearch]
    assert define("MAX_LEVELS", probe) == K._PROBE_LEVELS
    assert define("MAX_PAYLOADS", probe) == K._MAX_PAYLOADS
    part = (build.CSRC / "partition.cu").read_text()
    assert define("PT", part) * define("PI", part) == K._PART_TILE == TILE
    assert define("PT", part) // 32 == K._PART_WARPS
    assert define("PI", part) * 32 == WARP_ROWS
    assert define("MAX_COLS", part) == K._PART_COLS
    assert define("MAX_BINS", part) == K._MAX_PARTS
    assert "#ifndef" not in probe and "#ifndef" not in part


# ------------------------------------------------------------------ K14


def _emulate_partition(h, length: int, nparts: int, cols, out_rows: int):
    """partition.cu's arithmetic in plain torch: (counts, outs)."""
    n = h.shape[0]
    ln = max(0, min(length, n))
    d = (h & (nparts - 1)).to(torch.int64)
    census = torch.bincount(d[:ln], minlength=nparts)
    base = torch.cumsum(census, 0) - census
    dst = torch.arange(n, dtype=torch.int64)      # the suffix stays put
    before = torch.zeros(nparts, dtype=torch.int64)
    for t in range(-(-n // TILE)):
        row0 = t * TILE
        live = 0 if nparts == 1 else max(0, min(ln - row0, TILE, n - row0))
        if live == 0:
            continue
        td = d[row0:row0 + live]
        onehot = torch.nn.functional.one_hot(td, nparts)
        # each row's rank among its warp's earlier rows of its digit
        rank = torch.empty(live, dtype=torch.int64)
        wcnt = []
        for w0 in range(0, live, WARP_ROWS):
            oh = onehot[w0:w0 + WARP_ROWS]
            rank[w0:w0 + WARP_ROWS] = (torch.cumsum(oh, 0) - oh).gather(
                1, td[w0:w0 + WARP_ROWS, None])[:, 0]
            wcnt.append(oh.sum(0))
        wcnt = torch.stack(wcnt)                   # warps x bins
        tc = wcnt.sum(0)
        wexcl = torch.cumsum(wcnt, 0) - wcnt       # earlier warps
        ls = torch.cumsum(tc, 0) - tc              # earlier bins
        warp = torch.arange(live) // WARP_ROWS
        slot = ls[td] + wexcl[warp, td] + rank
        dst[row0:row0 + live] = base[td] + before[td] + slot - ls[td]
        before += tc                               # the look-back's sum
    outs = []
    for c in cols:
        o = torch.zeros(out_rows, dtype=c.dtype)
        o[dst] = c
        outs.append(o)
    return census, outs


def _cols(rng, n: int, k: int):
    """k columns of widths 8, 4, 2, 1 and bool in turn (float64 with NaN,
    ±inf and -0.0 among them)."""
    out = []
    for i in range(k):
        w = i % 5
        if w == 0:
            v = rng.choice([np.nan, np.inf, -np.inf, -0.0, 0.0, 1.5], n)
            out.append(torch.from_numpy(v))
        elif w == 1:
            out.append(torch.from_numpy(rng.integers(-2**31, 2**31, n,
                                                     dtype=np.int32)))
        elif w == 2:
            out.append(torch.from_numpy(rng.integers(-2**15, 2**15, n,
                                                     dtype=np.int16)))
        elif w == 3:
            out.append(torch.from_numpy(rng.integers(0, 255, n,
                                                     dtype=np.uint8)))
        else:
            out.append(torch.from_numpy(rng.random(n) < 0.5))
    return out


N_PART = 3 * TILE + 333
LENGTHS = [0, 1, TILE - 1, TILE, TILE + 1, N_PART]


def _same_bits(a, b) -> bool:
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("nparts", [1, 2, 8, 256])
def test_partition_emulation_is_the_plain_version(length, nparts):
    rng = np.random.default_rng(length * 7 + nparts)
    h = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, N_PART,
                                      dtype=np.int64))
    cols = _cols(rng, N_PART, 33)
    out_rows = N_PART + 777
    counts, outs = _emulate_partition(h, length, nparts, cols, out_rows)
    _ids, want_counts, want = K.partition_plain(h, length, nparts, cols,
                                                out_rows)
    assert torch.equal(counts, want_counts)
    for o, w in zip(outs, want):
        assert _same_bits(o, w)


def test_partition_ids_false_on_cpu():
    rng = np.random.default_rng(5)
    h = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, 999,
                                      dtype=np.int64))
    cols = _cols(rng, 999, 5)
    ids, counts, outs = K.partition(h, 700, 8, cols, 1200, ids=False)
    want = K.partition(h, 700, 8, cols, 1200)
    assert ids is None and want[0].shape == (999,)
    assert torch.equal(counts, want[1])
    assert all(_same_bits(a, b) for a, b in zip(outs, want[2]))
    assert K.partition_plain(h, 700, 8, cols, ids=False)[0] is None


@pytest.mark.parametrize("n_cols", [0, 5, 32, 33])
@pytest.mark.parametrize("ids", [True, False])
def test_partition_launches_on_cuda_tensors(monkeypatch, n_cols, ids):
    from torch._subclasses.fake_tensor import FakeTensorMode
    _no_gpu()
    monkeypatch.setattr(K, "partition_plain", lambda *a, **k: pytest.fail(
        "a CUDA tensor took the plain version"))
    launched = _fake_launch(monkeypatch)
    n = 2 * TILE + 9
    with FakeTensorMode():
        h = torch.empty(n, dtype=torch.int64, device="cuda")
        cols = [torch.empty(n, dtype=(torch.float64, torch.int32,
                                      torch.bool)[i % 3], device="cuda")
                for i in range(n_cols)]
        got_ids, counts, outs = K.partition(h, n - 3, 16, cols, 2 * n,
                                            ids=ids)
    plan = K.partition_plan(n, 16, n_cols, 2 * n)
    # one C call a chunk of 32 columns: the first launches the census too
    assert [a[9] for _name, a in launched] == list(range(plan["chunks"]))
    assert all(name == "partition" and a[8] == plan["chunks"]
               and a[7] == plan["ctl_words"] and a[10] == 2 * n
               for name, a in launched)
    assert sum(a[11] for _name, a in launched) == n_cols
    assert (got_ids is not None) == ids and counts.shape == (16,)
    assert [o.shape[0] for o in outs] == [2 * n] * n_cols


def test_partition_zero_rows_on_cuda_launches_nothing(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    _no_gpu()
    launched = _fake_launch(monkeypatch)
    with FakeTensorMode():
        h = torch.empty(0, dtype=torch.int64, device="cuda")
        ids, counts, outs = K.partition(
            h, 0, 8, [torch.empty(0, dtype=torch.int32, device="cuda")], 64)
    assert launched == [] and ids.shape == (0,) and outs[0].shape == (64,)
    assert counts.shape == (8,)


# ------------------------------------------------------------------ K7


def _descend3(nodes, e, kf):
    """Three levels over (n, 8) breadth-first subtrees (words 1 .. 7):
    the eighth pos moves up, and kf after them."""
    m = torch.ones(e.shape, dtype=torch.int64)
    for _ in range(3):
        kv = nodes.gather(1, m[:, None])[:, 0]
        kf = torch.where(kv < e, kf, kv)
        m = 2 * m + (kv < e).long()
    return m - 8, kf


def _emulate_search(keys: torch.Tensor, e: torch.Tensor):
    """probe.cu's search: the pivot table in breadth-first order (node
    2^l + k of level l is keys[(2k + 1) * 2^(L-1-l) * W - 1], node 0
    keys[kcap - 1]) and the first L levels down it; then `plain` levels a
    key a load, `groups` of three levels a node from the table that
    probe_table fills, and the last three from the 8 keys at pos; and the
    key the last comparison takes: the last key read that was not below
    the probe, keys[kcap - 1] if none was. Returns (idx, that key)."""
    kcap = keys.shape[0]
    plan = K.probe_plan(1, kcap, True, 0)
    L = plan["levels"]
    W = kcap >> L
    node = torch.arange(1 << L)
    level = torch.floor(torch.log2(node.clamp(min=1).double())).long()
    unit = torch.where(node > 0, (2 * (node - (1 << level)) + 1)
                       << (L - 1 - level).clamp(min=0), 1 << L)
    piv = keys[unit * W - 1]
    kf = piv[0].expand(e.shape).clone()
    i = torch.ones(e.shape, dtype=torch.int64)
    for _ in range(L):
        kv = piv[i]
        kf = torch.where(kv < e, kf, kv)
        i = 2 * i + (kv < e).long()
    pos = (i - (1 << L)) * W
    step = W >> 1
    for _ in range(plan["plain"]):
        kv = keys[pos + step - 1]
        kf = torch.where(kv < e, kf, kv)
        pos = torch.where(kv < e, pos + step, pos)
        step >>= 1
    words = 0
    for _ in range(plan["groups"]):
        U = 2 * step
        # probe_table: node q's word m (1 .. 7) is the key its level
        # (m's top bit) reads below q * U
        m = torch.arange(1, 8)
        d = torch.floor(torch.log2(m.double())).long()
        off = (2 * (m - (1 << d)) + 1) * (U >> (d + 1)) - 1
        q = torch.arange(kcap // U)
        table = torch.zeros((kcap // U, 8), dtype=keys.dtype)
        table[:, 1:] = keys[q[:, None] * U + off[None, :]]
        words += table.numel()
        sub, kf = _descend3(table[pos // U], e, kf)
        pos = pos + sub * (U >> 3)
        step >>= 3
    assert words == plan["table_words"]
    if step == 4:
        # the 8 keys from pos, as a subtree: root pos + 3, then + 1 / + 5,
        # then + 0, + 2, + 4, + 6
        w = keys[pos[:, None] + torch.tensor([0, 3, 1, 5, 0, 2, 4, 6])]
        sub, kf = _descend3(w, e, kf)
        pos = pos + sub
    return pos, kf


def _build(rng, kcap: int, floating: bool):
    """kcap sorted keys: about three quarters real, the rest the
    sentinel padding (int64 max, or +inf)."""
    nb = max(1, (3 * kcap) // 4)
    if floating:
        real = np.sort(np.concatenate([
            rng.normal(size=nb - min(nb, 3)) * 1e3,
            np.array([-np.inf, -0.0, 0.5])[:min(nb, 3)]]))
        pad = np.full(kcap - nb, np.inf)
    else:
        real = np.sort(rng.choice(1 << 40, nb, replace=False)
                       - (1 << 39))
        pad = np.full(kcap - nb, np.iinfo(np.int64).max)
    return torch.from_numpy(np.concatenate([real, pad])), nb


def _probes(rng, keys, nb: int, floating: bool, n: int = 1500):
    hits = keys[torch.from_numpy(rng.integers(0, nb, n))]
    if floating:
        odd = torch.from_numpy(rng.choice(
            [np.nan, np.inf, -np.inf, -0.0, 0.0, 1e308], n))
        miss = torch.from_numpy(rng.normal(size=n) * 1e3)
    else:
        odd = torch.from_numpy(rng.choice(
            [np.iinfo(np.int64).max, np.iinfo(np.int64).min, 0, -1], n))
        miss = torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, n))
    u = torch.from_numpy(rng.random(n))
    return torch.where(u < 0.5, hits, torch.where(u < 0.8, miss, odd))


@pytest.mark.parametrize("floating", [False, True])
@pytest.mark.parametrize("k", range(25))
def test_search_emulation_is_the_plain_version(k, floating):
    rng = np.random.default_rng(100 + k + 50 * floating)
    kcap = 1 << k
    keys, nb = _build(rng, kcap, floating)
    e = _probes(rng, keys, nb, floating)
    sel = torch.from_numpy(rng.random(e.shape[0]) < 0.7)
    kvalid = torch.from_numpy(rng.random(e.shape[0]) < 0.9)
    pos, kx = _emulate_search(keys, e)
    assert _same_bits(kx, keys[pos])          # the key at pos, no load
    found = (kx == e) & sel & kvalid & (pos < nb)
    got_found, safe, _sel, _g = K.probe_plain(
        e, kvalid, sel, lut=None, lut_base=0, keys_sorted=keys, n_build=nb,
        pcap=kcap, kind="inner", not_in=False, has_null=False, payloads=[])
    assert torch.equal(safe.to(torch.int64), pos)
    assert torch.equal(got_found, found)


@pytest.mark.parametrize("n_payloads,launches", [(0, 1), (16, 1), (17, 2)])
@pytest.mark.parametrize("bsearch", [False, True])
def test_probe_launches_on_cuda_tensors(monkeypatch, n_payloads, launches,
                                        bsearch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    _no_gpu()
    monkeypatch.setattr(K, "probe_plain", lambda *a, **k: pytest.fail(
        "a CUDA tensor took the plain version"))
    launched = _fake_launch(monkeypatch)
    n, kcap = 5000, 1 << 13
    with FakeTensorMode():
        key = torch.empty(n, dtype=torch.int64, device="cuda")
        sel = torch.empty(n, dtype=torch.bool, device="cuda")
        keys = torch.empty(kcap, dtype=torch.int64, device="cuda")
        lut = None if bsearch else torch.empty(kcap, dtype=torch.int32,
                                               device="cuda")
        pays = [(torch.empty(kcap, dtype=torch.float64, device="cuda"), None)
                for _ in range(n_payloads)]
        found, safe, out_sel, gathered = K.probe(
            key, None, sel, lut=lut, lut_base=0, keys_sorted=keys,
            n_build=kcap, pcap=kcap, kind="left", not_in=False,
            has_null=False, payloads=pays)
    assert len(launched) == launches == K.probe_plan(
        n, kcap, bsearch, n_payloads)["launches"]   # no node table here
    assert all(a[5] == int(bsearch) for _name, a in launched)
    assert sum(a[19] for _name, a in launched) == n_payloads
    assert len(gathered) == n_payloads and safe.dtype == torch.int32


@pytest.mark.parametrize("n_payloads", [0, 17])
def test_probe_builds_the_node_table_once(monkeypatch, n_payloads):
    from torch._subclasses.fake_tensor import FakeTensorMode
    _no_gpu()
    launched = _fake_launch(monkeypatch)
    n, kcap = 5000, 1 << 20
    with FakeTensorMode():
        key = torch.empty(n, dtype=torch.int64, device="cuda")
        sel = torch.empty(n, dtype=torch.bool, device="cuda")
        keys = torch.empty(kcap, dtype=torch.int64, device="cuda")
        pays = [(torch.empty(kcap, dtype=torch.int32, device="cuda"), None)
                for _ in range(n_payloads)]
        K.probe(key, None, sel, lut=None, lut_base=0, keys_sorted=keys,
                n_build=kcap, pcap=kcap, kind="inner", not_in=False,
                has_null=False, payloads=pays)
    plan = K.probe_plan(n, kcap, True, n_payloads)
    assert plan["table_words"] == 1 << 17
    assert plan["launches"] == len(launched) + 1
    # the table's words on every call, filled by the first only
    assert [a[27] for _name, a in launched] == [1 << 17] * len(launched)
    assert [a[28] for _name, a in launched] == [1] + [0] * (
        len(launched) - 1)


@pytest.mark.parametrize("kcap", [3, 1 << 31])
def test_probe_rejects_builds_the_kernel_cannot_search(monkeypatch, kcap):
    from torch._subclasses.fake_tensor import FakeTensorMode
    _no_gpu()
    _fake_launch(monkeypatch)
    with FakeTensorMode():
        key = torch.empty(64, dtype=torch.int64, device="cuda")
        sel = torch.empty(64, dtype=torch.bool, device="cuda")
        keys = torch.empty(kcap, dtype=torch.int64, device="cuda")
        with pytest.raises(ValueError, match="pow2-padded"):
            K.probe(key, None, sel, lut=None, lut_base=0, keys_sorted=keys,
                    n_build=1, pcap=1, kind="inner", not_in=False,
                    has_null=False, payloads=[])
