"""Device-side window functions (port of ``ydb_tpu/ops/window_dev.py``).

The engine's device window lane: every supported spec of a windowed
SELECT evaluated on the engine's device over the whole frame, eagerly,
with ONE device→host transfer for all outputs:

  * one sort per distinct (PARTITION BY, ORDER BY) clause (the ``sort``
    kernel): partition keys hash-combined into ONE u64 word (the
    ``hash64`` kernel, the reference's hash bit for bit, shifted right by
    one), order keys encoded into order-preserving words (``ops/sort.py``
    ``encode_key``), the row id breaking ties;
  * partition and order boundaries, segment starts and ends, the order
    group starts and counts (rank, dense_rank), in-partition prefix sums
    with their valid counts and running min/max: one ``window_scan``
    kernel launch (K13) over the sorted order, values read through the
    permutation;
  * row_number / rank / dense_rank, running, whole-partition and
    ROWS BETWEEN sum/count/avg (differences of in-partition prefixes at
    clipped offsets: a prefix never crosses a partition), running and
    whole-partition min/max, and lead/lag: gathers and elementwise torch;
  * results return to source row order through the inverse permutation
    (a scatter, ``inv[perm] = iota``); with a pushed-down final ORDER BY
    + LIMIT, one more sort and every output sliced to offset+limit rows.

The frame is not padded to a capacity bucket (nothing is compiled per
shape), so no padding rows and no padding sentinel exist.
Unsupported shapes (float partition keys, bounded min/max frames,
exotic funcs) decline → the caller keeps the pandas lane. The
host-side spec checks and key encodings below are the reference's
(``tests/test_torch_drift.py`` holds them equal).
"""

from __future__ import annotations

import numpy as np
import torch

from ydb_tpu_torch.ops.cuda import bindings as K
from ydb_tpu_torch.ops.device import batched_to_host
from ydb_tpu_torch.ops.sort import encode_key
from ydb_tpu_torch.ops.torch_ns import to_tensor

DEVICE_FUNCS = {"row_number", "rank", "dense_rank", "sum", "min", "max",
                "count", "avg", "lead", "lag"}

_I64MAX = np.iinfo(np.int64).max


# ---------------------------------------------------------------------------
# host-side spec compilation: which specs can run on device, key encodings
# ---------------------------------------------------------------------------


def _sort_group_key(spec) -> tuple:
    return (tuple(spec["part"]), tuple(spec["order"]), tuple(spec["asc"]))


def spec_supported(spec, block) -> bool:
    fn = spec["func"]
    if fn not in DEVICE_FUNCS:
        return False
    frame = spec.get("frame")
    if frame is not None:
        if fn in ("min", "max"):
            return False              # bounded sliding min/max: host lane
        if fn in ("row_number", "rank", "dense_rank", "lead", "lag"):
            return False              # frame is meaningless / unsupported
        _tag, lo, hi = frame
        for b in (lo, hi):
            if not isinstance(b, (int, tuple)):
                return False
    if fn in ("lead", "lag"):
        # arg 0 = value, optional arg 1 = offset literal (inner select
        # materializes it as a column; constant columns only). The
        # 3-arg DEFAULT form stays on the host lane.
        if not spec["args"] or len(spec["args"]) > 2:
            return False
    for name in spec["part"]:
        cd = block.columns[name]
        if np.issubdtype(cd.data.dtype, np.floating):
            return False              # no f64 bitcast on this platform
    return True


def _encode_part_host(block, names):
    """Partition keys → (arrays to hash, validity ints). Equality-only."""
    out = []
    for n in names:
        cd = block.columns[n]
        out.append((cd.data.astype(np.int64),
                    None if cd.valid is None
                    else cd.valid.astype(np.int64)))
    return out


def _final_key_ok(cd) -> bool:
    d = cd.data
    return (cd.dictionary is not None
            or np.issubdtype(d.dtype, np.floating)
            or np.issubdtype(d.dtype, np.integer)
            or d.dtype == np.bool_)


def _encode_final_key(cd, ascending):
    """Final ORDER BY key → order-preserving operand with the ENGINE's
    NULL placement (YQL null-smallest: first when ascending, last when
    descending — matching `apply_order_limit`'s defaults)."""
    d = cd.data
    if cd.dictionary is not None:
        ranks = cd.dictionary.sort_ranks()
        enc = ranks[np.clip(d, 0, None)].astype(np.int64)
        enc = np.where(d < 0, 0, enc)
        valid = (d >= 0) if cd.valid is None else (cd.valid & (d >= 0))
    else:
        valid = cd.valid
        if np.issubdtype(d.dtype, np.floating):
            enc = d.astype(np.float64)
            if not ascending:
                enc = -enc
            if valid is not None:
                enc = np.where(valid, enc,
                               -np.inf if ascending else np.inf)
            return np.where(np.isnan(enc),
                            -np.inf if ascending else np.inf, enc)
        elif np.issubdtype(d.dtype, np.integer) or d.dtype == np.bool_:
            enc = d.astype(np.int64)
        else:
            return None
    # INT64_MIN cannot negate (wraps to itself) and collides with the
    # ascending NULL sentinel — decline such rows to the host tail
    if len(enc) and int(enc.min()) == np.iinfo(np.int64).min:
        return None
    enc = enc if ascending else -enc
    if valid is not None:
        sent = np.iinfo(np.int64).min if ascending else _I64MAX
        enc = np.where(valid, enc, sent)
    return enc


def _encode_order_host(block, name, ascending):
    """One order key → an order-preserving f64/i64 array with NULLs
    mapped last (pandas na_position='last' parity)."""
    cd = block.columns[name]
    d = cd.data
    if cd.dictionary is not None:
        ranks = cd.dictionary.sort_ranks()
        d = ranks[np.clip(d, 0, None)].astype(np.int64)
        d = np.where(cd.data < 0, 0, d)
    if np.issubdtype(d.dtype, np.floating):
        enc = d.astype(np.float64)
        if not ascending:
            enc = -enc
        if cd.valid is not None:
            enc = np.where(cd.valid, enc, np.inf)
        enc = np.where(np.isnan(enc), np.inf, enc)
        return enc
    enc = d.astype(np.int64)
    if not ascending:
        enc = -enc
    if cd.valid is not None:
        enc = np.where(cd.valid, enc, _I64MAX)
    return enc





# ---------------------------------------------------------------------------
# the device body
# ---------------------------------------------------------------------------


def _scan_operand(x: torch.Tensor) -> torch.Tensor:
    """The kernel's 8-byte operand: floats as float64, the rest int64."""
    if x.dtype.is_floating_point:
        return x.to(torch.float64).contiguous()
    return x.to(torch.int64).contiguous()


def _window_body(struct, inputs: dict, n: int, device):
    """Every spec of `struct` over the `n`-row frame held in `inputs`
    (tensors on `device`). Returns {alias: (values, valid | None)} in
    source row order, or, with a final sort, ({name: (values, valid |
    None)} sliced to K rows, n_out)."""
    iota = torch.arange(n, dtype=torch.int64, device=device)
    outs = {}
    for gi, grp in enumerate(struct["groups"]):
        # --- one sort per clause group. PARTITION BY keys hash-combined
        # into one u64 word, as the reference does (two distinct
        # partitions whose hashes collide in the surviving 63 bits would
        # merge; the reference documents the 2^-63 tradeoff)
        nparts = grp["n_part_ops"]
        phash = K.hash64([torch.zeros(n, dtype=torch.int64, device=device)]
                         + [inputs[f"g{gi}p{pi}"] for pi in range(nparts)],
                         pre=[False] + [True] * nparts)
        pword = K._lsr(phash, 1)
        owords = [encode_key(inputs[f"g{gi}o{oi}"])
                  for oi in range(grp["n_order"])]
        perm = K.sort_perm([pword] + owords, n, device)
        perm64 = perm.to(torch.int64)
        inv = torch.empty(n, dtype=torch.int64, device=device)
        inv[perm64] = iota

        def unsort(x):
            return x[inv]

        # --- the aggregate operands, one scan per distinct (op, value)
        scan_of: dict = {}
        aggs: list = []
        for si, spec in enumerate(grp["specs"]):
            fnname = spec["func"]
            if fnname not in ("sum", "count", "avg", "min", "max"):
                continue
            op = "sum" if fnname in ("count", "avg") else fnname
            if fnname == "count" or not spec["has_arg"]:
                data = None                       # the valid count alone
            else:
                data = inputs[f"g{gi}s{si}a"]
            valid = inputs.get(f"g{gi}s{si}av") if spec["has_arg"] else None
            key = (op if data is not None else "count",
                   None if data is None else id(data),
                   None if valid is None else id(valid))
            if key not in scan_of:
                scan_of[key] = len(aggs)
                operand = torch.ones(n, dtype=torch.int64, device=device) \
                    if data is None else _scan_operand(data)
                aggs.append((op, operand, valid))
            spec["_scan"] = scan_of[key]
        seg_start, seg_end, grp_start, dense, scans = K.window_scan(
            perm, [pword], owords, aggs)

        for si, spec in enumerate(grp["specs"]):
            fnname = spec["func"]
            if fnname == "row_number":
                outs[spec["alias"]] = (unsort(iota - seg_start + 1), None)
                continue
            if fnname == "rank":
                outs[spec["alias"]] = (unsort(grp_start - seg_start + 1),
                                       None)
                continue
            if fnname == "dense_rank":
                outs[spec["alias"]] = (unsort(dense), None)
                continue
            if fnname in ("lead", "lag"):
                v = inputs[f"g{gi}s{si}a"][perm64]
                valid_in = inputs.get(f"g{gi}s{si}av")
                off = spec["offset"]
                tgt = iota + off if fnname == "lead" else iota - off
                inside = (tgt >= seg_start) & (tgt <= seg_end)
                tgt_c = torch.clamp(tgt, 0, max(n - 1, 0))
                out = v[tgt_c]
                ov = inside if valid_in is None \
                    else (inside & valid_in[perm64][tgt_c])
                outs[spec["alias"]] = (unsort(out), unsort(ov))
                continue
            # aggregates -------------------------------------------------
            val, cnt = scans[spec["_scan"]]
            vdtype = inputs[f"g{gi}s{si}a"].dtype if spec["has_arg"] \
                else torch.int64
            frame = spec["frame"]
            if fnname in ("min", "max"):
                if spec["running"]:
                    out, ov = val, cnt > 0
                else:
                    out, ov = val[seg_end], cnt[seg_end] > 0
                outs[spec["alias"]] = (unsort(out.to(vdtype)), unsort(ov))
                continue
            if frame is not None:
                _tag, lo, hi = frame
                start = seg_start if not isinstance(lo, int) \
                    else torch.clamp(iota + lo, seg_start, seg_end + 1)
                end1 = seg_end + 1 if not isinstance(hi, int) \
                    else torch.clamp(iota + hi + 1, seg_start, seg_end + 1)
                start = torch.minimum(start, end1)
            elif spec["running"]:
                start, end1 = seg_start, iota + 1
            else:
                start, end1 = seg_start, seg_end + 1

            def upto(x, prefix):
                # the in-partition sum of the rows [seg_start, x)
                got = prefix[torch.clamp(x - 1, 0, max(n - 1, 0))]
                return torch.where(x > seg_start, got, torch.zeros_like(got))

            scnt = upto(end1, cnt) - upto(start, cnt)
            if fnname == "count":
                outs[spec["alias"]] = (unsort(scnt), None)
                continue
            ssum = upto(end1, val) - upto(start, val)
            if fnname == "sum":
                outs[spec["alias"]] = (unsort(ssum.to(vdtype)),
                                       unsort(scnt > 0))
            else:                     # avg
                a = ssum.to(vdtype).to(torch.float64) \
                    / torch.clamp(scnt, min=1)
                outs[spec["alias"]] = (unsort(a), unsort(scnt > 0))

    fin = struct.get("final")
    if fin is None:
        return outs
    # final ORDER BY + LIMIT on the device: one more sort (keys + row id),
    # then every output leaves sliced to K rows
    words = []
    for key_spec in fin["keys"]:
        src, name, asc = key_spec[0], key_spec[1], key_spec[2]
        if src == "col":
            words.append(encode_key(inputs[name]))
            continue
        if src == "winstr":
            # string window output: lexicographic rank LUT; NULL (code < 0
            # or invalid) takes the engine's null-smallest placement
            v, vv = outs[name]
            ranks = inputs[key_spec[3]]
            code = v.to(torch.int64)
            enc = ranks[torch.clamp(code, 0, ranks.shape[0] - 1)]
            invalid = code < 0
            if vv is not None:
                invalid = invalid | ~vv
            enc = enc if asc else -enc
            sent = -_I64MAX - 1 if asc else _I64MAX
            words.append(encode_key(torch.where(
                invalid, torch.full_like(enc, sent), enc)))
            continue
        v, vv = outs[name]
        enc = v.to(torch.int64) if v.dtype == torch.bool else v
        if enc.dtype.is_floating_point:
            enc = enc.to(torch.float64)
            enc = enc if asc else -enc
            if vv is not None:
                enc = torch.where(vv, enc, torch.full_like(
                    enc, float("-inf") if asc else float("inf")))
        else:
            enc = enc.to(torch.int64)
            enc = enc if asc else -enc
            if vv is not None:
                enc = torch.where(vv, enc, torch.full_like(
                    enc, -_I64MAX - 1 if asc else _I64MAX))
        words.append(encode_key(enc))
    perm_f = K.sort_perm(words, n, device)[:fin["K"]].to(torch.int64) \
        if words else iota[:fin["K"]]
    final_outs = {}
    for alias, (v, vv) in outs.items():
        final_outs[alias] = (v[perm_f], None if vv is None else vv[perm_f])
    for name in fin["pass_cols"]:
        vvin = inputs.get(f"outv_{name}")
        final_outs[name] = (inputs[f"out_{name}"][perm_f],
                            None if vvin is None else vvin[perm_f])
    return final_outs, min(n, fin["K"])


def _readout(outs: dict) -> dict:
    """{name: (values, valid | None)} of device tensors → numpy, in ONE
    device→host transfer."""
    names = list(outs)
    flat = []
    for nm in names:
        v, vv = outs[nm]
        flat.append(v)
        if vv is not None:
            flat.append(vv)
    host = iter(batched_to_host(flat))
    out = {}
    for nm in names:
        v = next(host)
        vv = next(host) if outs[nm][1] is not None else None
        out[nm] = (v, vv)
    return out


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------


def compute_windows_device(block, outer, final_sort=None, limit=None,
                           offset=0, device="cuda"):
    """Evaluate every window spec of `outer` on `device`. Returns
    {alias: (np values, np valid|None, dict|None)} or None when any spec
    (or key encoding) requires the host lane.

    `final_sort`/`limit`: when given ([(name, ascending)], row limit),
    the lane ALSO sorts the full result by those keys and slices to
    offset+limit rows on the device before the transfer. Returns
    ({alias_or_col: (values, valid|None, dict|None)}, n_rows) in that
    mode, covering passthrough columns too."""
    specs = [p for k, p in outer if k == "win"]
    if not specs or block.length == 0:
        return None
    for s in specs:
        if not spec_supported(s, block):
            return None

    # pre-validate the final-sort keys BEFORE any encoding/upload work
    win_aliases_pre = {s["alias"] for s in specs}
    if final_sort is not None and limit is not None:
        for (name, _asc) in final_sort:
            if name in win_aliases_pre:
                continue
            cd = block.columns.get(name)
            if cd is None or not _final_key_ok(cd):
                return None
    else:
        final_sort = None             # offset/limit without both: plain

    # group by sort clause; build the static structure + input tensors
    groups: dict = {}
    order = []
    for s in specs:
        k = _sort_group_key(s)
        if k not in groups:
            groups[k] = []
            order.append(k)
        groups[k].append(s)

    dev = torch.device(device)
    L = block.length

    def up(a):
        return to_tensor(np.ascontiguousarray(a), dev)

    inputs: dict = {}
    struct = {"groups": []}
    for gi, k in enumerate(order):
        part, onames, asc = k
        gspecs = groups[k]
        pi = 0
        for name in part:
            for arr in _encode_part_host(block, [name])[0]:
                if arr is None:
                    continue
                inputs[f"g{gi}p{pi}"] = up(arr)
                pi += 1
        for oi, name in enumerate(onames):
            inputs[f"g{gi}o{oi}"] = up(_encode_order_host(block, name,
                                                          asc[oi]))
        sspecs = []
        for si, s in enumerate(gspecs):
            fn = s["func"]
            has_arg = bool(s["args"]) and not (
                fn == "count" and not s["args"])
            off_n = 1
            if fn in ("lead", "lag") and len(s["args"]) > 1:
                off_cd = block.columns[s["args"][1]]
                off_n = int(off_cd.data[0])
                if not (off_cd.data[:L] == off_cd.data[0]).all():
                    return None       # non-constant offset: host lane
            if has_arg:
                cd = block.columns[s["args"][0]]
                if cd.dictionary is not None and fn in (
                        "sum", "avg", "min", "max", "count"):
                    return None       # string aggregates: host lane
                d = cd.data
                if d.dtype == np.bool_:
                    d = d.astype(np.int64)
                inputs[f"g{gi}s{si}a"] = up(d)
                if cd.valid is not None:
                    inputs[f"g{gi}s{si}av"] = up(cd.valid)
            sspecs.append({
                "func": fn, "frame": s.get("frame"),
                "has_arg": has_arg,
                "running": bool(s["order"]),
                "offset": off_n, "alias": s["alias"],
                "dict": (block.columns[s["args"][0]].dictionary
                         if has_arg and fn in ("lead", "lag") else None),
            })
        struct["groups"].append({
            "n_part_ops": pi, "n_order": len(onames), "specs": sspecs})

    # final ORDER BY + LIMIT pushed down: passthrough columns upload once,
    # every output leaves the device sliced to offset+limit rows
    win_aliases = {s["alias"] for s in specs}
    pass_dicts = {}
    if final_sort is not None:
        Kf = min(int(offset) + int(limit), L)
        dict_of_alias = {s2["alias"]: s2["dict"]
                         for g in struct["groups"] for s2 in g["specs"]}
        fkeys = []
        for fi, (name, ascending) in enumerate(final_sort):
            if name in win_aliases:
                dic = dict_of_alias.get(name)
                if dic is not None:
                    # string-valued window output (lead/lag of a dict
                    # column): sort by LEXICOGRAPHIC rank
                    ranks = dic.sort_ranks().astype(np.int64)
                    inputs[f"frank{fi}"] = up(
                        ranks if len(ranks) else np.zeros(1, np.int64))
                    fkeys.append(("winstr", name, ascending,
                                  f"frank{fi}"))
                else:
                    fkeys.append(("win", name, ascending))
            else:
                cd = block.columns.get(name)
                if cd is None:
                    return None
                enc = _encode_final_key(cd, ascending)
                if enc is None:
                    return None
                inputs[f"fs{fi}"] = up(enc)
                fkeys.append(("col", f"fs{fi}", ascending))
        pass_cols = [p for k2, p in outer if k2 == "col"]
        for name in pass_cols:
            cd = block.columns[name]
            inputs[f"out_{name}"] = up(cd.data)
            if cd.valid is not None:
                inputs[f"outv_{name}"] = up(cd.valid)
            if cd.dictionary is not None:
                pass_dicts[name] = cd.dictionary
        struct["final"] = {"keys": fkeys, "K": Kf,
                           "pass_cols": list(pass_cols)}

    dicts = {s2["alias"]: s2["dict"]
             for g in struct["groups"] for s2 in g["specs"]}
    if struct.get("final") is not None:
        dev_outs, n = _window_body(struct, inputs, L, dev)
        dicts.update(pass_dicts)
        host = _readout(dev_outs)
        return {name: (vals[:n], None if valid is None else valid[:n],
                       dicts.get(name))
                for name, (vals, valid) in host.items()}, n
    host = _readout(_window_body(struct, inputs, L, dev))
    return {alias: (vals[:L], None if valid is None else valid[:L],
                    dicts.get(alias))
            for alias, (vals, valid) in host.items()}
