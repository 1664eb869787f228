"""Device sort (port of ``ydb_tpu/ops/sort.py``).

The reference sorts (dropped rank, [null rank, key]..., iota) with
``lax.sort`` and gathers every column by the sorted iota. Here each
operand is first encoded, in plain torch, as an order-preserving
unsigned 64-bit key held in int64 storage — with ``lax.sort``'s float
total order (−0.0 equals 0.0, every NaN equal and after +inf) and the
reference's DESC rule (``-x`` for floats, ``~x`` for integers) — and the
``sort`` CUDA kernel returns the permutation. Columns follow by gather.
"""

from __future__ import annotations

import torch

from ydb_tpu_torch.ops.cuda import bindings as K

_SIGN = -(1 << 63)


def _sort_operand(x: torch.Tensor) -> torch.Tensor:
    """The reference's comparable operand: floats as float64 (float32
    widens exactly), bool and narrower ints as int64; int64 storage of
    uint64 stays as it is (it is encoded as unsigned below)."""
    if x.dtype.is_floating_point:
        return x.to(torch.float64)
    return x.to(torch.int64)


def encode_key(enc: torch.Tensor, unsigned: bool = False) -> torch.Tensor:
    """Order-preserving unsigned 64-bit key (int64 storage) of a sort
    operand: floats in lax.sort's total order, signed ints by flipping
    the sign bit, unsigned bit patterns as they are."""
    if enc.dtype.is_floating_point:
        x = torch.where(enc == 0, torch.zeros_like(enc), enc)
        x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
        bits = x.view(torch.int64)
        return torch.where(bits < 0, ~bits, bits ^ _SIGN)
    if unsigned:
        return enc
    return enc ^ _SIGN


def key_words(d: torch.Tensor, v, asc: bool = True, nulls_first: bool = True,
              unsigned: bool = False) -> list:
    """The sort key words of one column: its null rank when it has a
    validity mask (NULLs first or last), then its encoding — zero where
    NULL, so every NULL compares equal."""
    enc = _sort_operand(d)
    if not asc:
        enc = -enc if enc.dtype.is_floating_point else ~enc
    words = []
    if v is not None:
        nullrank = (~v) if not nulls_first else v
        words.append(encode_key(nullrank.to(torch.int64)).contiguous())
        enc = torch.where(v, enc, torch.zeros_like(enc))
    words.append(encode_key(enc, unsigned=unsigned).contiguous())
    return words


def group_key_words(keys, env: dict, unsigned: frozenset = frozenset()
                    ) -> list:
    """Key words of a GROUP BY (the reference's sort operands in
    `xla_exec._trace_group_by_sorted`): per key, a nullable key's int32
    validity operand before its encoding, so NULLs group together and
    sort first; ascending. Rows with equal words form one group: the
    encoding equates −0.0 with 0.0 and every NaN with every other."""
    words = []
    for name in keys:
        d, v = env[name]
        words += key_words(d, v, unsigned=name in unsigned)
    return words


def sort_env(arrays, valids, length, sel, keys: tuple, names: tuple,
             unsigned: frozenset = frozenset()):
    """keys: tuple of (col_name, ascending, nulls_first); `unsigned`:
    key columns whose int64 storage holds uint64 values."""
    return _sort_impl(arrays, valids, length, sel, keys, names, unsigned)


def _sort_impl(arrays, valids, length, sel, keys: tuple, names: tuple,
               unsigned: frozenset = frozenset()):
    if any(a.dim() == 2 for a in list(arrays.values())
           + list(valids.values())) or (sel is not None and sel.dim() == 2) \
            or (isinstance(length, torch.Tensor) and length.dim() == 1):
        return _sort_members(arrays, valids, length, sel, keys, names,
                             unsigned)
    first = arrays[names[0]]
    cap = first.shape[0]
    device = first.device
    iota = torch.arange(cap, dtype=torch.int32, device=device)
    active = iota < length
    if sel is not None:
        active = active & sel

    sort_keys = [encode_key((~active).to(torch.int64))]  # dropped rows last
    for (name, asc, nulls_first) in keys:
        sort_keys += key_words(arrays[name], valids.get(name), asc,
                               nulls_first, name in unsigned)

    perm = K.sort_perm(sort_keys, cap, device)
    new_arrays, new_valids = {}, {}
    for name in names:
        new_arrays[name] = arrays[name][perm]
        if name in valids:
            new_valids[name] = valids[name][perm]
    new_len = active.to(torch.int32).sum()
    return new_arrays, new_valids, new_len


def _sort_members(arrays, valids, length, sel, keys: tuple, names: tuple,
                  unsigned: frozenset):
    """The member axis (the batched lane): every member's rows sorted by
    ONE sort of the B·cap rows whose leading key word is the member id,
    then each member's rows past its length (or off its mask), then the
    keys — each member's rows come out in its own order, in its own row
    of (B, cap) outputs, with (B,) lengths."""
    tensors = list(arrays.values()) + list(valids.values()) + [sel, length]
    B = next(t.shape[0] for t in tensors if isinstance(t, torch.Tensor)
             and (t.dim() == 2 or (t is length and t.dim() == 1)))
    cap = arrays[names[0]].shape[-1]
    device = arrays[names[0]].device

    def full(x):
        return x if x.dim() == 2 else x.unsqueeze(0).expand(B, cap)

    iota = torch.arange(cap, dtype=torch.int32, device=device)
    active = iota[None, :] < (length[:, None] if length.dim() == 1
                              else length)
    if sel is not None:
        active = active & sel
    active = active.expand(B, cap)
    member = torch.arange(B, dtype=torch.int64, device=device)[:, None]
    sort_keys = [encode_key(member.expand(B, cap).reshape(-1)),
                 encode_key((~active).to(torch.int64).reshape(-1))]
    for (name, asc, nulls_first) in keys:
        v = valids.get(name)
        sort_keys += key_words(full(arrays[name]).reshape(-1),
                               None if v is None else full(v).reshape(-1),
                               asc, nulls_first, name in unsigned)
    perm = K.sort_perm(sort_keys, B * cap, device).to(torch.int64)
    local = perm.reshape(B, cap) - member * cap
    new_arrays, new_valids = {}, {}
    for name in names:
        new_arrays[name] = torch.gather(full(arrays[name]), 1, local)
        if name in valids:
            new_valids[name] = torch.gather(full(valids[name]), 1, local)
    new_len = active.to(torch.int32).sum(1, dtype=torch.int32)
    return new_arrays, new_valids, new_len
