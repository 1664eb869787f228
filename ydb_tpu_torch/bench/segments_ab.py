"""A/B of the segments kernel (K15a) on one GPU, in one process.

    python3 -m ydb_tpu_torch.bench.segments_ab [--other OTHER.cu ...]

Builds the tree's ``ops/cuda/csrc/segments.cu`` and, with each
``--other``, another source of the same C interface (the tree's with
other launch constants, say). Every side runs through the tree's
wrapper on seeded inputs of the two shapes ``chip_smoke.py`` records on
the mesh path: the shuffle join's probe-row routing (2,097,152 rows, all
live, one int64 key with a valid, 4 targets, seg = n, five 8-byte and
two 4-byte columns, each with a valid) and q18's partial aggregate
(2,097,152 rows, 524,088 live, the key its first column, two 8-byte
columns with valids, 4 targets, seg = n). Each side must equal the
plain version bit for bit, twice. Times are CUDA-event medians
(``chip_smoke.time_ms``) taken in four rounds that alternate which side
runs first (``bench/ab.py``), beside the byte bound, a write floor
(``zero_`` of every output plane: the card's store rate for the bytes
the outputs hold) and the tree's call once more under torch.profiler
(device ms by kernel). Prints the card, a line per case and the times
as JSON on the last line.
"""

from __future__ import annotations

import argparse
import json
import sys

from ydb_tpu_torch.bench import ab

LIBS = {"segments": "segments_launch"}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", default=[],
                    help="another segments.cu with the same C interface, "
                    "one more side (other1, other2, ... in order)")
    args = ap.parse_args()
    cs = ab.start("segments_ab")
    if cs is None:
        return 2
    import torch

    from ydb_tpu_torch.ops.cuda import bindings as B

    sides = ab.build_sides(cs, LIBS, args.other)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(15)

    def words(m, dtype=torch.int64):
        return torch.randint(-(1 << 31), 1 << 31, (m,), generator=g,
                             device=dev, dtype=dtype)

    def valid(m):
        return torch.rand((m,), generator=g, device=dev) < 0.95

    n = 2_097_152
    jkey = (words(n), valid(n))
    join_cols = [jkey] + [(words(n), valid(n)) for _ in range(4)] + [
        (words(n, torch.int32), valid(n)) for _ in range(2)]
    qkey = (words(n), valid(n))
    q18_cols = [qkey, (words(n), valid(n))]
    cases = {
        "join routing": (torch.tensor(n, dtype=torch.int32, device=dev), 4,
                         n, join_cols, [jkey]),
        "q18 partial": (torch.tensor(524_088, dtype=torch.int32,
                                     device=dev), 4, n, q18_cols, [qkey])}

    out = {}
    for name, (length, ndev, seg, cols, keys) in cases.items():
        want = B.segments_plain(length, ndev, seg, cols, keys=keys)

        def run():
            return B.segments(length, ndev, seg, cols, keys=keys)
        ab.check_sides(cs, sides, run, lambda got: torch.equal(
            got[1], want[1]) and all(
            torch.equal(cs.bits(a), cs.bits(b)) and torch.equal(av, bv)
            for (a, av), (b, bv) in zip(got[0], want[0])), name)
        times = ab.alternate(cs, sides, run)
        ab.release(LIBS)
        planes = [t for d, v in want[0] for t in (d, v)]
        row = dict(times,
                   write_floor_ms=cs.time_ms(lambda: [t.zero_()
                                                      for t in planes]),
                   bound_ms=cs.bound_ms(cs.segments_bytes(keys, cols, ndev,
                                                          seg)),
                   device_items=ab.device_ms(run))
        out[name] = row
        print(f"segments {name}: " + " ".join(
            f"{k}={v}" for k, v in row.items()), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
