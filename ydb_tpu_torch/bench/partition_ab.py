"""A/B of the partition kernel (K14) on one GPU, in one process.

    python3 -m ydb_tpu_torch.bench.partition_ab [--other OTHER.cu ...]

Builds the tree's ``ops/cuda/csrc/partition.cu`` and, with each
``--other``, another source of the same C interface (a parent commit's,
or the tree's with other launch constants). Every side runs through
the tree's wrapper (no ids, as the paths call it) on seeded inputs of
the two shapes ``chip_smoke.py`` times: the beyond-budget path's largest
spill feed (q21: 1,048,576 rows, 262,430 live, 16 partitions, three
8-byte columns and two bool ones, 26 bytes a row) and a GraceJoin
routing of lineitem (6,291,456 rows, 6,000,409 live, 8 partitions, four
8-byte columns and a bool, into 2n rows); the hashes are random 64-bit
words. Each side must equal the plain version bit for bit, twice. Times
are CUDA-event medians (``chip_smoke.time_ms``) taken in four rounds
that alternate which side runs first (``bench/ab.py``), beside the
stable ``sort`` + ``index_select`` floor and the byte bound; then the
tree's call once more under torch.profiler (device ms by kernel).
Prints the card, a line per case and the times as JSON on the last
line.
"""

from __future__ import annotations

import argparse
import json
import sys

from ydb_tpu_torch.bench import ab

LIBS = {"partition": "partition_launch"}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", default=[],
                    help="another partition.cu with the same C interface, "
                    "one more side (other1, other2, ... in order)")
    args = ap.parse_args()
    cs = ab.start("partition_ab")
    if cs is None:
        return 2
    import torch

    from ydb_tpu_torch.ops.cuda import bindings as B

    sides = ab.build_sides(cs, LIBS, args.other)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(14)

    def words(m):
        return torch.randint(-(1 << 63), (1 << 63) - 1, (m,), generator=g,
                             device=dev)

    def case(n, live, nparts, n_wide, out_rows):
        cols = [words(n) for _ in range(n_wide)] + [
            torch.rand((n,), generator=g, device=dev) < 0.5
            for _ in range(5 - n_wide)]
        length = torch.tensor(live, dtype=torch.int32, device=dev)
        return words(n), length, nparts, cols, out_rows

    n = 6_291_456
    cases = {"spill feed (q21)": case(1 << 20, 262_430, 16, 3, 1 << 20),
             "routing (lineitem)": case(n, 6_000_409, 8, 4, 2 * n)}
    out = {}
    for name, (h, length, nparts, cols, out_rows) in cases.items():
        want = B.partition_plain(h, length, nparts, cols, out_rows,
                                 ids=False)

        def run():
            return B.partition(h, length, nparts, cols, out_rows, ids=False)
        ab.check_sides(cs, sides, run, lambda got: torch.equal(
            got[1], want[1]) and all(
            torch.equal(x.view(torch.uint8), y.view(torch.uint8))
            for x, y in zip(got[2], want[2])), name)
        times = ab.alternate(cs, sides, run)
        ab.release(LIBS)
        pid = B.partition_plain(h, length, nparts, [], out_rows)[0]

        def lib_call():
            order = torch.sort(pid, stable=True).indices
            return [c.index_select(0, order) for c in cols]
        row = dict(times, library_ms=cs.time_ms(lib_call),
                   bound_ms=cs.bound_ms(cs.partition_bytes(
                       h.shape[0], cols, nparts, out_rows)),
                   device_items=ab.device_ms(run))
        out[name] = row
        print(f"partition {name}: " + " ".join(
            f"{k}={v}" for k, v in row.items()), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
