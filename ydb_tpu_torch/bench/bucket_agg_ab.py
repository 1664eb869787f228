"""A/B of the bucket_agg kernel on one GPU, in one process.

    python3 -m ydb_tpu_torch.bench.bucket_agg_ab --other OTHER.cu
        [--other ...] [--rows N]

Builds the tree's ``ops/cuda/csrc/bucket_agg.cu`` and, with each
``--other``, another source of the same C interface (a parent commit's,
say) and runs every side through the tree's wrapper on the same seeded
inputs: Q1's partial shape (12 buckets, 10 aggregates; rows spread
evenly over six, and TPC-H's own skew over four), the small-domain
lane's limit (512 buckets, 16 aggregates), middle and skewed domains,
and keyless sums (run by the sides whose source has the keyless entry).
Each side must match the plain version (ints exact, float sums to rtol
1e-9) and the tree's kernel must repeat itself bit for bit. Times are
CUDA-event medians (``chip_smoke.time_ms``), taken in four rounds that
alternate which side runs first (``bench/ab.py``). Prints the card, one
line per case, and the times as JSON on the last line.
"""

from __future__ import annotations

import argparse
import json
import sys

from ydb_tpu_torch.bench import ab

LIBS = {"bucket_agg": "bucket_agg_members_launch"}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", required=True,
                    help="another bucket_agg.cu with the same C interface, "
                    "one more side (other1, other2, ... in order)")
    ap.add_argument("--rows", type=int, default=6 * (1 << 20))
    args = ap.parse_args()
    cs = ab.start("bucket_agg_ab")
    if cs is None:
        return 2
    import torch

    from ydb_tpu_torch.ops.cuda import bindings as B

    sides = ab.build_sides(cs, LIBS, args.other)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    n = args.rows

    def rand(shape):
        return torch.rand(shape, generator=g, device=dev, dtype=torch.float64)

    def randint(lo, hi, shape, dtype=torch.int64):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=dtype)

    def mixed(nb: int, A: int, keyless: bool = False):
        kid = None if keyless else randint(0, nb, (n,), torch.int32)
        aggs = []
        for a in range(A):
            f = ("sum", "sum", "count", "min", "max", "first")[a % 6]
            d = None if f in ("count", "first") else (
                rand((n,)) * 1e5 if a % 4 else
                randint(-(1 << 40), 1 << 40, (n,)))
            aggs.append((f, d, rand((n,)) > 0.05 if a % 3 else None, False))
        return kid, nb, aggs

    live = torch.tensor([0, 2, 5, 6, 9, 11], device=dev, dtype=torch.int32)
    q1 = (live[randint(0, 6, (n,))].to(torch.int32), 12,
          [("sum", rand((n,)) * 1e5, rand((n,)) > 0.05 if a % 2 else None,
            False) for a in range(7)]
          + [("count", None, rand((n,)) > 0.1, False) for _ in range(3)])
    u = rand((n,))
    q1_skew = (torch.where(u < 0.49, 10, torch.where(
        u < 0.74, 5, torch.where(u < 0.993, 7, 6))).to(torch.int32), 12,
        [("sum", rand((n,)) * 1e5, None, False) for _ in range(7)]
        + [("count", None, None, False) for _ in range(3)])
    hot = torch.where(rand((n,)) < 0.5, torch.zeros(n, dtype=torch.int64,
                                                    device=dev),
                      randint(0, 300, (n,))).to(torch.int32)
    cases = {
        "q1 nb=12 aggs=10 (6 even buckets)": q1,
        "q1 nb=12 aggs=10 (TPC-H skew)": q1_skew,
        "nb=512 aggs=16": mixed(512, 16),
        "nb=64 aggs=8": mixed(64, 8),
        "nb=128 aggs=4": mixed(128, 4),
        "skewed nb=300 aggs=4": (hot, 300, [
            ("sum", rand((n,)) * 1e5, rand((n,)) > 0.05, False),
            ("count", None, None, False), ("min", rand((n,)), None, False),
            ("max", randint(-(1 << 62), 1 << 62, (n,)), None, True)]),
        "keyless aggs=1": (None, 1, [("sum", rand((n,)) * 1e5, None,
                                      False)]),
        "keyless aggs=2": (None, 1, [("sum", rand((n,)) * 1e5, None, False)
                                     for _ in range(2)]),
        "keyless aggs=16": mixed(1, 16, keyless=True),
    }
    active = rand((n,)) < 0.98
    sync = torch.cuda.synchronize
    out = {}
    for name, (kid, nb, aggs) in cases.items():
        # a source from before the keyless entry (K2's one launch) runs
        # the keyed cases only
        these = {side: libs for side, libs in sides.items()
                 if kid is not None or hasattr(ab.load(libs["bucket_agg"]),
                                               "bucket_agg_keyless_launch")}
        for side, libs in these.items():
            ab.use(libs)
            cs.check_bucket_agg(B, kid, nb, active, aggs, sync,
                                f"{name} {side}")
        ab.use(sides["tree"])
        first = B.bucket_agg(kid, nb, active, aggs)
        again = B.bucket_agg(kid, nb, active, aggs)
        sync()
        cs.check(all(torch.equal(x, y) for x, y in zip(first[0], again[0])),
                 f"{name}: tree kernel not repeatable")
        times = ab.alternate(cs, these, lambda: B.bucket_agg(
            kid, nb, active, aggs), iters=7)
        bound = cs.bound_ms(cs.agg_bytes(kid, nb, active, aggs))
        out[name] = dict(times, bound_ms=bound)
        print(f"{name}: " + " ".join(
            f"{side}_ms={times.get(side, 'no keyless entry')}"
            for side in sides) + f" bound_ms={bound}", flush=True)
    ab.release(LIBS)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
