"""Device time by kernel of the member-axis group-by (K5 xB) on one GPU.

    python3 -m ydb_tpu_torch.bench.members_trace

Builds ClickBench's hits (1,000,000 rows, the generator's seed) and the
batch c40 sends over them (``chip_smoke.py``'s 8 members: a counter, a
day window, no refreshes, two traffic sources, one referer), sorts the
union of the members' masks by (URLHash, EventDate) and traces
``segment_agg_batched`` at the first 1, 2, 4 and 8 members (count(*)),
at 8 members with two aggregates, the single ``segment_agg`` over the
union, and synthetic batches (groups of ~10 rows, 60% of the live rows
a member) of 4,096 live rows among 4,096 and among 2^20, and of 65,536
live among 2^20, at B = 1 and 8. Each line: the CUDA-event median
(``chip_smoke.time_ms``) and the device ms of each kernel in a warmed
torch.profiler trace of one call. Prints the card first.
"""

from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main() -> int:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs
    from ydb_tpu_torch.bench.clickbench_gen import load_hits
    from ydb_tpu_torch.ops.cuda import bindings as B
    from ydb_tpu_torch.ops.sort import encode_key
    from ydb_tpu_torch.query import QueryEngine

    if not torch.cuda.is_available():
        print("members_trace: no CUDA device")
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")

    def trace(fn) -> dict:
        """Device ms by kernel of one call, from the second step of a
        trace (the first warms the tracer up)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile, schedule
        got = {}

        def ready(prof):
            got.update({e.key[:40]: round(float(
                getattr(e, "self_device_time_total", 0) or 0) / 1e3, 4)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and "Step" not in e.key})
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=ready) as prof:
            for _step in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        return got

    def line(tag, fn):
        print(f"{tag}: ms={cs.time_ms(fn):.4f} device_ms={trace(fn)}",
              flush=True)

    raw = load_hits(QueryEngine().catalog, n_rows=cs.CLICKBENCH_ROWS)
    hits = {c: torch.as_tensor(np.asarray(raw[c]), device=dev)
            for c in ("URLHash", "EventDate", "CounterID", "IsRefresh",
                      "TraficSourceID", "RefererHash")}
    g = torch.Generator(device=dev)
    g.manual_seed(4321)
    Bm, n = 8, hits["URLHash"].shape[0]
    cid = torch.randint(1, 101, (Bm,), generator=g, device=dev)
    cid[0] = 1
    lo = torch.randint(0, 16, (Bm,), generator=g, device=dev)
    hi = torch.clamp(lo + torch.randint(7, 31, (Bm,), generator=g,
                                        device=dev), max=30)
    day = hits["EventDate"].to(torch.int64) - 19530
    tsid = hits["TraficSourceID"]
    masks = ((hits["CounterID"][None, :] == cid[:, None])
             & (day[None, :] >= lo[:, None]) & (day[None, :] <= hi[:, None])
             & (hits["IsRefresh"] == 0)[None, :]
             & ((tsid == -1) | (tsid == 6))[None, :]
             & (hits["RefererHash"] == 1417906597943049265)[None, :]
             ).contiguous()
    words = [encode_key(hits["URLHash"].to(torch.int64)).contiguous(),
             encode_key(hits["EventDate"].to(torch.int64)).contiguous()]

    def order(words_, union):
        return B.sort_perm([encode_key((~union).to(torch.int64))] + words_,
                           union.shape[0], dev)

    for b in (1, 2, 4, 8):
        m = masks[:b].contiguous()
        u = m.any(0)
        p = order(words, u)
        line(f"c40 B={b}", lambda: B.segment_agg_batched(p, words, m, [], n,
                                                         union=u))
    u = masks.any(0)
    p = order(words, u)
    valid = torch.rand((n,), generator=g, device=dev) > 0.1
    two = [("sum", torch.rand((n,), generator=g, device=dev,
                              dtype=torch.float64), valid, False),
           ("count", None, valid, False)]
    line("c40 B=8, sum and count", lambda: B.segment_agg_batched(
        p, words, masks, two, n, union=u))
    line("single over the union", lambda: B.segment_agg(p, words, u, [], n))
    for rows, live in ((4096, 4096), (1 << 20, 4096), (1 << 20, 65536)):
        for b in (1, 8):
            w = [torch.randint(0, max(live // 10, 1), (rows,), generator=g,
                               device=dev)]
            m = torch.zeros((b, rows), dtype=torch.bool, device=dev)
            m[:, :live] = torch.rand((b, live), generator=g,
                                     device=dev) < 0.6
            mu = m.any(0)
            mp = order(w, mu)
            line(f"synthetic rows={rows} live={live} B={b}",
                 lambda: B.segment_agg_batched(mp, w, m, [], rows,
                                               union=mu))
    return 0


if __name__ == "__main__":
    sys.exit(main())
