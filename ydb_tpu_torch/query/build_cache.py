"""Cross-query join-build cache.

The round-4 profile (PERF.md) showed the slow half of TPC-H losing to a
single CPU core because every query RE-EXECUTED its join-build pipelines
and re-uploaded every probe LUT: q2/q5/q7/q9/q21-class plans spend
seconds per run rebuilding identical dimension tables. The reference
amortizes compiled patterns across queries through its computation
pattern cache (`mkql_computation_pattern_cache.h:56`) and reuses scan
state; the TPU-native equivalent is to cache the finished, device-
resident `BuildTable` (sorted keys + payload + direct-address LUT in
HBM) keyed by WHAT it was built from:

  * the structural fingerprint of the build plan (scans, programs,
    nested joins, sort/limit shape),
  * the VALUES of every runtime param the build references,
  * the exact visible data of every table the build scans at the read
    snapshot (the superblock cache's src-id discipline — portions are
    immutable, so the id set IS the data version),
  * the probe-side dictionary the build key was remapped into (held by
    reference: identity + length pin the remap),
  * the join-step shape (key/payload/kind/hash-keys/anti flags) and the
    executor knobs that steer the build (grace budget, mesh arity).

Entries are LRU-evicted under a byte budget of resident bytes (device
HBM for BuildTable, host DRAM for PartitionedBuild — the GraceJoin
partitions are cheap by comparison but still bounded).
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np

__all__ = ["BuildCache", "build_plan_fingerprint"]


def _hash_param_value(v) -> str:
    if isinstance(v, np.ndarray):
        h = hashlib.sha256()
        h.update(str(v.dtype).encode())
        h.update(str(v.shape).encode())
        h.update(np.ascontiguousarray(v).tobytes())
        return h.hexdigest()[:16]
    if isinstance(v, (np.generic,)):
        return f"{v.dtype}:{v!r}"
    return repr(v)


def _fp_pipeline(pipe, catalog, snapshot, parts: list, pnames: set) -> bool:
    """Fingerprint one Pipeline into `parts`, collecting referenced param
    names. False = uncacheable (row-table scans have no immutable source
    enumeration)."""
    from ydb_tpu_torch.ops.ir import program_params
    from ydb_tpu_torch.storage.device_cache import enumerate_scan_sources

    table = catalog.table(pipe.scan.table)
    try:
        _sources, src_ids = enumerate_scan_sources(
            table, snapshot, pipe.scan.prune or None)
    except AttributeError:
        return False
    parts.append(("scan", table.uid, tuple(pipe.scan.columns),
                  tuple((c, op, repr(v)) for (c, op, v) in
                        (pipe.scan.prune or [])),
                  tuple(src_ids)))

    def prog(p):
        if p is None:
            parts.append("-")
            return
        parts.append(p.fingerprint())
        for prm in program_params(p):
            pnames.add(prm.name)

    prog(pipe.pre_program)
    for kind, step in pipe.steps:
        if kind == "join":
            if not _fp_join_step(step, catalog, snapshot, parts, pnames):
                return False
        else:
            prog(step)
    prog(pipe.partial)
    parts.append(tuple(pipe.out_names))
    return True


def _fp_join_step(step, catalog, snapshot, parts: list, pnames: set) -> bool:
    parts.append(("join", step.build_key, step.probe_key, step.kind,
                  tuple(step.payload), step.mark_col, step.not_in,
                  step.anti_null_check, step.anti_null_col,
                  tuple(step.build_hash_keys)))
    return _fp_build(step.build, catalog, snapshot, parts, pnames)


def _fp_build(build, catalog, snapshot, parts: list, pnames: set) -> bool:
    """Fingerprint a JoinStep.build (Pipeline | QueryPlan), recursively."""
    from ydb_tpu_torch.ops.ir import program_params
    from ydb_tpu_torch.query.plan import QueryPlan

    if isinstance(build, QueryPlan):
        # a QueryPlan build executes with its OWN param set (plan.params),
        # so its referenced values hash locally instead of bubbling up
        local: set = set()
        parts.append(("plan", build.limit, build.offset,
                      tuple(build.output),
                      tuple((sk.name, sk.ascending, sk.nulls_first)
                            for sk in build.sort)))
        if build.final_program is not None:
            parts.append(build.final_program.fingerprint())
            for prm in program_params(build.final_program):
                local.add(prm.name)
        else:
            parts.append("-")
        for (pname, subplan) in build.init_subplans:
            parts.append(("init", pname))
            if not _fp_build(subplan, catalog, snapshot, parts, local):
                return False
        if not _fp_pipeline(build.pipeline, catalog, snapshot, parts,
                            local):
            return False
        parts.append(tuple((n, _hash_param_value(build.params[n]))
                           for n in sorted(local) if n in build.params))
        # names the plan does NOT carry resolve from the enclosing params
        for n in local:
            if n not in build.params:
                pnames.add(n)
        return True
    return _fp_pipeline(build, catalog, snapshot, parts, pnames)


def build_plan_fingerprint(step, params: dict, snapshot, catalog,
                           extra: tuple) -> Optional[tuple]:
    """Cache key for one join build, or None when uncacheable."""
    parts: list = []
    pnames: set = set()
    if not _fp_join_step(step, catalog, snapshot, parts, pnames):
        return None
    pvals = tuple((n, _hash_param_value(params[n]))
                  for n in sorted(pnames) if n in params)
    return (tuple(parts), pvals, extra)


def _entry_bytes(bt) -> int:
    from ydb_tpu_torch.ops import join as J
    if isinstance(bt, J.PartitionedBuild):
        return sum(_entry_bytes(t) for t in bt.tables) or (1 << 10)
    total = int(bt.keys_sorted.nbytes)
    for a in bt.payload.values():
        total += int(a.nbytes)
    for a in bt.payload_valid.values():
        total += int(a.nbytes)
    if bt.lut is not None:
        total += int(bt.lut.nbytes)
    fdb = getattr(bt, "fd_block", None)
    if fdb is not None:
        # the retained host block for FD verification pins host RAM for
        # the cache lifetime — it must ride the budget like everything
        # else or a dimension-heavy workload grows RSS past it unseen
        total += sum(int(cd.data.nbytes) for cd in fdb.columns.values())
    return total


class BuildCache:
    def __init__(self, budget_bytes: int, device_cache=None):
        self.budget = budget_bytes
        # shared-HBM coordination: build bytes register as "foreign"
        # bytes in the DeviceColumnCache so the two pools never sum past
        # the device budget (columns evict to make room for builds)
        self.device_cache = device_cache
        self._entries: OrderedDict = OrderedDict()
        # each value: (build_table, nbytes, probe_dict_ref, probe_dict_len)
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self._mu = threading.RLock()

    def lookup(self, key, probe_dict):
        with self._mu:
            ent = self._entries.get(key)
            if ent is None:
                self.misses += 1
                return None
            bt, _nb, pd_ref, pd_len = ent
            # the build key was remapped INTO the probe dictionary: a
            # different dict object (table reloaded) or a grown one
            # (new values inserted) invalidates the remap
            if pd_ref is not probe_dict or \
                    (probe_dict is not None and len(probe_dict) != pd_len):
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return bt

    def insert(self, key, bt, probe_dict) -> None:
        nb = _entry_bytes(bt)
        with self._mu:
            old = self._entries.pop(key, None)
            if old is not None:
                # replace, don't keep: a stale entry here was invalidated
                # by a probe-dictionary change — keeping it would miss
                # forever while pinning the dead build's HBM
                self.bytes -= old[1]
                if self.device_cache is not None:
                    self.device_cache.release_foreign(old[1])
            if nb > self.budget:
                return                    # never cache something unevictable
            self._entries[key] = (bt, nb, probe_dict,
                                  len(probe_dict)
                                  if probe_dict is not None else 0)
            self.bytes += nb
            if self.device_cache is not None:
                self.device_cache.acquire_foreign(nb)
            while self.bytes > self.budget and self._entries:
                _k, (_bt, onb, _pd, _pl) = self._entries.popitem(last=False)
                self.bytes -= onb
                if self.device_cache is not None:
                    self.device_cache.release_foreign(onb)

    def clear(self) -> None:
        with self._mu:
            if self.device_cache is not None:
                self.device_cache.release_foreign(self.bytes)
            self._entries.clear()
            self.bytes = 0
