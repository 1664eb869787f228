"""Config system: YAML with selector overrides + feature flags.

The reference boots from a YAML config language with selector/override
blocks resolved per node (`ydb/library/yaml_config` — `selector_config`
entries match node labels and patch the base config) and gates features
behind flags (`ydb/core/base/feature_flags.h`), distributed at runtime by
the Console tablet. Here: one YAML document, the same base + overrides
shape, resolved at engine construction; flags gate real execution paths
(fused single-dispatch, plan cache, background compaction).

    block_rows: 1048576
    grace_budget_bytes: 536870912
    feature_flags:
      enable_fused: true
      enable_plan_cache: true
      enable_auto_compaction: true
    overrides:
      - selector: {env: test}
        config:
          block_rows: 8192

Resolution: every override whose selector is a subset of the supplied
labels applies in order, last writer wins (the reference's rule).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

DEFAULT_FLAGS = {
    "enable_fused": True,           # whole-query single-dispatch path
    "enable_plan_cache": True,
    "enable_auto_compaction": True,  # background portion merging
    "enable_device_windows": True,   # window functions on device
}


@dataclass
class Config:
    block_rows: int = 1 << 20
    grace_budget_bytes: int = 1 << 29
    data_dir: Optional[str] = None
    server_port: int = 2136
    # host fallback lanes (window functions, set-op combine) refuse frames
    # above this many rows — a silent single-core pandas job over a huge
    # frame is a perf trap; raise the limit explicitly to accept it
    host_lane_max_rows: int = 8 << 20
    # frames at or above this many rows take the device window lane
    # (ops/window_dev.py); below it the fixed dispatch+readout cost
    # outweighs the pandas pass. 0 = always device when supported.
    window_device_min_rows: int = 1 << 16
    # auto-split threshold for column shards (rows); 0 = disabled
    shard_split_rows: int = 0
    # concurrent-query pipeline: max SELECTs dispatched but not yet
    # drained (device result buffers held in HBM). 1 = serialize
    # dispatch→readout (the pre-pipeline behavior, a debug lever).
    pipeline_window: int = 4
    feature_flags: dict = field(default_factory=lambda: dict(DEFAULT_FLAGS))

    def flag(self, name: str) -> bool:
        if name not in DEFAULT_FLAGS:
            raise KeyError(f"unknown feature flag {name!r} "
                           f"(have: {', '.join(sorted(DEFAULT_FLAGS))})")
        return bool(self.feature_flags.get(name, DEFAULT_FLAGS[name]))

    @staticmethod
    def from_dict(doc: dict, labels: Optional[dict] = None) -> "Config":
        doc = dict(doc or {})
        labels = labels or {}
        merged = {k: v for k, v in doc.items() if k != "overrides"}
        for ov in doc.get("overrides", []) or []:
            sel = ov.get("selector", {}) or {}
            if all(labels.get(k) == v for k, v in sel.items()):
                patch = ov.get("config", {}) or {}
                for k, v in patch.items():
                    if k == "feature_flags":
                        merged.setdefault("feature_flags", {})
                        merged["feature_flags"] = {
                            **merged.get("feature_flags", {}), **v}
                    else:
                        merged[k] = v
        flags = {**DEFAULT_FLAGS, **(merged.pop("feature_flags", {}) or {})}
        unknown = set(flags) - set(DEFAULT_FLAGS)
        if unknown:
            raise ValueError(f"unknown feature flags: {sorted(unknown)}")
        known = {"block_rows", "grace_budget_bytes", "data_dir",
                 "server_port", "host_lane_max_rows", "shard_split_rows",
                 "window_device_min_rows", "pipeline_window"}
        bad = set(merged) - known
        if bad:
            raise ValueError(f"unknown config keys: {sorted(bad)}")
        return Config(feature_flags=flags, **merged)

    @staticmethod
    def load(path: Optional[str] = None,
             labels: Optional[dict] = None) -> "Config":
        """Load from a YAML file (default: $YDB_TPU_CONFIG if set, else
        built-in defaults)."""
        import yaml
        path = path or os.environ.get("YDB_TPU_CONFIG")
        if path is None:
            return Config()
        with open(path) as f:
            return Config.from_dict(yaml.safe_load(f) or {}, labels)
