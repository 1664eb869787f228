"""Process counters of the port.

The reference's ``utils/metrics.py`` also carries histograms, timers and
the per-statement ``QueryStats``; the port's slice needs only the named
counter registry that the copied planner and bounds modules increment
(``GLOBAL.inc``), and that the executor increments for its bound-sized
compactions and their overflow reruns, its tiled queries and the rows
and bytes its spill merges move to the host (``executor/spilled_rows``,
``executor/spilled_bytes``)."""

from __future__ import annotations

import threading


class Counters:
    def __init__(self):
        self._mu = threading.Lock()
        self._vals: dict = {}

    def inc(self, name: str, by=1) -> None:
        with self._mu:
            self._vals[name] = self._vals.get(name, 0) + by

    def get(self, name: str, default=0):
        with self._mu:
            return self._vals.get(name, default)

    def snapshot(self) -> dict:
        with self._mu:
            return dict(self._vals)


GLOBAL = Counters()
