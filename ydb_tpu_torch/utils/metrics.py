"""Process counters of the port.

The reference's ``utils/metrics.py`` also carries histograms, timers and
the per-statement ``QueryStats``; the port needs only the named counter
registry: the copied planner and bounds modules increment it
(``GLOBAL.inc``), the executor counts its bound-sized compactions and
their overflow reruns, its tiled queries and the rows and bytes its
spill merges move to the host (``executor/spilled_rows``,
``executor/spilled_bytes``), and the batched serving lane, memory
admission and the query pipeline read and write their ``batch/*``,
``admission/*`` and ``pipeline/*`` counters (``GLOBAL.get``, ``set``,
``set_max``)."""

from __future__ import annotations

import threading


class Counters:
    def __init__(self):
        self._mu = threading.Lock()
        self._vals: dict = {}

    def inc(self, name: str, by=1) -> None:
        with self._mu:
            self._vals[name] = self._vals.get(name, 0) + by

    def set(self, name: str, value) -> None:
        with self._mu:
            self._vals[name] = value

    def set_max(self, name: str, value) -> None:
        """High-watermark gauge: the largest value ever reported."""
        with self._mu:
            if value > self._vals.get(name, float("-inf")):
                self._vals[name] = value

    def get(self, name: str, default=0):
        with self._mu:
            return self._vals.get(name, default)

    def snapshot(self) -> dict:
        with self._mu:
            return dict(self._vals)


GLOBAL = Counters()
