"""CRDT-backed telemetry (paper §3.2.2: share state "without bottlenecks
or contention points").

Every worker owns a ``MetricsReplica``; replicas merge at any time, in
any order, any number of times — worker restarts re-merge losslessly and
stragglers' stale replicas never block the hub (contrast with an
all-reduce barrier, which is exactly the contention point the manifesto
forbids for control-plane state).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from repro_torch.core.crdt import GCounter, LWWRegister, PNCounter, merge_all


class MetricsReplica:
    """Per-worker metric set."""

    def __init__(self, worker_id: str) -> None:
        self.worker_id = worker_id
        self.counters: Dict[str, GCounter] = {}
        self.gauges: Dict[str, LWWRegister] = {}
        # Max-register semilattice: merge = elementwise max.  Used for
        # high-watermark style metrics (peak pages in use) where a plain
        # counter cannot express "largest value ever observed".
        self.maxes: Dict[str, float] = {}

    def incr(self, name: str, amount: int = 1) -> None:
        if name not in self.counters:
            self.counters[name] = GCounter(self.worker_id)
        self.counters[name].increment(amount)

    def gauge(self, name: str, value, timestamp: float) -> None:
        reg = self.gauges.get(name, LWWRegister())
        self.gauges[name] = reg.set(value, timestamp, tiebreak=self.worker_id)

    def record_max(self, name: str, value: float) -> None:
        cur = self.maxes.get(name)
        if cur is None or value > cur:
            self.maxes[name] = float(value)

    def peak(self, name: str, default: float = 0.0) -> float:
        return self.maxes.get(name, default)

    def merge(self, other: "MetricsReplica") -> "MetricsReplica":
        out = MetricsReplica(self.worker_id)
        for name in set(self.counters) | set(other.counters):
            mine = self.counters.get(name, GCounter(self.worker_id))
            theirs = other.counters.get(name, GCounter(other.worker_id))
            out.counters[name] = mine.merge(theirs)
        for name in set(self.gauges) | set(other.gauges):
            mine_g = self.gauges.get(name, LWWRegister())
            theirs_g = other.gauges.get(name, LWWRegister())
            out.gauges[name] = mine_g.merge(theirs_g)
        for name in set(self.maxes) | set(other.maxes):
            out.maxes[name] = max(self.maxes.get(name, float("-inf")),
                                  other.maxes.get(name, float("-inf")))
        return out

    def value(self, name: str) -> int:
        return self.counters[name].value() if name in self.counters else 0


class MetricsHub:
    """Aggregation point: merge-only, thread-safe, restart-proof."""

    def __init__(self) -> None:
        self._merged = MetricsReplica("__hub__")
        self._lock = threading.Lock()

    def ingest(self, replica: MetricsReplica) -> None:
        with self._lock:
            self._merged = self._merged.merge(replica)

    def counter(self, name: str) -> int:
        with self._lock:
            return self._merged.value(name)

    def gauge(self, name: str):
        with self._lock:
            reg = self._merged.gauges.get(name)
            return None if reg is None else reg.value

    def peak(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            return self._merged.peak(name, default)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {k: v.value() for k, v in self._merged.counters.items()}
