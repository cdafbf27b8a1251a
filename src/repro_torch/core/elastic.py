"""Elastic worker service (paper §3.2.2).

"The elastic worker service monitors the message queue of the workers to
estimate the workload. When the workload exceeds the agreed upper and
lower limit, the service changes the number of the instances to fit the
workload."

The autoscaler is a pure policy object: feed it queue depths + time, it
returns a scaling decision.  Actuation (spawning/draining tasks, or at
framework scale re-meshing the DP axis) is the caller's job, which keeps the
policy unit-testable and reusable across the simulator, the thread
runtime, and the training launcher.

Also here: straggler detection (workers whose service rate falls k·MAD
below the pool median get their backlog stolen) — required for
1000+-node deployments where slow-but-alive nodes hurt more than dead
ones.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence


@dataclass(frozen=True)
class ScalingDecision:
    """delta > 0 scale out, delta < 0 scale in, 0 hold."""

    delta: int
    reason: str
    backlog_per_worker: float

    @property
    def action(self) -> str:
        return "scale_out" if self.delta > 0 else ("scale_in" if self.delta < 0 else "hold")


@dataclass
class AutoscalerConfig:
    high_watermark: float = 32.0   # backlog/worker above which we scale out
    low_watermark: float = 2.0     # backlog/worker below which we scale in
    min_workers: int = 1
    max_workers: int = 4096
    cooldown: float = 5.0          # seconds between decisions
    step_fraction: float = 0.5     # scale by ±ceil(step_fraction * workers)
    max_step: int = 256


class QueueDepthAutoscaler:
    """Hysteresis autoscaler over aggregate mailbox depth."""

    def __init__(self, config: Optional[AutoscalerConfig] = None) -> None:
        self.config = config or AutoscalerConfig()
        self.last_decision_at = float("-inf")
        self.decisions: List[tuple] = []  # (time, decision) audit log

    def decide(self, depths: Sequence[int], now: float) -> ScalingDecision:
        cfg = self.config
        n = max(len(depths), 1)
        per_worker = sum(depths) / n
        if now - self.last_decision_at < cfg.cooldown:
            return ScalingDecision(0, "cooldown", per_worker)

        decision = ScalingDecision(0, "within_watermarks", per_worker)
        if per_worker > cfg.high_watermark and n < cfg.max_workers:
            step = min(max(1, int(n * cfg.step_fraction)), cfg.max_step, cfg.max_workers - n)
            decision = ScalingDecision(step, "backlog_above_high_watermark", per_worker)
        elif per_worker < cfg.low_watermark and n > cfg.min_workers:
            step = min(max(1, int(n * cfg.step_fraction)), cfg.max_step, n - cfg.min_workers)
            decision = ScalingDecision(-step, "backlog_below_low_watermark", per_worker)

        if decision.delta != 0:
            self.last_decision_at = now
            self.decisions.append((now, decision))
        return decision


def split_units(units: int, slots_per_replica: int) -> List[int]:
    """Distribute a slot-unit budget over the fewest replicas that hold it.

    The serving pool's elasticity currency is *decode slots*, not whole
    replicas: the autoscaler targets a unit count, and this maps it to
    per-replica occupancy caps — fill one replica before spawning the next
    (a fuller batch amortizes the decode step better than two half-empty
    replicas).

    >>> split_units(5, 4)
    [4, 1]
    """
    units = max(int(units), 1)
    slots = max(int(slots_per_replica), 1)
    full, rem = divmod(units, slots)
    return [slots] * full + ([rem] if rem else [])


@dataclass(frozen=True)
class StragglerReport:
    straggler_ids: tuple
    median_rate: float
    rates: tuple


def detect_stragglers(
    rates: Dict[str, float],
    k: float = 3.0,
    min_rate_floor: float = 1e-12,
) -> StragglerReport:
    """Flag workers whose service rate is k·MAD below the pool median.

    MAD (median absolute deviation) rather than stddev: robust when the
    stragglers themselves would inflate a stddev estimate.
    """
    if len(rates) < 3:
        return StragglerReport((), 0.0, tuple(rates.values()))
    values = list(rates.values())
    med = statistics.median(values)
    mad = statistics.median([abs(v - med) for v in values])
    # With zero spread, fall back to a relative cutoff.
    cutoff = med - k * mad if mad > 0 else med * 0.5
    stragglers = tuple(
        sorted(w for w, r in rates.items() if r < max(cutoff, min_rate_floor))
    )
    return StragglerReport(stragglers, med, tuple(values))


class WorkerPoolController:
    """Glue: autoscaler + straggler detector over a named worker pool.

    Used by the reactive pipeline (task pools, virtual producer pools) and
    by the training launcher (elastic DP).  ``target_size`` tracks the
    desired instance count; the owner reconciles actual instances toward
    it.
    """

    def __init__(
        self,
        initial_size: int,
        config: Optional[AutoscalerConfig] = None,
        straggler_k: float = 3.0,
    ) -> None:
        self.autoscaler = QueueDepthAutoscaler(config)
        self.target_size = initial_size
        self.straggler_k = straggler_k
        self.scale_events: List[tuple] = []

    def observe(
        self,
        depths: Sequence[int],
        rates: Optional[Dict[str, float]] = None,
        now: float = 0.0,
    ) -> tuple[ScalingDecision, StragglerReport]:
        decision = self.autoscaler.decide(depths, now)
        cfg = self.autoscaler.config
        if decision.delta != 0:
            self.target_size = min(
                max(self.target_size + decision.delta, cfg.min_workers), cfg.max_workers
            )
            self.scale_events.append((now, self.target_size, decision.reason))
        report = detect_stragglers(rates or {}, k=self.straggler_k)
        return decision, report
