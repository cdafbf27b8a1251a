"""Supervision service (paper §2.2, §3.2.2).

Delegation: "the responsibility of recovering a failed component will be
delegated to a healthy component called Supervisor".  Recovery is two
stages — detect, then restart (Let-It-Crash): never repair a component in
place; restart it and let it recover its state from the event journal.

Failure detection implements both mechanisms the paper cites:

  * ``HeartbeatDetector`` — fixed timeout on the last heartbeat
    (Aguilera, Chen & Toueg 1997).
  * ``PhiAccrualDetector`` — the φ accrual detector (Hayashibara et al.
    2004): instead of a boolean, output a suspicion level
    φ(t) = -log10 P(heartbeat arrives after t | history) from a normal
    model of inter-arrival times, and declare failure at a φ threshold.
    Adaptive to jittery links, which is what makes it the right choice at
    1000+ nodes where fixed timeouts either false-positive under load or
    detect too slowly.

The supervisor is deliberately clock-agnostic: callers feed it the current
time, so the same code runs under the discrete-event simulator and under
a wall clock.
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional


class FailureDetector:
    def observe(self, now: float) -> None:
        raise NotImplementedError

    def suspect(self, now: float) -> bool:
        raise NotImplementedError


class HeartbeatDetector(FailureDetector):
    """Boolean timeout detector."""

    def __init__(self, timeout: float) -> None:
        self.timeout = timeout
        self.last_beat: Optional[float] = None

    def observe(self, now: float) -> None:
        self.last_beat = now

    def suspect(self, now: float) -> bool:
        if self.last_beat is None:
            return False
        return (now - self.last_beat) > self.timeout


class PhiAccrualDetector(FailureDetector):
    """φ accrual failure detector over a sliding window of inter-arrivals."""

    def __init__(
        self,
        threshold: float = 8.0,
        window: int = 64,
        min_std: float = 0.15,  # floor at 15% of mean: perfectly steady beats
        # otherwise make the normal model razor-thin and φ explodes on the
        # first half-interval of lateness (Akka uses a similar floor).
        bootstrap_interval: float = 1.0,
    ) -> None:
        self.threshold = threshold
        self.window = window
        self.min_std = min_std
        self.bootstrap_interval = bootstrap_interval
        self.last_beat: Optional[float] = None
        self.intervals: Deque[float] = deque(maxlen=window)

    def observe(self, now: float) -> None:
        if self.last_beat is not None:
            self.intervals.append(max(now - self.last_beat, 1e-9))
        self.last_beat = now

    def phi(self, now: float) -> float:
        if self.last_beat is None:
            return 0.0
        if self.intervals:
            mean = sum(self.intervals) / len(self.intervals)
            var = sum((x - mean) ** 2 for x in self.intervals) / len(self.intervals)
            std = max(math.sqrt(var), self.min_std * mean, 1e-9)
        else:
            mean, std = self.bootstrap_interval, self.min_std
        dt = now - self.last_beat
        # P(X > dt) under N(mean, std); complementary CDF via erfc.
        z = (dt - mean) / (std * math.sqrt(2.0))
        p_later = 0.5 * math.erfc(z)
        p_later = max(p_later, 1e-300)
        return -math.log10(p_later)

    def suspect(self, now: float) -> bool:
        return self.phi(now) > self.threshold


@dataclass
class SupervisedChild:
    name: str
    detector: FailureDetector
    # Let-It-Crash restart hook.  Returning ``False`` (exactly) means the
    # restart could not be performed yet (e.g. nowhere to relocate to):
    # the supervisor defers — no "restarted" event, no budget burned —
    # and retries after the next detection window.
    restart: Callable[[], "None | bool"]
    max_restarts: int = 1_000_000
    restarts: int = 0
    alive: bool = True
    last_restart_at: float = 0.0


class Supervisor:
    """One-for-one supervisor: each child restarts independently.

    ``check`` is invoked periodically (by the simulator tick or runtime
    thread); for each child whose detector suspects failure, the child is
    marked dead and its restart hook is fired.  Restart hooks are expected
    to re-register mailboxes and rebuild state via event-sourcing replay
    (see ``EventSourcedState``) — the supervisor itself is stateless
    beyond restart counts, which keeps it trivially replaceable (it can
    itself be supervised).
    """

    def __init__(self, name: str = "supervisor", restart_backoff: float = 0.0) -> None:
        self.name = name
        self.restart_backoff = restart_backoff
        self.children: Dict[str, SupervisedChild] = {}
        self.events: List[tuple] = []  # (time, kind, child) audit trail

    def supervise(
        self,
        name: str,
        restart: Callable[[], None],
        detector: Optional[FailureDetector] = None,
        max_restarts: int = 1_000_000,
    ) -> SupervisedChild:
        child = SupervisedChild(
            name=name,
            detector=detector or PhiAccrualDetector(),
            restart=restart,
            max_restarts=max_restarts,
        )
        self.children[name] = child
        return child

    def unsupervise(self, name: str) -> None:
        self.children.pop(name, None)

    def heartbeat(self, name: str, now: float) -> None:
        child = self.children.get(name)
        if child is not None:
            child.detector.observe(now)
            if not child.alive:
                # A beat from a child we thought dead — it recovered.
                child.alive = True
                self.events.append((now, "recovered", name))

    def check(self, now: float) -> List[str]:
        """Detect + restart. Returns names restarted this check."""
        restarted: List[str] = []
        # restart hooks may (un)supervise children: iterate over a copy
        for child in list(self.children.values()):
            if not child.alive:
                continue
            if child.detector.suspect(now):
                self.events.append((now, "suspected", child.name))
                child.alive = False
                if child.restarts >= child.max_restarts:
                    self.events.append((now, "gave_up", child.name))
                    continue
                if now - child.last_restart_at < self.restart_backoff:
                    continue
                result = child.restart()
                child.alive = True
                child.detector.observe(now)  # (re)arm the detector
                if result is False:
                    # The hook declined — e.g. no healthy node to
                    # relocate onto.  Not a heal: don't count it, don't
                    # burn the restart budget; the re-armed detector
                    # re-suspects after another window and we retry.
                    self.events.append((now, "restart_deferred", child.name))
                    continue
                child.restarts += 1
                child.last_restart_at = now
                self.events.append((now, "restarted", child.name))
                restarted.append(child.name)
        return restarted

    def alive_children(self) -> List[str]:
        return [c.name for c in self.children.values() if c.alive]
