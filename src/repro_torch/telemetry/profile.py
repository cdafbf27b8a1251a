"""Lightweight control-plane profiling (the vectorized-dispatch
refactor's observability satellite).

``StepTimer`` accumulates per-name wall-time and call counts — the
"where do the step() milliseconds go" question that previously required
ad-hoc instrumentation every time.  It is pure bookkeeping: nothing in
the control plane *reads* it, so wiring one in (``StageGraph(...,
timer=...)``) cannot change behavior, and leaving it out costs nothing.

Dispatch *batch-size* telemetry lives in the pool's own CRDT counters
(``<prefix>.dispatched`` / ``<prefix>.dispatch_rounds``, see
``core.pool``): their ratio is the realized batch size per dispatch
round, mergeable across restarts like every other pool counter.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable, Dict, Iterator


class StepTimer:
    """Named wall-time accumulator.

    >>> timer = StepTimer()
    >>> with timer.time("stage-a"):
    ...     pass
    >>> timer.snapshot()["stage-a"]["calls"]
    1

    ``clock`` is injectable for tests (defaults to
    ``time.perf_counter``).
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter) -> None:
        self._clock = clock
        self.totals: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}

    @contextmanager
    def time(self, name: str) -> Iterator[None]:
        t0 = self._clock()
        try:
            yield
        finally:
            elapsed = self._clock() - t0
            self.totals[name] = self.totals.get(name, 0.0) + elapsed
            self.calls[name] = self.calls.get(name, 0) + 1

    def add(self, name: str, seconds: float) -> None:
        """Record an externally-measured span (callers that cannot use
        the context manager, e.g. across a yield point)."""
        self.totals[name] = self.totals.get(name, 0.0) + seconds
        self.calls[name] = self.calls.get(name, 0) + 1

    def total(self, name: str) -> float:
        return self.totals.get(name, 0.0)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """``{name: {"total_s": ..., "calls": ..., "mean_s": ...}}``,
        sorted by descending total."""
        out: Dict[str, Dict[str, float]] = {}
        for name in sorted(self.totals, key=lambda k: -self.totals[k]):
            calls = self.calls.get(name, 0)
            total = self.totals[name]
            out[name] = {
                "total_s": total,
                "calls": calls,
                "mean_s": total / calls if calls else 0.0,
            }
        return out

    def reset(self) -> None:
        self.totals.clear()
        self.calls.clear()
