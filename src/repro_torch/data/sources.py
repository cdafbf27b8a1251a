"""Synthetic data sources.

* ``TrajectorySource`` — T-Drive-like GPS trajectories (the paper's
  dataset is 10,357 Beijing taxis over a week; we synthesize statistically
  similar streams: per-taxi random-walk positions + velocities around city
  clusters, keyed by taxi id so Kafka partitioning matches the original's
  per-taxi ordering).  Drawn with numpy's ``default_rng``, so a seed gives
  the reference package's points exactly.

The token source for training is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Tuple

import numpy as np


@dataclass
class TrajectorySource:
    num_taxis: int = 200
    num_hotspots: int = 8
    city_extent: float = 50.0
    step_sigma: float = 0.5
    seed: int = 0

    def stream(self, total_points: int) -> Iterator[Tuple[str, List[float]]]:
        """Yields (taxi_id, [x, y, vx, vy])."""
        rng = np.random.default_rng(self.seed)
        hotspots = rng.uniform(-self.city_extent, self.city_extent,
                               (self.num_hotspots, 2))
        pos = hotspots[rng.integers(0, self.num_hotspots, self.num_taxis)]
        pos = pos + rng.normal(0, 2.0, (self.num_taxis, 2))
        vel = rng.normal(0, 1.0, (self.num_taxis, 2))
        for i in range(total_points):
            t = i % self.num_taxis
            # pull toward a hotspot + momentum + noise
            target = hotspots[(i // self.num_taxis) % self.num_hotspots]
            vel[t] = 0.9 * vel[t] + 0.05 * (target - pos[t]) + rng.normal(
                0, self.step_sigma, 2
            )
            pos[t] = pos[t] + 0.1 * vel[t]
            yield f"taxi-{t}", [
                float(pos[t, 0]), float(pos[t, 1]),
                float(vel[t, 0]), float(vel[t, 1]),
            ]
