"""TCMM incremental trajectory clustering (Li, Lee, Li & Han 2010) — the
paper's §4 evaluation workload, with its state on the device.

Two jobs, exactly as the paper wires them (§4.1):

  * **micro-clustering job** — consumes trajectory points from a topic;
    each point merges with the nearest micro-cluster within the distance
    threshold (cluster-feature-vector update) or spawns a new
    micro-cluster; publishes micro-cluster *change events* (event
    sourcing) to a topic.
  * **macro-clustering job** — consumes the change events, periodically
    re-clusters micro-cluster centroids with k-means and publishes macro
    cluster changes.

The nearest-micro-cluster search is the measured hot spot ("the
micro-clusters size grows over time and decelerates the
micro-clustering"); it runs on the ``tcmm_assign`` CUDA kernel on the
card, its plain version on the CPU.

Ingest stays sequential: each event changes the table that the next point
searches.  The cluster-feature vectors (n, LS, SS) live on ``device``, so
one ingest moves the point in, launches the search, reads (index, d2)
back in one copy, and applies the event on the device; the host chooses
the event from the index.  Event payloads are the host's f32 point
(``point.tolist()``) and SS adds ``float(p @ p)`` computed with numpy, as
the reference package does, so the state stays bit-equal to its.

Device: every entry point defaults to ``"cuda"`` and raises without it;
the CPU runs only when the caller passes ``device="cpu"``, and then the
search takes the kernel's plain version.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.tcmm import TCMMConfig
from repro_torch.core.messages import Message
from repro_torch.kernels.tcmm_assign import ops as assign_ops
from repro_torch.kernels.tcmm_assign.ref import squared_distances
from repro_torch.models.zoo import resolve_device

Device = Union[str, torch.device]


class MicroClusterState:
    """Cluster-feature vectors: CF = (n, LS, SS) per micro-cluster, as f32
    tensors on ``device``; ``num_active`` and ``processed`` are host ints."""

    def __init__(self, cfg: TCMMConfig, device: Device = "cuda") -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        m, f = cfg.max_micro_clusters, cfg.feature_dim
        self.n = torch.zeros((m,), dtype=torch.float32, device=self.device)
        self.ls = torch.zeros((m, f), dtype=torch.float32, device=self.device)
        self.ss = torch.zeros((m,), dtype=torch.float32, device=self.device)
        self.num_active = 0
        self.processed = 0

    # -- carried across from / to the reference package's numpy state -------
    @classmethod
    def from_numpy(cls, cfg: TCMMConfig, n: np.ndarray, ls: np.ndarray, ss: np.ndarray,
                   num_active: int, processed: int,
                   device: Device = "cuda") -> "MicroClusterState":
        st = cls(cfg, device=device)
        for dst, src in ((st.n, n), (st.ls, ls), (st.ss, ss)):
            dst.copy_(torch.from_numpy(np.asarray(src, dtype=np.float32)))
        st.num_active, st.processed = int(num_active), int(processed)
        return st

    def to_numpy(self) -> Dict[str, Any]:
        """The state as ``from_numpy`` takes it (and as the reference
        package's ``MicroClusterState`` holds it)."""
        return dict(n=self.n.cpu().numpy(), ls=self.ls.cpu().numpy(),
                    ss=self.ss.cpu().numpy(), num_active=self.num_active,
                    processed=self.processed)

    def centroids(self) -> torch.Tensor:
        return self.ls / torch.clamp(self.n, min=1.0)[:, None]

    def valid(self) -> torch.Tensor:
        return self.n > 0

    # -- event sourcing -----------------------------------------------------
    def _apply(self, kind: str, i: int, p_host: np.ndarray, p_dev: torch.Tensor) -> None:
        sq = float(p_host @ p_host)
        if kind == "new":
            self.n[i].fill_(1.0)
            self.ls[i].copy_(p_dev)
            self.ss[i].fill_(sq)
            self.num_active = max(self.num_active, i + 1)
        else:
            self.n[i].add_(1.0)
            self.ls[i].add_(p_dev)
            self.ss[i].add_(sq)
        self.processed += 1

    def apply_event(self, ev: Dict[str, Any]) -> None:
        """Events: {"kind": "merge"|"new", "cluster": i, "point": [...]}"""
        p = np.asarray(ev["point"], dtype=np.float32)
        self._apply(ev["kind"], ev["cluster"], p, torch.from_numpy(p).to(self.device))

    def ingest(self, point: np.ndarray) -> Dict[str, Any]:
        """Assign a point; returns the change event (already applied)."""
        point = np.asarray(point, dtype=np.float32)
        p_dev = torch.from_numpy(point).to(self.device)
        if self.num_active == 0:
            ev = {"kind": "new", "cluster": 0, "point": point.tolist()}
            self._apply("new", 0, point, p_dev)
            return ev
        idx, d2 = assign_ops.tcmm_assign(p_dev[None], self.centroids(), self.valid())
        pair = torch.stack((idx, d2.view(torch.int32))).cpu()  # one copy back
        i, dist2 = int(pair[0, 0]), float(pair[1].view(torch.float32)[0])
        if dist2 <= self.cfg.distance_threshold ** 2:
            kind = "merge"
        elif self.num_active < self.cfg.max_micro_clusters:
            kind, i = "new", self.num_active
        else:
            kind = "merge"
        ev = {"kind": kind, "cluster": i, "point": point.tolist()}
        self._apply(kind, i, point, p_dev)
        return ev

    @staticmethod
    def replay(cfg: TCMMConfig, events: List[Dict[str, Any]],
               device: Device = "cuda") -> "MicroClusterState":
        st = MicroClusterState(cfg, device=device)
        for ev in events:
            st.apply_event(ev)
        return st


class MicroClusterJob:
    """Processing callable for the micro-clustering job: point message ->
    [change event payloads]. Stateful; state is event-sourced by design
    (its outputs ARE its change log)."""

    def __init__(self, cfg: TCMMConfig, device: Device = "cuda") -> None:
        self.state = MicroClusterState(cfg, device=device)

    def __call__(self, msg: Message) -> List[Any]:
        return [self.state.ingest(np.asarray(msg.payload, dtype=np.float32))]


def kmeans_init(weights: torch.Tensor, k: int, seed: int) -> torch.Tensor:
    """k distinct start indices drawn with probability ``weights / sum``
    from a seeded generator on the host (so the card and the CPU draw the
    same).  The reference package draws them with ``jax.random.choice``,
    which torch cannot reproduce; its parity tests replace this function
    by one that returns JAX's draw."""
    gen = torch.Generator().manual_seed(seed)
    w = weights.detach().to("cpu", torch.float64)
    return torch.multinomial(w / w.sum(), k, replacement=False, generator=gen).to(weights.device)


def kmeans(
    centroids: torch.Tensor,  # [M, F] micro centroids
    weights: torch.Tensor,    # [M] micro cluster sizes
    k: int,
    iters: int,
    seed: int = 0,
    init_idx: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted k-means over micro-cluster centroids (macro step).  Returns
    (centres [k, F], assignment [M]); as in the reference, the assignment
    is the one against the centres *before* the last update.  Distances
    are summed in the fixed order of ``squared_distances``; a centre with
    no weight keeps its old value."""
    if init_idx is None:
        init_idx = kmeans_init(weights, k, seed)
    centers = centroids[init_idx]
    assign = torch.zeros((centroids.shape[0],), dtype=torch.int64, device=centroids.device)
    for _ in range(iters):
        assign = torch.argmin(squared_distances(centroids, centers), dim=1)
        onehot = torch.nn.functional.one_hot(assign, k).to(centroids.dtype) * weights[:, None]
        totals = onehot.sum(dim=0)  # [k]
        sums = onehot.T @ centroids  # [k, F]
        centers = torch.where(totals[:, None] > 0,
                              sums / torch.clamp(totals[:, None], min=1e-9), centers)
    return centers, assign


class MacroClusterJob:
    """Processing callable for the macro-clustering job: consumes micro
    change events, maintains a replica of the micro state by replay, and
    every ``macro_period`` events recomputes macro clusters."""

    def __init__(self, cfg: TCMMConfig, device: Device = "cuda") -> None:
        self.cfg = cfg
        self.replica = MicroClusterState(cfg, device=device)
        self.macro_centers: Optional[np.ndarray] = None
        self.macro_runs = 0

    def __call__(self, msg: Message) -> List[Any]:
        self.replica.apply_event(msg.payload)
        if self.replica.processed % self.cfg.macro_period == 0:
            valid = self.replica.valid()
            if int(valid.sum()) >= self.cfg.num_macro_clusters:
                centers, _ = kmeans(
                    self.replica.centroids()[valid],
                    self.replica.n[valid],
                    self.cfg.num_macro_clusters,
                    self.cfg.kmeans_iters,
                    seed=self.cfg.seed,
                )
                self.macro_centers = centers.cpu().numpy()
                self.macro_runs += 1
                return [{"kind": "macro", "centers": self.macro_centers.tolist()}]
        return []
