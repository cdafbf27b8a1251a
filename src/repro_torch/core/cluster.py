"""The cluster/placement layer: nodes, placement, failure injection.

This used to be a private model inside ``core.simulation`` — which meant
the paper's §4 figures exercised a *re-statement* of the control loop,
not the live ``ElasticPool`` actuator.  It is now a first-class reactive
service shared by every tier: the live pool places workers on ``Node``s,
dilates their step costs by co-residency and node speed, silences every
resident worker when a node goes down, and relocates failed components
to the healthiest live node (``core.pool``); the virtual-clock driver
(``core.runtime.VirtualRuntime``) and the launch demos inject failures
through the same ``FailureInjector``.

Fleet scale.  The layer is sized for 1000-node sweeps:

  * residency is a ``name -> Node`` index (``_owner``) on *both* paths —
    ``assign``/``release``/``node_of``/``total_residents`` are O(1); the
    old full-fleet scans survive only as :meth:`Cluster.audit`, a debug
    assertion the property tests run after every operation;
  * ``vectorize=True`` (default) adds an O(log n) least-loaded-healthiest
    placement heap with lazy invalidation — the exact shape of the pool's
    ``ReadyWorkerHeap``: every up node always has at least one heap entry
    whose recorded load is <= its live load (loads only *decrease* stale,
    never increase stale, because every decrease pushes a fresh entry),
    stale entries are corrected at pop, down nodes are skipped-and-
    dropped, restores push a fresh entry, and the heap compacts at
    ``8n + 64`` entries.  ``vectorize=False`` keeps the linear-scan
    reference; the two are bitwise-equivalent (same node, same tie-break)
    and property-tested against each other;
  * ``Node.dilation()`` is cached and invalidated on residency/speed
    change, so metered pools stop recomputing it per worker per tick;
  * ``fail_many``/``restore_many`` batch whole-domain outages into one
    bookkeeping pass (one ``topology_version`` bump per restore batch).

Chaos at fleet scale.  ``FailureInjector`` draws from **counter-based
per-node RNG streams**: the u-value for (node, interval) is a pure
splitmix64 hash of ``(seed, stream_id, interval_index)``, so a node's
failure sequence is invariant to fleet size, to iteration order, and to
which other chaos processes are enabled — and the vectorized numpy draw
is bitwise-identical to the scalar one.  A ``Topology`` (node -> rack ->
zone) enables rack/zone-correlated failure bursts and zone-wide network
partitions (a partitioned node is indistinguishable from a down node to
the control plane — the symmetric-partition model); ``Node.speed`` ramps
model gray failures (the node is *up* but slow; only symptom-based
straggler detection in the pool can see it).  All restores within a tick
coalesce into one heap event per distinct delay, so a 1000-node fleet
never schedules 1000 same-tick closures.

Invariants (property-tested in ``tests/test_cluster.py`` /
``tests/test_fleet.py``):

  * residency conservation — every placed component is a resident of
    exactly one node, across arbitrary fail/restart/relocate sequences,
    and the index agrees with the per-node sets (:meth:`Cluster.audit`);
  * down-node quiescence — once the supervisor has had a detection
    window with a healthy node available, no *active* component remains
    placed on a down node;
  * epoch monotonicity — ``Node.epoch`` bumps on every failure and a
    restore carrying a stale epoch is a no-op, so delayed restart events
    can never resurrect a node (or the workers on it) that failed again
    in the meantime;
  * scalar/vectorized equivalence — placement choices, dilations,
    epochs, and failure draws match bitwise between the two paths.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Counter-based RNG streams (splitmix64 finalizer).
#
# The determinism contract: ``stream_uniform(seed, stream, k)`` is a pure
# function — no state, no consumption order — so node 17's draw at
# interval 42 is the same whether the fleet has 20 nodes or 1000, whether
# gray injection is enabled, and whether the draw happens in a python
# loop or one numpy shot.  Stream ids are namespaced per chaos process so
# enabling one process never perturbs another's sequence.
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1
_PHI = 0x9E3779B97F4A7C15          # 2^64 / golden ratio
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB

# Stream-id namespaces (kind << 40 leaves room for 2^40 entities each).
STREAM_NODE = 0 << 40        # independent per-node failures
STREAM_RACK = 1 << 40        # rack-correlated bursts
STREAM_ZONE = 2 << 40        # zone-correlated bursts
STREAM_GRAY = 3 << 40        # gray-failure (slow node) ramps
STREAM_PARTITION = 4 << 40   # zone network partitions


def _mix64(x: int) -> int:
    """splitmix64 finalizer on 64-bit ints (scalar reference)."""
    x &= _M64
    x = ((x ^ (x >> 30)) * _MIX1) & _M64
    x = ((x ^ (x >> 27)) * _MIX2) & _M64
    return (x ^ (x >> 31)) & _M64


def _mix64_np(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer on uint64 arrays — bitwise equal to
    :func:`_mix64` elementwise (multiplication wraps mod 2^64)."""
    x = (x ^ (x >> np.uint64(30))) * np.uint64(_MIX1)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(_MIX2)
    return x ^ (x >> np.uint64(31))


def stream_uniform(seed: int, stream: int, k: int) -> float:
    """U[0,1) as a pure function of ``(seed, stream, k)``."""
    h = _mix64((seed & _M64) ^ _PHI)
    h = _mix64(h ^ ((stream * _PHI) & _M64))
    h = _mix64(h ^ ((k * _MIX1) & _M64))
    return (h >> 11) * (2.0 ** -53)


def stream_uniform_array(seed: int, streams: np.ndarray, k: int) -> np.ndarray:
    """Vectorized :func:`stream_uniform` over a uint64 stream-id array.

    Bitwise-identical to the scalar version: same hash chain, and the
    final float is an exact conversion of a 53-bit integer either way.
    """
    h0 = _mix64((seed & _M64) ^ _PHI)
    kc = np.uint64((k * _MIX1) & _M64)
    with np.errstate(over="ignore"):
        x = np.uint64(h0) ^ (streams * np.uint64(_PHI))
        x = _mix64_np(x)
        x = _mix64_np(x ^ kc)
    return (x >> np.uint64(11)).astype(np.float64) * (2.0 ** -53)


# ---------------------------------------------------------------------------
# Topology: node -> rack -> zone failure domains.
# ---------------------------------------------------------------------------


class Topology:
    """Failure-domain layout: contiguous racks of nodes, contiguous
    zones of racks.  Correlated chaos (bursts, partitions) draws per
    *domain*, then takes down every member — the realistic failure
    regime the stream-processing evolution survey identifies (top-of-
    rack switch loss, zone-wide network partition)."""

    def __init__(self, num_nodes: int, nodes_per_rack: int = 8,
                 racks_per_zone: int = 4) -> None:
        if nodes_per_rack < 1 or racks_per_zone < 1:
            raise ValueError("topology domains must be >= 1 node/rack")
        self.num_nodes = num_nodes
        self.nodes_per_rack = nodes_per_rack
        self.racks_per_zone = racks_per_zone
        self.num_racks = max(1, -(-num_nodes // nodes_per_rack))
        self.num_zones = max(1, -(-self.num_racks // racks_per_zone))

    def rack_of(self, node_id: int) -> int:
        return node_id // self.nodes_per_rack

    def zone_of(self, node_id: int) -> int:
        return self.rack_of(node_id) // self.racks_per_zone

    def rack_members(self, rack: int) -> range:
        lo = rack * self.nodes_per_rack
        return range(lo, min(lo + self.nodes_per_rack, self.num_nodes))

    def zone_members(self, zone: int) -> range:
        per_zone = self.racks_per_zone * self.nodes_per_rack
        lo = zone * per_zone
        return range(lo, min(lo + per_zone, self.num_nodes))


# ---------------------------------------------------------------------------
# Nodes and the cluster.
# ---------------------------------------------------------------------------


@dataclass
class Node:
    """One machine: a core budget, a speed, and a liveness epoch."""

    node_id: int
    cores: int = 2
    speed: float = 1.0      # heterogeneity: <1 = straggler node
    up: bool = True
    epoch: int = 0          # bumps on every failure; stale events check it
    residents: Set[str] = field(default_factory=set)
    # Cost-weighted residency load: the sum of the placement weights of
    # every resident (default weight 1.0, so for unweighted callers this
    # is exactly ``len(residents)`` and placement decisions are bitwise
    # unchanged).  Mutated only through Cluster.assign/release.
    load: float = 0.0
    # Cached dilation; None = dirty.  Invalidated by Cluster on every
    # residency or speed change (mutate residents/speed only through the
    # Cluster so the cache — and the placement heap — stay coherent).
    _dil: Optional[float] = field(default=None, repr=False, compare=False)

    @property
    def resident(self) -> int:  # back-compat: the old SimNode counter
        return len(self.residents)

    def dilation(self) -> float:
        """Per-message processing dilation on this node: more runnable
        components than cores time-share (``resident/cores``), and a
        slow node stretches everything by ``1/speed``."""
        d = self._dil
        if d is None:
            d = max(len(self.residents) / max(self.cores, 1), 1.0) / self.speed
            self._dil = d
        return d


class Cluster:
    """A set of nodes plus the placement policy.

    Placement is least-loaded-healthiest: among up nodes, the lowest
    *cost-weighted* residency load (ties broken by node id —
    deterministic).  Every resident carries a placement weight (default
    1.0, in which case the load is simply the resident count and the
    policy is the classic fewest-residents scan, bit-for-bit).  Weighted
    residency is what lets a multi-tenant fleet bin-pack: a 1B-model
    replica (weight ~t_p ratio) co-locates beside a 104B replica instead
    of each claiming a whole node — see ``serving.fleet``.  Residency is
    tracked by component *name* so conservation is checkable; components
    that are deliberately weightless (virtual consumers: consume-and-
    forward is "much simpler than processing a message", paper §3.1) may
    ``place()`` without ``assign()`` and never count toward dilation.

    ``vectorize=True`` (default) serves placement from an O(log n)
    lazy-invalidation heap; ``vectorize=False`` is the linear-scan
    bitwise reference (see module docstring for the invariant).
    """

    def __init__(self, num_nodes: int, cores: int = 2,
                 speeds: Optional[List[float]] = None,
                 topology: Optional[Topology] = None,
                 vectorize: bool = True) -> None:
        self.nodes = [
            Node(i, cores=cores, speed=(speeds[i] if speeds else 1.0))
            for i in range(num_nodes)
        ]
        if topology is not None and topology.num_nodes != num_nodes:
            raise ValueError(
                f"topology sized for {topology.num_nodes} nodes, "
                f"cluster has {num_nodes}"
            )
        self.topology = topology
        self.vectorize = bool(vectorize)
        # Bumps on every node recovery: pools watch it to rebalance onto
        # freshly healed capacity (otherwise it would sit idle forever).
        self.topology_version = 0
        self.failures = 0
        # Residency index — the source of truth; per-node sets are the
        # derived view (audit() asserts they agree).
        self._owner: Dict[str, Node] = {}
        # Per-component placement weights (default 1.0 = the unweighted
        # resident-count policy).  Kept separate from the per-node load
        # sums so audit() can recompute and cross-check.
        self._weights: Dict[str, float] = {}
        # Placement heap: (recorded_load, node_id), lazily invalidated.
        self._heap: Optional[List[Tuple[float, int]]] = (
            [(0.0, i) for i in range(num_nodes)] if self.vectorize else None
        )

    # -- placement-heap bookkeeping ------------------------------------------
    def _push(self, node: Node) -> None:
        """Re-arm ``node``'s heap entry after a load *decrease* or a
        restore (increases leave the recorded<=live invariant intact)."""
        heap = self._heap
        if heap is None:
            return
        heapq.heappush(heap, (node.load, node.node_id))
        if len(heap) > 8 * len(self.nodes) + 64:
            self._heap = [
                (n.load, n.node_id) for n in self.nodes if n.up
            ]
            heapq.heapify(self._heap)

    # -- views ---------------------------------------------------------------
    def healthy(self) -> List[Node]:
        return [n for n in self.nodes if n.up]

    def least_loaded(self, exclude: Optional[Set[int]] = None) -> Optional[Node]:
        """Healthiest-least-loaded node, or ``None`` if the whole fleet
        is down.  ``exclude`` (rare path: straggler quarantine) always
        takes the scan so the heap is untouched."""
        if self._heap is None or exclude:
            live = [
                n for n in self.nodes
                if n.up and (not exclude or n.node_id not in exclude)
            ]
            if not live:
                return None
            return min(live, key=lambda n: (n.load, n.node_id))
        heap = self._heap
        while heap:
            load, nid = heap[0]
            node = self.nodes[nid]
            if not node.up:
                heapq.heappop(heap)
                continue
            if load == node.load:
                return node
            heapq.heapreplace(heap, (node.load, nid))
        return None

    # The placement policy by its contract name.
    place = least_loaded

    def total_residents(self) -> int:
        return len(self._owner)

    # -- residency ------------------------------------------------------------
    def assign(self, node: Node, name: str, weight: float = 1.0) -> None:
        """Make ``name`` resident on ``node`` (and nowhere else), carrying
        ``weight`` units of placement load (the cost-weighted packing
        knob: a cheap tenant's replica weighs less than an expensive
        one's, so least-loaded placement bin-packs them together)."""
        old = self._owner.get(name)
        w_old = self._weights.get(name, 1.0)
        if old is node and weight == w_old and name in self._weights:
            return
        if old is not None:
            old.residents.discard(name)
            old.load = old.load - w_old if old.residents else 0.0
            old._dil = None
            self._push(old)
        self._owner[name] = node
        self._weights[name] = float(weight)
        node.residents.add(name)
        node.load += float(weight)
        node._dil = None

    def release(self, name: str) -> None:
        node = self._owner.pop(name, None)
        if node is not None:
            w = self._weights.pop(name, 1.0)
            node.residents.discard(name)
            node.load = node.load - w if node.residents else 0.0
            node._dil = None
            self._push(node)

    def weight_of(self, name: str) -> float:
        return self._weights.get(name, 1.0)

    def total_cores(self) -> int:
        """Core budget across up nodes — the fleet arbitration capacity
        ceiling (one core absorbs one unit of placement weight)."""
        return sum(n.cores for n in self.nodes if n.up)

    def coresident_nodes(self) -> int:
        """Up nodes hosting residents from more than one owner prefix
        (``name`` up to the first ``:``) — the packing observable the
        multi-tenant bench freezes."""
        packed = 0
        for n in self.nodes:
            if not n.up or len(n.residents) < 2:
                continue
            prefixes = {r.split(":", 1)[0] for r in n.residents}
            if len(prefixes) > 1:
                packed += 1
        return packed

    def node_of(self, name: str) -> Optional[Node]:
        return self._owner.get(name)

    def dilation(self, node: Optional[Node]) -> float:
        return node.dilation() if node is not None else 1.0

    def audit(self) -> None:
        """The old O(N) residency scans, demoted to a debug assertion:
        the index and the per-node sets must tell the same story, and
        every cached dilation must match its recomputation."""
        seen: Dict[str, int] = {}
        for n in self.nodes:
            for name in n.residents:
                assert name not in seen, (
                    f"{name!r} resident on nodes {seen[name]} and {n.node_id}"
                )
                seen[name] = n.node_id
            if n._dil is not None:
                fresh = max(len(n.residents) / max(n.cores, 1), 1.0) / n.speed
                assert n._dil == fresh, f"stale dilation cache on node {n.node_id}"
            expect = sum(self._weights.get(r, 1.0) for r in n.residents)
            assert math.isclose(n.load, expect, rel_tol=1e-9, abs_tol=1e-6), (
                f"weighted load out of sync on node {n.node_id}: "
                f"{n.load} vs {expect}"
            )
        assert seen.keys() == self._owner.keys(), (
            "residency index out of sync with per-node sets"
        )
        for name, nid in seen.items():
            assert self._owner[name].node_id == nid

    # -- chaos ----------------------------------------------------------------
    def fail(self, node: Node) -> int:
        """Take a node down; every resident component is silenced at once
        (the pool's step/heartbeat loops gate on ``node.up``).  Returns
        the epoch of this failure, the token a restore must present."""
        if not node.up:
            return node.epoch
        node.up = False
        node.epoch += 1
        self.failures += 1
        return node.epoch

    def restore(self, node: Node, epoch: Optional[int] = None) -> bool:
        """Bring a node back.  ``epoch`` (from the matching :meth:`fail`)
        guards against stale events: a delayed restore for failure N is a
        no-op once failure N+1 has happened — it must never resurrect a
        node that died again in the meantime."""
        if node.up:
            return False
        if epoch is not None and epoch != node.epoch:
            return False  # stale: the node failed again after this event
        node.up = True
        self._push(node)
        self.topology_version += 1
        return True

    def fail_many(self, nodes: Sequence[Node]) -> List[Tuple[Node, int]]:
        """Batched :meth:`fail`: one pass, returns ``(node, epoch)`` for
        every node actually taken down (already-down nodes are skipped)."""
        batch: List[Tuple[Node, int]] = []
        for node in nodes:
            if node.up:
                node.up = False
                node.epoch += 1
                self.failures += 1
                batch.append((node, node.epoch))
        return batch

    def restore_many(
        self, batch: Sequence[Tuple[Node, Optional[int]]]
    ) -> List[Node]:
        """Batched :meth:`restore`: epoch-guarded per node, but one
        ``topology_version`` bump for the whole batch (pools rebalance on
        *change*, so one bump per recovery wave is the right granularity
        — and it keeps a 1000-node zone recovery from triggering 1000
        rebalance passes)."""
        restored: List[Node] = []
        for node, epoch in batch:
            if node.up:
                continue
            if epoch is not None and epoch != node.epoch:
                continue
            node.up = True
            self._push(node)
            restored.append(node)
        if restored:
            self.topology_version += 1
        return restored

    def set_speed(self, node: Node, speed: float) -> None:
        """Gray-failure actuator: change a node's speed (the node stays
        *up* — only dilation sees it) and invalidate its cache."""
        node.speed = speed
        node._dil = None


# ---------------------------------------------------------------------------
# Failure injection.
# ---------------------------------------------------------------------------


@dataclass
class FailureConfig:
    probability: float = 0.0       # per node, per interval
    interval: float = 600.0        # every 10 simulated minutes (paper §4.3)
    restart_delay: float = 300.0   # node back after 5 minutes
    seed: int = 0
    # -- fleet-scale chaos (all default off) ---------------------------------
    # Correlated bursts: each failure domain (rack or zone) fails whole
    # w.p. burst_probability per interval.
    burst_probability: float = 0.0
    burst_scope: str = "rack"               # "rack" | "zone"
    burst_restart_delay: Optional[float] = None   # default: restart_delay
    # Gray failures: a node stays up but its speed ramps to
    # base_speed * gray_speed for gray_duration (default 2*interval).
    gray_probability: float = 0.0
    gray_speed: float = 0.25
    gray_duration: Optional[float] = None
    # Zone network partitions: a whole zone becomes unreachable for
    # partition_duration (default restart_delay).  Symmetric-partition
    # model: an unreachable node is indistinguishable from a down node.
    partition_probability: float = 0.0
    partition_duration: Optional[float] = None

    def armed(self) -> bool:
        return (
            self.probability > 0.0
            or self.burst_probability > 0.0
            or self.gray_probability > 0.0
            or self.partition_probability > 0.0
        )


class FailureInjector:
    """Paper §4.3, scaled to the fleet: every ``interval``, each node
    fails w.p. ``probability`` and restarts ``restart_delay`` later; on a
    ``Topology``, whole racks/zones burst-fail together and zones
    partition; gray nodes slow down without going down.  Events ride the
    caller's event heap (any object with ``schedule(delay, fn)`` —
    ``SimEngine`` in the simulator, a per-tick-pumped engine in the
    launch demos), so the same injector drives the virtual-clock figures
    and the live chaos demos.

    Determinism: every draw is counter-based (see
    :func:`stream_uniform`) — node ``n``'s failure sequence is a pure
    function of ``(seed, n, interval_index)``, invariant to fleet size,
    iteration order, and which other chaos processes are enabled.  The
    vectorized draw (``vectorize=None`` inherits the cluster's flag) is
    bitwise-identical to the scalar loop.  All restores landing at the
    same virtual time coalesce into one heap event per distinct delay.
    """

    def __init__(
        self,
        engine,
        cluster: Cluster,
        config: FailureConfig,
        on_down: Optional[Callable[[Node], None]] = None,
        on_up: Optional[Callable[[Node], None]] = None,
        vectorize: Optional[bool] = None,
    ) -> None:
        self.engine = engine
        self.cluster = cluster
        self.config = config
        self.on_down = on_down
        self.on_up = on_up
        self.vectorize = cluster.vectorize if vectorize is None else bool(vectorize)
        self.interval_index = 0
        self.failures = 0        # node-downs injected (any cause)
        self.restores = 0        # node-ups that actually landed
        self.bursts = 0          # correlated domain events
        self.gray_events = 0     # speed ramps started/extended
        self.partitions = 0      # zone partition events
        self._streams: Dict[Tuple[int, int], np.ndarray] = {}
        self._gray_base: Dict[int, float] = {}
        self._gray_until: Dict[int, float] = {}
        if config.armed():
            engine.schedule(config.interval, self._tick)

    # -- draws ----------------------------------------------------------------
    def _stream_ids(self, base: int, count: int) -> np.ndarray:
        key = (base, count)
        arr = self._streams.get(key)
        if arr is None:
            arr = np.arange(count, dtype=np.uint64) + np.uint64(base)
            self._streams[key] = arr
        return arr

    def _draw_ids(self, base: int, count: int, p: float, k: int) -> List[int]:
        """Entity ids (ascending) whose u-draw at interval ``k`` is < p."""
        seed = self.config.seed
        if self.vectorize:
            u = stream_uniform_array(seed, self._stream_ids(base, count), k)
            return np.nonzero(u < p)[0].tolist()
        return [
            i for i in range(count)
            if stream_uniform(seed, base + i, k) < p
        ]

    def _require_topology(self) -> Topology:
        topo = self.cluster.topology
        if topo is None:
            raise ValueError(
                "correlated chaos (burst/partition) needs a Cluster(topology=...)"
            )
        return topo

    # -- the interval tick ----------------------------------------------------
    def _tick(self) -> None:
        cfg = self.config
        cluster = self.cluster
        nodes = cluster.nodes
        k = self.interval_index
        self.interval_index += 1
        # delay -> (node, epoch) batch: one restore event per distinct delay.
        restore_batches: Dict[float, List[Tuple[Node, int]]] = {}

        def take_down(node: Node, delay: float) -> None:
            epoch = cluster.fail(node)
            self.failures += 1
            if self.on_down is not None:
                self.on_down(node)
            restore_batches.setdefault(delay, []).append((node, epoch))

        # 1) independent per-node failures
        if cfg.probability > 0.0:
            for nid in self._draw_ids(STREAM_NODE, len(nodes), cfg.probability, k):
                if nodes[nid].up:
                    take_down(nodes[nid], cfg.restart_delay)

        # 2) rack/zone-correlated bursts
        if cfg.burst_probability > 0.0:
            topo = self._require_topology()
            if cfg.burst_scope == "zone":
                base, count, members = STREAM_ZONE, topo.num_zones, topo.zone_members
            elif cfg.burst_scope == "rack":
                base, count, members = STREAM_RACK, topo.num_racks, topo.rack_members
            else:
                raise ValueError(f"unknown burst_scope {cfg.burst_scope!r}")
            delay = (
                cfg.burst_restart_delay
                if cfg.burst_restart_delay is not None
                else cfg.restart_delay
            )
            for dom in self._draw_ids(base, count, cfg.burst_probability, k):
                self.bursts += 1
                for nid in members(dom):
                    if nodes[nid].up:
                        take_down(nodes[nid], delay)

        # 3) zone network partitions
        if cfg.partition_probability > 0.0:
            topo = self._require_topology()
            delay = (
                cfg.partition_duration
                if cfg.partition_duration is not None
                else cfg.restart_delay
            )
            for zone in self._draw_ids(
                STREAM_PARTITION, topo.num_zones, cfg.partition_probability, k
            ):
                self.partitions += 1
                for nid in topo.zone_members(zone):
                    if nodes[nid].up:
                        take_down(nodes[nid], delay)

        # 4) gray failures: speed ramp, node stays up
        if cfg.gray_probability > 0.0:
            dur = (
                cfg.gray_duration
                if cfg.gray_duration is not None
                else 2.0 * cfg.interval
            )
            now = self.engine.now
            ramped: List[int] = []
            for nid in self._draw_ids(STREAM_GRAY, len(nodes), cfg.gray_probability, k):
                node = nodes[nid]
                if nid not in self._gray_base:
                    self._gray_base[nid] = node.speed
                    cluster.set_speed(node, node.speed * cfg.gray_speed)
                self._gray_until[nid] = now + dur   # fresh ramp or extension
                self.gray_events += 1
                ramped.append(nid)
            if ramped:
                self.engine.schedule(dur, lambda ns=ramped: self._ungray(ns))

        # Coalesced restores: one event per distinct delay, not per node.
        for delay, batch in restore_batches.items():
            self.engine.schedule(delay, lambda b=batch: self._restart_batch(b))
        self.engine.schedule(cfg.interval, self._tick)

    # -- recovery -------------------------------------------------------------
    def _restart_batch(self, batch: List[Tuple[Node, int]]) -> None:
        restored = self.cluster.restore_many(batch)
        self.restores += len(restored)
        if self.on_up is not None:
            for node in restored:
                self.on_up(node)

    def _restart(self, node: Node, epoch: int) -> None:
        """Single-node restore (kept for direct/one-shot chaos callers)."""
        self._restart_batch([(node, epoch)])

    def _ungray(self, nids: List[int]) -> None:
        """End a gray ramp — unless a later ramp extended the window."""
        now = self.engine.now
        for nid in nids:
            until = self._gray_until.get(nid)
            if until is not None and now >= until:
                self.cluster.set_speed(
                    self.cluster.nodes[nid], self._gray_base.pop(nid)
                )
                del self._gray_until[nid]


@dataclass
class StepCost:
    """Per-message processing-cost model for metered pools.

    TCMM's nearest-micro-cluster search slows as micro-clusters
    accumulate (paper Fig. 8's decelerating slope):
    ``t_p(k) = t_p0 * (1 + alpha * sqrt(k))`` where ``k`` is messages
    processed so far.  A pool given a ``StepCost`` converts elapsed
    (virtual or wall) time into per-worker message budgets, dilated by
    the worker's node — this is how the *live* actuator reproduces the
    paper's timing model without a parallel control loop.
    """

    t_process0: float = 0.010
    growth_alpha: float = 0.0

    def t_process(self, processed_so_far: int) -> float:
        return self.t_process0 * (
            1.0 + self.growth_alpha * math.sqrt(processed_so_far)
        )
