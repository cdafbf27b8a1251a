"""The reactive control plane, extracted (paper §3.2.2–§3.2.4).

One generic ``ElasticPool``: a supervised, autoscaled pool of mailbox-fed
workers.  Before this module existed the repo carried three hand-rolled
copies of the same loop — ``ReactiveJob``'s task pool, the serving
layer's ``ElasticServingPool``, and the virtual producer pool — each with
its own spawn/retire/drain/restart code.  They are now thin policy shims
over this runtime, and so is the paper-figure simulator: with a
``core.cluster.Cluster`` attached the pool is *placement-aware* (workers
carry a ``node``; a node-down event silences every resident worker at
once; the supervisor relocates failures to the healthiest live node
after ``restart_cost``; step costs dilate by ``resident/cores × 1/speed``)
and with a ``StepCost`` it is *time-metered* (elapsed virtual or wall
time converts to per-worker message budgets) — one actuator under two
clocks (see ``core.runtime``).

What the pool owns:

  * **Admission** — an optional central ingress ``Mailbox`` (bounded =
    backpressure) with a shed-or-defer overflow policy and a
    rejected-demand feedback counter, so turned-away load still reaches
    the autoscaler (otherwise backpressure would suppress exactly the
    scale-out that could relieve it); plus a pluggable message-
    distribution ``Scheduler`` that orders dispatch batches and routes
    each message to a worker mailbox.
  * **Elasticity** — a ``WorkerPoolController`` targets a *unit* count
    (``units_per_worker`` maps units to per-worker capacity caps via
    ``split_units``; with one unit per worker the unit count is just the
    worker count).  Scale-in either redistributes the victim's mailbox to
    the survivors (``retire_mode="redistribute"``) or marks the victim
    draining and reaps it once empty (``retire_mode="drain"`` — running
    work is never cancelled).
  * **Supervision** — heartbeat-detected Let-It-Crash restarts: a dead
    worker's queued *and* in-flight messages are re-admitted (at the
    front — accepted work overtakes new arrivals and is never shed) and a
    fresh instance takes its place.  Redelivery is at-least-once; workers
    that need exactly-once effects dedup by ``msg_id`` (``DedupWindow``).
  * **Telemetry** — every worker carries a CRDT ``MetricsReplica``; when
    a worker retires or is restarted its replica is folded into the
    pool's graveyard replica, so ``merged_metrics()`` is lossless across
    any number of chaos kills and merges into a ``MetricsHub`` without
    coordination.

Overflow-safe redistribution (the scale-in crash fix): every drain path
delivers with ``try_put`` first, spills to the least-loaded candidate,
and as a last resort ``put_front``-requeues — a bounded mailbox may
briefly exceed its bound, but accepted work is never dropped and scale-in
can no longer raise ``MailboxOverflow`` mid-drain.
"""

from __future__ import annotations

import heapq

from dataclasses import replace as dc_replace
from typing import Any, Callable, Dict, List, Optional, Protocol, Sequence

import numpy as np

from repro_torch.core.cluster import Cluster, StepCost
from repro_torch.core.elastic import (
    AutoscalerConfig,
    WorkerPoolController,
    split_units,
)
from repro_torch.core.messages import Mailbox, Message
from repro_torch.core.scheduler import LoadView, Scheduler, make_scheduler
from repro_torch.core.supervision import HeartbeatDetector, Supervisor
from repro_torch.telemetry.metrics import MetricsReplica


class PoolWorker(Protocol):
    """What ``ElasticPool`` needs from a worker (duck-typed).

    ``WorkerBase`` provides defaults; ``ElasticBatcher`` satisfies it
    structurally.  ``mailbox`` is the worker's feed queue; ``load()`` is
    the routing signal (queued + in-flight); ``inflight()`` feeds the
    pool occupancy gauge; ``drain_for_readmission()`` must strip
    *everything* the worker holds — queued and in-flight — as Messages.
    """

    name: str
    alive: bool
    draining: bool
    mailbox: Mailbox
    metrics: MetricsReplica

    def step(self, now: float) -> int: ...
    def load(self) -> int: ...
    def inflight(self) -> int: ...
    def drain_for_readmission(self) -> List[Message]: ...
    def set_capacity(self, cap: int) -> None: ...
    def get_capacity(self) -> Optional[int]: ...


class WorkerBase:
    """Default plumbing for pool workers: alive/draining flags, mailbox-
    backed load, no in-flight state, capacity as a no-op."""

    def __init__(self, name: str, mailbox: Optional[Mailbox] = None,
                 mailbox_capacity: int = 0) -> None:
        self.name = name
        self.mailbox = mailbox or Mailbox(name, capacity=mailbox_capacity)
        self.alive = True
        self.draining = False
        self.metrics = MetricsReplica(name)

    def step(self, now: float) -> int:  # pragma: no cover - interface default
        return 0

    def load(self) -> int:
        return self.mailbox.depth()

    def inflight(self) -> int:
        return 0

    def drain_for_readmission(self) -> List[Message]:
        return list(self.mailbox.drain())

    def export_carry(self) -> List[Message]:
        """Processed-but-uncollected results a restart may hand to the
        replacement instead of re-admitting for recompute.  Exported
        work must no longer appear in ``drain_for_readmission``."""
        return []

    def import_carry(self, msgs: Sequence[Message]) -> int:
        """Adopt carried results from a predecessor.  Returns how many
        were accepted."""
        return 0

    def set_capacity(self, cap: int) -> None:
        pass

    def get_capacity(self) -> Optional[int]:
        return None

    def kill(self) -> str:
        """Chaos hook: silence the worker (stops stepping AND
        heartbeating) — what a wedged process looks like from the
        supervisor's side."""
        self.alive = False
        return self.name


class DedupWindow:
    """Bounded seen-set for exactly-once *effects* over at-least-once
    delivery: Let-It-Crash re-admission may redeliver, the window skips
    duplicates.  Insertion-ordered; overflow drops the oldest half.

    **Memory invariant** (owners that track a committed watermark):
    a key below the committed watermark can never be redelivered — the
    log is only ever re-read from the committed offset — so the owner
    should :meth:`evict_below` (or :meth:`evict_if`) on every watermark
    advance.  The window then holds O(uncommitted suffix) entries, not
    O(history); the size-halving overflow path is a last-resort bound
    for owners with no watermark (where eviction of a *live* key merely
    re-opens the at-least-once window it was narrowing).  The dataflow
    ``Stage`` relies on this: its publish-dedup and per-worker windows
    are keyed ``(partition, offset, ...)`` and evicted at commit time
    (property-tested in ``tests/test_dataflow.py``).
    """

    def __init__(self, window: int = 65536) -> None:
        self.window = window
        self._seen: Dict[Any, Any] = {}

    def seen(self, key: Any, value: Any = None) -> bool:
        """Record ``key``; True if it was already recorded.  ``value``
        is memoized on first sight (see :meth:`lookup`) so an owner can
        replay a duplicate's *outputs* without re-running its effects."""
        if key in self._seen:
            return True
        self._seen[key] = value
        if len(self._seen) > self.window:
            for k in list(self._seen)[: self.window // 2]:
                del self._seen[k]
        return False

    def lookup(self, key: Any) -> Any:
        """The value memoized with ``key`` (None if absent/valueless)."""
        return self._seen.get(key)

    def remember(self, key: Any, value: Any) -> None:
        """Attach/replace the memo for an already-seen key (owners that
        compute the value only after the ``seen`` check)."""
        if key in self._seen:
            self._seen[key] = value

    def discard(self, key: Any) -> None:
        """Drop one key (no-op if absent).  Targeted eviction for owners
        that know exactly which keys just fell below their watermark —
        O(1) per key instead of an :meth:`evict_if` window scan."""
        self._seen.pop(key, None)

    def evict_if(self, pred: Callable[[Any], bool]) -> int:
        """Drop every key for which ``pred`` holds; returns the count.
        The owner asserts those keys can never be redelivered."""
        dead = [k for k in self._seen if pred(k)]
        for k in dead:
            del self._seen[k]
        return len(dead)

    def evict_below(self, watermarks: Dict[int, int]) -> int:
        """Watermark eviction for ``(partition, offset, ...)``-tuple
        keys: drop entries whose offset sits below the partition's
        committed watermark.  Non-tuple keys (e.g. raw msg_ids) are
        kept — they carry no offset to compare."""
        return self.evict_if(
            lambda k: (
                isinstance(k, tuple)
                and len(k) >= 2
                and isinstance(k[1], int)
                and k[1] < watermarks.get(k[0], 0)
            )
        )

    def __len__(self) -> int:
        return len(self._seen)


class ReadyWorkerHeap:
    """O(log n) least-loaded-queue index over a bound :class:`LoadView`,
    with lazy invalidation.

    Replaces the overflow-spill path's O(n) ``min(range(n), key=depth)``
    scan.  Entries are ``(depth, idx)`` pairs; :meth:`least` returns the
    lexicographic minimum over the *live* depths — identical to the
    scalar first-occurrence-min scan, by this invariant: every index
    always has at least one heap entry whose recorded depth is **≤** its
    live depth.

      * Depth increases keep old entries valid (recorded ≤ live still
        holds) — corrected lazily when popped.
      * Depth decreases would break the invariant, so the view's
        ``on_decrease`` hook queues the index and :meth:`least` pushes a
        fresh entry before answering (queued, not pushed inline: the
        hook fires inside the mailbox lock).
      * A popped entry whose recorded depth disagrees with the live
        depth is replaced by a corrected entry and the pop retries.

    Given the invariant, the first popped entry that *agrees* with its
    live depth is ≤ every other index's (live depth, index) pair, i.e.
    exactly the scalar minimum.  Stale entries are bounded by periodic
    compaction (rebuild when the heap outgrows 8n)."""

    def __init__(self, view: LoadView) -> None:
        self.view = view
        self._pending: List[int] = []  # decrease queue (GIL-atomic appends)
        self._heap: List[tuple] = [
            (int(d), i) for i, d in enumerate(view.depths)
        ]
        heapq.heapify(self._heap)
        view.on_decrease = self._pending.append

    def least(self) -> int:
        """Index of the minimum-depth queue, lowest index on ties."""
        depths = self.view.depths
        if self._pending:
            # Swap-then-rebind: the view holds a bound ``append`` of the
            # *current* list, so after the swap the hook must be repointed
            # at the replacement — concurrent appends between the two
            # statements land in ``drained`` and are still processed.
            drained, self._pending = self._pending, []
            self.view.on_decrease = self._pending.append
            for idx in drained:
                heapq.heappush(self._heap, (int(depths[idx]), idx))
        if len(self._heap) > 8 * len(depths) + 64:
            self._heap = [(int(d), i) for i, d in enumerate(depths)]
            heapq.heapify(self._heap)
        heap = self._heap
        while True:
            d, i = heap[0]
            live = int(depths[i])
            if d == live:
                return i
            heapq.heapreplace(heap, (live, i))


class ElasticPool:
    """Supervised, autoscaled pool of mailbox-fed workers.

    Feed paths (pick per deployment):
      * ``offer(msg)``   — central bounded ingress, shed/defer overflow;
        a ``step`` later dispatches to worker mailboxes per the scheduler
        (the serving pattern);
      * ``route(msg)``   — immediate scheduler-routed delivery into a
        worker mailbox, no central ingress (the producer-pool pattern);
      * ``mailboxes()``  — expose worker mailboxes to an *external*
        forwarder such as a ``VirtualConsumerGroup`` (the ReactiveJob
        pattern: the virtual messaging layer is the dispatcher).
    """

    def __init__(
        self,
        name: str,
        worker_factory: Callable[[], Any],
        *,
        scheduler: "str | Scheduler" = "round_robin",
        initial_units: int = 1,
        units_per_worker: int = 1,
        max_workers: Optional[int] = None,
        autoscaler: Optional[AutoscalerConfig] = None,
        elastic: bool = True,
        reconcile_on: str = "always",      # or "delta": only on scale decisions
        supervisor: Optional[Supervisor] = None,
        heartbeat_timeout: float = 5.0,
        ingress_capacity: Optional[int] = None,  # None: no central ingress
        ingress_name: Optional[str] = None,
        overflow: str = "shed",            # "shed" drops, "defer" asks retry
        dispatch_batch: int = 32,
        retire_mode: str = "redistribute",  # or "drain"
        collect: Optional[Callable[[float], None]] = None,
        on_scale: Optional[Callable[[int, int], None]] = None,
        handoff: Optional[Any] = None,
        throttle: Optional[Callable[[], Optional[int]]] = None,
        cluster: Optional[Cluster] = None,
        restart_cost: float = 0.0,
        step_cost: Optional[StepCost] = None,
        placement_weight: float = 1.0,
        straggler_threshold: float = 0.0,
        straggler_patience: int = 3,
        straggler_check_every: int = 5,
        straggler_quarantine: float = 30.0,
        metrics: Optional[MetricsReplica] = None,
        metric_prefix: str = "pool",
        worker_noun: str = "worker",
        vectorize: bool = True,
    ) -> None:
        if overflow not in ("shed", "defer"):
            raise ValueError(f"overflow must be 'shed' or 'defer', got {overflow!r}")
        if retire_mode not in ("redistribute", "drain"):
            raise ValueError(f"retire_mode must be 'redistribute' or 'drain'")
        self.name = name
        self.worker_factory = worker_factory
        self.scheduler: Scheduler = (
            make_scheduler(scheduler) if isinstance(scheduler, str) else scheduler
        )
        self.units_per_worker = max(int(units_per_worker), 1)
        self.elastic = elastic
        self.reconcile_on = reconcile_on
        self.overflow = overflow
        self.dispatch_batch = dispatch_batch
        self.retire_mode = retire_mode
        self.collect = collect
        # Scale actuation hook: called with (old_units, new_units) after
        # the controller moves its target and BEFORE the worker set is
        # reconciled toward it.  This is where a scale decision becomes a
        # physical re-layout — the training job snapshots, remeshes
        # (``distributed.elastic_mesh``), and reshapes its DP degree here.
        # The hook may clamp by writing ``controller.target_size``.
        self.on_scale = on_scale
        # Live worker handoff (``checkpoint.handoff.WorkerHandoffChannel``):
        # a restarted worker's processed-but-uncollected results are
        # streamed to its replacement instead of re-admitted for
        # recompute, and messages the carry covers are filtered from
        # readmission (at-least-once redelivery cannot double-apply).
        self.handoff = handoff
        # Upstream-throttle hook (the on_scale counterpart for *demand*):
        # called once per step, may return a unit cap.  A dataflow
        # ``StageGraph`` wires this to downstream pressure — a slow
        # downstream stage caps this pool's unit target, so the stage
        # slows its producers instead of ballooning the topic between
        # them.  None (or a None return) means unthrottled.
        self.throttle = throttle
        self.supervisor = supervisor or Supervisor(f"{name}-supervisor")
        self.heartbeat_timeout = heartbeat_timeout
        # Placement layer (None = infinite homogeneous machine — the
        # pre-cluster behavior, bit-for-bit).  With a cluster attached,
        # every worker carries a ``node``, spawn/restart consult the
        # placement policy, a down node silences its residents, and step
        # costs dilate by co-residency and node speed.
        self.cluster = cluster
        self.restart_cost = restart_cost
        self.step_cost = step_cost
        # Cost-weighted packing: how much placement load one of this
        # pool's workers adds to its node (cluster.assign weight).  1.0
        # is the classic count-based policy; a multi-tenant fleet sets it
        # per tenant (~relative StepCost) so cheap replicas bin-pack
        # beside expensive ones.
        self.placement_weight = float(placement_weight)
        # Gray-failure (slow node) detection — symptom-based, because a
        # gray node is *up*: heartbeats flow, ``node.up`` holds, only
        # throughput sags.  A worker whose queue stays above
        # ``straggler_threshold × median peer load`` for
        # ``straggler_patience`` consecutive checks (one check every
        # ``straggler_check_every`` steps) is relocated off its node,
        # and that node is excluded from the relocation's placement.
        # ``straggler_threshold <= 0`` disables the path entirely.
        self.straggler_threshold = straggler_threshold
        self.straggler_patience = max(int(straggler_patience), 1)
        self.straggler_check_every = max(int(straggler_check_every), 1)
        self.straggler_quarantine = straggler_quarantine
        self._straggle_counts: Dict[str, int] = {}
        self._straggler_suspects: Dict[int, float] = {}  # node_id -> expiry
        self._straggle_cooldown: Dict[str, float] = {}   # worker -> until
        self._steps_since_straggle = 0
        # Messages processed over the pool's lifetime — the ``k`` of the
        # cost model's t_p(k) and the cheap progress counter harnesses
        # sample (merged_metrics() would cost a CRDT merge per sample).
        self.work_done = 0
        self._credit: Dict[str, float] = {}     # fractional step budgets
        self._cost_prev: Dict[str, float] = {}  # last metered step time
        self._seen_topology = cluster.topology_version if cluster else 0
        # Fast path: no placement, no metering, no warm-up gating.
        self._plain = cluster is None and step_cost is None and restart_cost <= 0
        self.ingress: Optional[Mailbox] = None
        if ingress_capacity is not None:
            self.ingress = Mailbox(
                ingress_name or f"{name}-ingress", capacity=ingress_capacity
            )
        self._px = metric_prefix
        self._noun = worker_noun
        # Vectorized dispatch (bitwise-equivalent fast path): a bound
        # LoadView over the active workers' mailboxes plus a least-loaded
        # heap, rebuilt whenever the active set changes.  ``vectorize=
        # False`` pins every dispatch site to the scalar reference path.
        self.vectorize = vectorize
        self._view: Optional[LoadView] = None
        self._view_workers: List[Any] = []
        self._view_boxes: List[Mailbox] = []
        self._view_caps = None  # numpy capacity array aligned with boxes
        self._ready: Optional[ReadyWorkerHeap] = None
        # Bumped on every worker-set mutation (spawn/retire/reap/restart
        # swap); queue_depth() trusts the view's coverage only while the
        # epochs agree.
        self._members_epoch = 0
        self._view_epoch = -1
        # Hot-path metric names, precomputed once: the per-message
        # f-string cost in offer/route was measurable at bench scale.
        self._m_admitted = f"{metric_prefix}.admitted"
        self._m_shed = f"{metric_prefix}.shed"
        self._m_deferred = f"{metric_prefix}.deferred"
        self._m_readmitted = f"{metric_prefix}.readmitted"
        self._m_dispatched = f"{metric_prefix}.dispatched"
        self._m_dispatch_rounds = f"{metric_prefix}.dispatch_rounds"
        self.metrics = metrics or MetricsReplica(name)
        # Dead/retired workers fold their replicas here — the lossless
        # half of merged_metrics() that survives any chaos kill.
        self.graveyard = MetricsReplica(f"{name}-graveyard")

        cfg = autoscaler or AutoscalerConfig()
        max_units = (max_workers if max_workers is not None else cfg.max_workers)
        max_units = max(max_units, 1) * self.units_per_worker
        cfg = dc_replace(
            cfg,
            min_workers=max(cfg.min_workers, 1),
            max_workers=min(cfg.max_workers, max_units),
            max_step=min(cfg.max_step, max_units),
        )
        self._max_units = cfg.max_workers
        self.controller = WorkerPoolController(
            min(max(initial_units, 1), max_units), cfg
        )

        self.workers: List[Any] = []
        self.shed: List[Message] = []
        self.steps = 0
        self._now = 0.0  # last step time; seeds detectors for new workers
        # Rejections since the last autoscaler observation: a bounded
        # ingress caps the queue-depth signal, so shed/deferred demand
        # must reach the controller some other way or backpressure would
        # suppress the very scale-out that could relieve it.
        self._rejected_since_observe = 0
        # (now, target_units, occupancy, active_workers) per step — the
        # elasticity trace tests and benches assert against.
        self.occupancy_log: List[tuple] = []
        self._reconcile(now=0.0)

    # -- admission -----------------------------------------------------------
    def offer(self, msg: Message) -> bool:
        """Admit into the central ingress.  False when backpressure
        rejects it: ``shed`` drops it for good (recorded), ``defer``
        means the caller owns the retry."""
        assert self.ingress is not None, "pool has no central ingress"
        if self.ingress.try_put(msg):
            self.metrics.incr(self._m_admitted)
            return True
        self._rejected_since_observe += 1
        if self.overflow == "shed":
            self.shed.append(msg)
            self.metrics.incr(self._m_shed)
        else:
            self.metrics.incr(self._m_deferred)
        return False

    def route(self, msg: Message) -> None:
        """Scheduler-routed direct delivery (no central ingress).  With
        every worker dead or draining, delivery falls back to *any*
        worker's mailbox — the message waits there for the supervisor's
        restart drain rather than being lost (or crashing the sender)."""
        view = self._sync_view() if self.vectorize else None
        if view is not None:
            idx = self.scheduler.pick_view(msg, view)
            self._force_deliver(msg, self._view_boxes, idx)
        else:
            workers = self.active_workers() or self.workers
            boxes = [w.mailbox for w in workers]
            idx = self.scheduler.pick_msg(msg, boxes) if boxes else 0
            self._force_deliver(msg, boxes, idx)
        self.metrics.incr(self._m_admitted)

    def note_rejected(self, n: int = 1) -> None:
        """Report offered demand the pool could not see in its queues
        (e.g. backlog parked upstream in a message log behind a full
        ingress) so the next autoscaler observation scales for it."""
        self._rejected_since_observe += max(int(n), 0)

    def mailboxes(self) -> List[Mailbox]:
        """Active workers' mailboxes, for external forwarders (VCGs)."""
        return [w.mailbox for w in self.workers if w.alive and not w.draining]

    # -- introspection ---------------------------------------------------------
    def queue_depth(self) -> int:
        depth = self.ingress.depth() if self.ingress is not None else 0
        view = self._view
        if view is not None and self._view_epoch == self._members_epoch:
            # The worker set is unchanged since the view bound (the
            # epoch guards spawn/retire/restart swaps), so the view
            # covers every then-active worker's mailbox exactly; only
            # workers that were dead/draining at bind time fall back to
            # a locked depth() read.  This is the aggregate other stages
            # poll per backpressure check — O(n) lock acquisitions
            # otherwise.
            depth += int(view.depths.sum())
            if len(self._view_workers) != len(self.workers):
                covered = {id(w) for w in self._view_workers}
                depth += sum(
                    w.mailbox.depth()
                    for w in self.workers
                    if id(w) not in covered
                )
            return depth
        return depth + sum(w.mailbox.depth() for w in self.workers)

    def occupancy(self) -> int:
        # Dead workers count too: their in-flight work is trapped until
        # the supervisor re-admits it, and drain loops must not conclude
        # the system is idle while work is trapped.
        return sum(w.inflight() for w in self.workers)

    def target_units(self) -> int:
        return self.controller.target_size

    def active_workers(self) -> List[Any]:
        return [w for w in self.workers if w.alive and not w.draining]

    def counter(self, name: str) -> int:
        return self.merged_metrics().value(name)

    def merged_metrics(self) -> MetricsReplica:
        """Pool + graveyard + live worker replicas, merged (lossless:
        every counter is a per-worker GCounter and worker names are never
        reused)."""
        out = self.metrics.merge(self.graveyard)
        for w in self.workers:
            out = out.merge(w.metrics)
        return out

    # -- chaos hook ------------------------------------------------------------
    def kill_worker(self, index: int = 0) -> str:
        """Silence worker ``index``; the supervisor detects the missed
        heartbeats and re-admits everything the worker held."""
        worker = self.workers[index % len(self.workers)]
        self.metrics.incr(f"{self._px}.{self._noun}_kills")
        if hasattr(worker, "kill"):
            return worker.kill()
        worker.alive = False
        return worker.name

    # -- cross-pool preemption hook --------------------------------------------
    def preempt_worker(self, index: Optional[int] = None) -> Optional[str]:
        """Surrender one worker's capacity NOW (fleet arbitration: a
        higher-priority pool needs this node).

        Unlike :meth:`kill_worker` there is no detection window, and
        unlike a ``retire_mode="drain"`` retire the victim does not
        finish its in-flight work first: it is force-drained through the
        existing restart path — ``drain_for_readmission`` strips queued
        *and* in-flight messages (freeing any paged-KV pages), the work
        re-admits at the front of the ingress, the node residency is
        released, and the controller target drops by one worker's units
        so reconcile does not immediately respawn the capacity.  When a
        ``WorkerHandoffChannel`` is attached, processed-but-uncollected
        results stream through it first (by the export contract they no
        longer appear in the drain, so redelivery cannot double-apply).

        The last active worker is never preempted — cross-pool
        arbitration degrades a victim tenant, it must not starve it.
        Returns the drained worker's name, or None when nothing was
        preemptible."""
        active = self.active_workers()
        if len(active) <= 1:
            return None
        worker = (
            active[index % len(active)] if index is not None
            else min(active, key=lambda w: w.load())
        )
        cfg = self.controller.autoscaler.config
        self.controller.target_size = max(
            self.controller.target_size - self.units_per_worker,
            cfg.min_workers,
        )
        if self.handoff is not None and hasattr(worker, "export_carry"):
            carried = worker.export_carry()
            if carried:
                self.handoff.stream(worker.name, carried)
        name = worker.name
        worker.draining = True
        self._restart_worker(worker)  # draining: pop + readmit + release
        self.metrics.incr(f"{self._px}.{self._noun}_preemptions")
        return name

    # -- placement -------------------------------------------------------------
    def _place(self, worker: Any, node: Any = None) -> None:
        """Bind a worker to a node (least-loaded healthy by default) and
        record its residency.  With every node down, the worker stays
        unplaced — silenced until the rebalance pass re-places it."""
        node = node if node is not None else self.cluster.place()
        worker.node = node
        if node is not None:
            self.cluster.assign(node, worker.name, weight=self.placement_weight)

    def _release(self, worker: Any) -> None:
        """Departure bookkeeping: residency and metering credits."""
        if self.cluster is not None:
            self.cluster.release(worker.name)
        self._credit.pop(worker.name, None)
        self._cost_prev.pop(worker.name, None)

    def _placement_up(self, worker: Any) -> bool:
        """False when the worker's node is down (or it has none while a
        cluster is attached): it neither steps nor heartbeats — a node
        failure silences *all* resident workers at once, and the
        supervisor's missed-beat path relocates them."""
        if self.cluster is None:
            return True
        node = getattr(worker, "node", None)
        return node is not None and node.up

    def _rebalance(self, now: float) -> None:
        """A node recovered: place any unplaced workers, then move this
        pool's workers off the most-crowded nodes until the residency
        spread is within one (elastic service placement rebalancing —
        without it, healed capacity would sit idle forever).  Each
        relocation pays ``restart_cost`` before the worker steps again;
        its mailbox moves with it."""
        for worker in self.workers:
            if worker.alive and getattr(worker, "node", None) is None:
                self._place(worker)
                if worker.node is not None:
                    worker.warm_until = now + self.restart_cost
        while True:
            target = self.cluster.place()
            if target is None:
                break
            movable = [
                w for w in self.workers
                if w.alive
                and getattr(w, "node", None) is not None
                and w.node.up and w.node is not target
                and w.node.load > target.load + self.placement_weight
            ]
            if not movable:
                break
            worker = max(
                movable, key=lambda w: (w.node.load, w.load())
            )
            self._place(worker, target)
            worker.warm_until = now + self.restart_cost
            self.metrics.incr(f"{self._px}.{self._noun}_relocations")

    def _detect_stragglers(self, now: float) -> None:
        """Relocate workers stuck on gray (slow-but-up) nodes.

        A gray node passes every liveness check, so detection has to be
        symptom-based: dilation slows its workers' drain rate, their
        queues grow relative to healthy peers, and a queue sustained
        above ``threshold × median`` for ``patience`` checks marks the
        worker a straggler.  The relocation excludes the suspect node
        from placement — otherwise a freshly-drained gray node is the
        least-loaded node and immediately re-attracts the move — and
        quarantines it for ``straggler_quarantine`` seconds, because a
        node that just shed its residents is *exactly* the node
        least-loaded placement would pick for everyone else's
        relocations while it is still slow."""
        suspects = self._straggler_suspects
        if suspects:
            for nid in [n for n, exp in suspects.items() if now >= exp]:
                del suspects[nid]
        placed = [
            w for w in self.workers
            if w.alive
            and getattr(w, "node", None) is not None
            and w.node.up
            and now >= getattr(w, "warm_until", 0.0)
        ]
        if len(placed) < 2:
            return
        loads = sorted(w.load() for w in placed)
        median = loads[len(loads) // 2]
        bar = self.straggler_threshold * (median + 1.0)
        counts = self._straggle_counts
        cooldown = self._straggle_cooldown
        for w in placed:
            if w.load() <= bar:
                counts.pop(w.name, None)
                cooldown.pop(w.name, None)
                continue
            # A just-relocated worker still *shows* the symptom (its
            # backlog came along) though the cause is gone — give it the
            # quarantine window to drain before it can be flagged again,
            # or it relocates in a loop, paying warm-up each hop.
            if now < cooldown.get(w.name, 0.0):
                continue
            seen = counts.get(w.name, 0) + 1
            if seen < self.straggler_patience:
                counts[w.name] = seen
                continue
            counts.pop(w.name, None)
            exclude = set(suspects)
            exclude.add(w.node.node_id)
            target = self.cluster.place(exclude=exclude)
            if target is None or target is w.node:
                continue
            if self.straggler_quarantine > 0:
                suspects[w.node.node_id] = now + self.straggler_quarantine
                cooldown[w.name] = now + self.straggler_quarantine
            self._place(w, target)
            w.warm_until = now + self.restart_cost
            self.metrics.incr(f"{self._px}.straggler_relocations")

    # -- internals -------------------------------------------------------------
    def _spawn(self) -> Any:
        worker = self.worker_factory()
        if getattr(worker, "metrics", None) is None:
            worker.metrics = MetricsReplica(worker.name)
        self.workers.append(worker)
        self._members_epoch += 1
        if self.cluster is not None:
            self._place(worker)
        self._cost_prev[worker.name] = self._now
        self._supervise(worker)
        self.metrics.incr(f"{self._px}.{self._noun}_spawns")
        return worker

    def _supervise(self, worker: Any) -> None:
        self.supervisor.supervise(
            worker.name,
            restart=lambda w=worker: self._restart_worker(w),
            detector=HeartbeatDetector(self.heartbeat_timeout),
        )
        # Seed the detector: an unseeded HeartbeatDetector never suspects
        # (last_beat=None), so a worker killed before its first step
        # would trap its messages forever.
        self.supervisor.heartbeat(worker.name, self._now)

    def _fold(self, worker: Any) -> None:
        """Fold a departing worker's CRDT replica into the graveyard so
        its counters survive the instance (restart-proof telemetry)."""
        metrics = getattr(worker, "metrics", None)
        if metrics is not None:
            self.graveyard = self.graveyard.merge(metrics)

    def _sync_view(self) -> Optional[LoadView]:
        """The bound LoadView over the active workers' mailboxes, rebuilt
        iff the active set changed since the last call (spawn, retire,
        drain-mark, restart, kill — anything that flips alive/draining).

        The membership check is an O(n) identity scan of cheap attribute
        reads; what the view removes is the O(n) *lock-taking* ``depth()``
        scan per message.  Returns None when there are no active workers
        (callers take the scalar fallback, which also handles the
        all-dead route case)."""
        active = self.active_workers()
        if not active:
            return None
        cached = self._view_workers
        if len(cached) == len(active) and all(
            a is b for a, b in zip(cached, active)
        ):
            return self._view
        if self._view is not None:
            self._view.detach()
        boxes = [w.mailbox for w in active]
        view = LoadView(boxes)
        self._view = view
        self._view_workers = active
        self._view_boxes = boxes
        self._view_caps = np.array([b.capacity for b in boxes], dtype=np.int64)
        self._view_epoch = self._members_epoch
        self._ready = ReadyWorkerHeap(view)
        return view

    def _force_deliver(
        self, msg: Message, boxes: Sequence[Mailbox], preferred: int
    ) -> None:
        """Overflow-safe delivery: try the preferred mailbox, spill to the
        least-loaded, and as a last resort put_front-requeue (briefly
        exceeding a bound beats dropping accepted work)."""
        if not boxes:
            if self.ingress is not None:
                self.ingress.put_front(msg)
                return
            raise RuntimeError(f"pool {self.name!r} has no workers to deliver to")
        if boxes[preferred].try_put(msg):
            return
        if self._ready is not None and boxes is self._view_boxes:
            j = self._ready.least()  # O(log n), same lowest-index minimum
        else:
            j = min(range(len(boxes)), key=lambda b: boxes[b].depth())
        if j != preferred and boxes[j].try_put(msg):
            return
        boxes[j].put_front(msg)

    def _readmit(self, msgs: Sequence[Message]) -> None:
        """Front of the ingress, original order preserved: a victim's
        work overtakes new arrivals and is never shed (put_front ignores
        the capacity bound — losing accepted work is worse than briefly
        exceeding it)."""
        assert self.ingress is not None
        for msg in reversed(list(msgs)):
            self.ingress.put_front(msg)
        if msgs:
            self.metrics.incr(f"{self._px}.readmitted", len(msgs))

    def _restart_worker(self, worker: Any) -> "None | bool":
        """Let-It-Crash: strip everything the victim held, swap in a
        fresh instance (draining victims are not replaced — they were
        leaving), re-admit the work.  With a cluster, the fresh instance
        is *relocated* to the healthiest live node and pays
        ``restart_cost`` before it steps again.  Returns ``False`` when
        the restart is deferred (no healthy node to place on)."""
        if worker not in self.workers:
            return  # already replaced by an earlier restart
        new_node = None
        if self.cluster is not None and not worker.draining:
            new_node = self.cluster.place()
            if new_node is None:
                # Nowhere to relocate: leave the victim in place (its
                # messages stay with it) and tell the supervisor this
                # was a deferral, not a heal — it retries after another
                # detection window, or the worker simply resumes when
                # its own node comes back.
                return False
        # Live handoff: carry the victim's processed-but-uncollected
        # results through the channel before draining, so the drain only
        # re-admits work that genuinely needs recompute.
        if self.handoff is not None and not worker.draining:
            carried = worker.export_carry()
            if carried:
                self.handoff.stream(worker.name, carried)
        msgs = list(worker.drain_for_readmission())
        worker.alive = False
        self._fold(worker)
        self.supervisor.unsupervise(worker.name)
        idx = self.workers.index(worker)
        if worker.draining:
            self.workers.pop(idx)
            self._members_epoch += 1
            self._release(worker)
            if msgs:
                if self.ingress is not None:
                    self._readmit(msgs)
                else:
                    self._redistribute(msgs)
            return
        fresh = self.worker_factory()
        if getattr(fresh, "metrics", None) is None:
            fresh.metrics = MetricsReplica(fresh.name)
        cap = worker.get_capacity() if hasattr(worker, "get_capacity") else None
        if cap is not None:
            fresh.set_capacity(cap)
        self.workers[idx] = fresh
        self._members_epoch += 1
        self._release(worker)
        if self.cluster is not None:
            self._place(fresh, new_node)
        self._cost_prev[fresh.name] = self._now
        if self.restart_cost > 0:
            fresh.warm_until = self._now + self.restart_cost
        self._supervise(fresh)
        if self.handoff is not None:
            recovered = self.handoff.recover()
            if recovered:
                n = fresh.import_carry(list(recovered.values()))
                self.handoff.mark_done(list(recovered.keys()))
                keys = set(recovered)
                msgs = [
                    m for m in msgs if self.handoff.key_for(m) not in keys
                ]
                self.metrics.incr(f"{self._px}.{self._noun}_handoffs")
                self.metrics.incr(f"{self._px}.handoff_carried", n)
        if self.ingress is not None:
            self._readmit(msgs)
        else:
            # Pending mailbox moves to the fresh instance; overflow (the
            # old box may have been bound-exceeded by prior put_fronts)
            # spills to the other survivors instead of crashing.
            others = [
                w.mailbox for w in self.workers
                if w is not fresh and w.alive and not w.draining
            ]
            for msg in msgs:
                if fresh.mailbox.try_put(msg):
                    continue
                self._force_deliver(msg, others or [fresh.mailbox], 0)
            if msgs:
                self.metrics.incr(f"{self._px}.readmitted", len(msgs))
        self.metrics.incr(f"{self._px}.{self._noun}_restarts")

    def _redistribute(self, msgs: Sequence[Message]) -> None:
        """Scale-in drain: scheduler-route a victim's messages to the
        survivors, overflow-safe (the fix for the bounded-mailbox
        scale-in crash: try_put, spill to least-loaded, put_front).

        Vectorized path: per-message ``pick_view`` against the bound
        view (not ``pick_batch`` — a spill lands the message off its
        pick, and the *live* view tracks that where a planned batch
        would not)."""
        view = self._sync_view() if self.vectorize else None
        if view is not None:
            boxes = self._view_boxes
            for msg in msgs:
                idx = self.scheduler.pick_view(msg, view)
                self._force_deliver(msg, boxes, idx)
            return
        boxes = [w.mailbox for w in self.active_workers()]
        for msg in msgs:
            idx = self.scheduler.pick_msg(msg, boxes) if boxes else 0
            self._force_deliver(msg, boxes, idx)

    def _retire_one(self, active: List[Any]) -> None:
        victim = min(active, key=lambda w: w.load())
        active.remove(victim)
        if self.retire_mode == "drain":
            # Takes no new work; reaped once empty. Running work is
            # never cancelled.
            victim.draining = True
            self.metrics.incr(f"{self._px}.{self._noun}_draining")
            return
        self.workers.remove(victim)
        self._members_epoch += 1
        victim.alive = False
        self._fold(victim)
        self._release(victim)
        self.supervisor.unsupervise(victim.name)
        self._redistribute(list(victim.drain_for_readmission()))
        self.metrics.incr(f"{self._px}.{self._noun}_retired")

    def _reap_drained(self) -> None:
        for worker in [w for w in self.workers if w.draining]:
            if worker.load() == 0 and worker.inflight() == 0:
                self.workers.remove(worker)
                self._members_epoch += 1
                self._fold(worker)
                self._release(worker)
                self.supervisor.unsupervise(worker.name)
                self.metrics.incr(f"{self._px}.{self._noun}_retired")

    def _reconcile(self, now: float) -> None:
        """Move the worker set toward the controller's unit target:
        units -> per-worker capacity caps via split_units (fill a worker
        before spawning the next)."""
        del now
        units = min(max(self.controller.target_size, 1), self._max_units)
        plan = split_units(units, self.units_per_worker)
        active = self.active_workers()
        while len(active) < len(plan):
            # Scale-out reclaims a draining worker before spawning: it is
            # warm, and spawning alongside it would briefly exceed the
            # pool's compute/memory budget.
            draining = [w for w in self.workers if w.alive and w.draining]
            if draining:
                revived = max(draining, key=lambda w: w.load())
                revived.draining = False
                active.append(revived)
                self.metrics.incr(f"{self._px}.{self._noun}_revived")
                continue
            active.append(self._spawn())
        while len(active) > len(plan) and len(active) > 1:
            self._retire_one(active)
        # Largest caps to the most loaded workers: their queues drain first.
        for worker, cap in zip(sorted(active, key=lambda w: -w.load()), plan):
            worker.set_capacity(cap)

    def set_target_units(self, units: int) -> None:
        """Manual scaling (elastic=False pools, e.g. producer resize).
        Routes through the same ``on_scale`` actuation as autoscaler
        decisions, so a manual resize of a meshed training pool still
        reshards before the worker set moves."""
        cfg = self.controller.autoscaler.config
        old = self.controller.target_size
        self.controller.target_size = min(
            max(units, cfg.min_workers), cfg.max_workers
        )
        if self.on_scale is not None and self.controller.target_size != old:
            self.on_scale(old, self.controller.target_size)
        self._reconcile(self._now)

    def _dispatch(self) -> int:
        """Move ingress messages to worker mailboxes per the admission
        policy.  Full worker queues push work back into the ingress
        (deferral): the backlog stays where the autoscaler watches it."""
        assert self.ingress is not None
        view = self._sync_view() if self.vectorize else None
        if view is not None:
            moved = self._dispatch_vectorized(view)
        else:
            moved = self._dispatch_scalar()
        if moved:
            self.metrics.incr(self._m_dispatched, moved)
            self.metrics.incr(self._m_dispatch_rounds)
        return moved

    def _dispatch_vectorized(self, view: LoadView) -> int:
        """Array-backed dispatch round, bitwise-equivalent to
        :meth:`_dispatch_scalar`:

        * saturation pre-check and min-free headroom come off the
          view's depth array instead of per-mailbox ``depth()`` locks;
        * the ingress pull is one ``get_many`` (one lock) instead of
          ``dispatch_batch`` ``get`` calls;
        * when every delivery is *guaranteed* to land on its pick
          (unbounded boxes, or headroom ≥ batch on every box) the whole
          batch routes through one ``pick_batch`` call over a planned
          depth copy — the exact index sequence the scalar loop would
          pick, because under guaranteed delivery each scalar pick sees
          precisely the planned depths;
        * otherwise (overflow possible) picks stay per-message via
          ``pick_view`` — the live bound view mirrors spills and
          rejections exactly as the scalar ``depth()`` scans would —
          with the same spill / give-up-and-requeue tail."""
        boxes = self._view_boxes
        caps = self._view_caps
        depths = view.depths
        bounded = caps > 0
        if bool(bounded.all()) and bool((depths >= caps).all()):
            return 0  # saturated: don't churn the ingress for nothing
        batch = self.ingress.get_many(self.dispatch_batch)
        if not batch:
            return 0
        ordered = self.scheduler.order(batch)
        scheduler = self.scheduler
        # Delivery is guaranteed when every *bounded* box can absorb the
        # whole batch (unbounded boxes always can): no pick can overflow,
        # so each scalar pick would see exactly the planned depths.
        guaranteed = (not bool(bounded.any())) or int(
            (caps - depths)[bounded].min()
        ) >= len(ordered)
        if scheduler.supports_batch and guaranteed:
            picks = scheduler.pick_batch(ordered, view.plan())
            for msg, i in zip(ordered, picks):
                boxes[i].put(msg)  # cannot overflow under the guard
            return len(ordered)
        moved = 0
        leftover: List[Message] = []
        ready = self._ready
        for pos, msg in enumerate(ordered):
            i = scheduler.pick_view(msg, view)
            if boxes[i].try_put(msg):
                moved += 1
                continue
            j = ready.least() if ready is not None else int(depths.argmin())
            if j != i and boxes[j].try_put(msg):
                moved += 1
                continue
            # The min-depth queue rejected, so every queue is full —
            # nothing later in the batch can land either.
            leftover.extend(ordered[pos:])
            break
        for msg in reversed(leftover):
            self.ingress.put_front(msg)
        return moved

    def _dispatch_scalar(self) -> int:
        """Reference dispatch round (``vectorize=False``): per-message
        scheduler picks over live ``depth()`` scans."""
        active = self.active_workers()
        if not active:
            return 0
        boxes = [w.mailbox for w in active]
        if all(b.capacity > 0 and b.depth() >= b.capacity for b in boxes):
            return 0  # saturated: don't churn the ingress for nothing
        batch: List[Message] = []
        while len(batch) < self.dispatch_batch:
            msg = self.ingress.get()
            if msg is None:
                break
            batch.append(msg)
        moved = 0
        leftover: List[Message] = []
        ordered = self.scheduler.order(batch)
        for pos, msg in enumerate(ordered):
            i = self.scheduler.pick_msg(msg, boxes)
            if boxes[i].try_put(msg):
                moved += 1
                continue
            j = min(range(len(boxes)), key=lambda b: boxes[b].depth())
            if j != i and boxes[j].try_put(msg):
                moved += 1
                continue
            # The min-depth queue rejected, so every queue is full —
            # nothing later in the batch can land either.
            leftover.extend(ordered[pos:])
            break
        for msg in reversed(leftover):
            self.ingress.put_front(msg)
        return moved

    def _metered_step(self, worker: Any, now: float, t_p: float) -> int:
        """Step one worker under placement and cost awareness.

        * Node down (or unplaced): silenced — no step, no accrual.
        * Warming (relocation in flight): the ``restart_cost`` window.
        * ``step_cost`` set: elapsed time since the worker's last step
          converts to a message budget, ``(now - prev) / (t_p × dilation)``
          — fractional remainders carry (capped at one message, so an
          idle worker cannot bank a burst), and an un-budgeted worker
          that overdraws pays it back through negative credit.
        * cluster only: skip-step credits — the worker runs a
          ``1/dilation`` fraction of rounds (one step = one quantum).
        """
        node = getattr(worker, "node", None)
        if self.cluster is not None and (node is None or not node.up):
            self._cost_prev[worker.name] = now
            return 0
        if now < getattr(worker, "warm_until", 0.0):
            self._cost_prev[worker.name] = now
            return 0
        dil = self.cluster.dilation(node) if self.cluster is not None else 1.0
        if self.step_cost is None:
            credit = self._credit.get(worker.name, 0.0) + 1.0 / dil
            rounds = int(credit)
            n = 0
            for _ in range(rounds):
                n += worker.step(now)
            self._credit[worker.name] = min(credit - rounds, 1.0)
            return n
        prev = self._cost_prev.get(worker.name, now)
        self._cost_prev[worker.name] = now
        credit = self._credit.get(worker.name, 0.0) + (now - prev) / (t_p * dil)
        budget = int(credit)
        if budget <= 0:
            self._credit[worker.name] = credit
            return 0
        base = getattr(worker, "step_budget", None)
        if base is not None:
            worker.step_budget = budget
            n = worker.step(now)
            worker.step_budget = base
            self._credit[worker.name] = min(credit - n, 1.0)
            return n
        # No per-call budget knob: spend the credit one step at a time; a
        # step that overdraws (processes several quanta) pays it back, an
        # idle step ends the round.
        n = 0
        while credit >= 1.0:
            done = worker.step(now)
            credit -= max(done, 1)
            n += done
            if done == 0:
                break
        self._credit[worker.name] = min(credit, 1.0)
        return n

    # -- main loop ---------------------------------------------------------------
    def step(self, now: float = 0.0) -> int:
        """One pool round: reap drained, dispatch, step workers, collect,
        supervise, autoscale.  Returns total work units done."""
        self._now = max(self._now, now)
        if self.retire_mode == "drain":
            self._reap_drained()
        if self.ingress is not None:
            self._dispatch()
        worked = 0
        if self._plain:
            for worker in self.workers:
                if worker.alive:
                    worked += worker.step(now)
        else:
            if self.cluster is not None and (
                self.cluster.topology_version != self._seen_topology
            ):
                self._seen_topology = self.cluster.topology_version
                self._rebalance(now)
            t_p = (
                self.step_cost.t_process(self.work_done)
                if self.step_cost is not None else 0.0
            )
            for worker in self.workers:
                if worker.alive:
                    worked += self._metered_step(worker, now, t_p)
            if self.cluster is not None and self.straggler_threshold > 0.0:
                self._steps_since_straggle += 1
                if self._steps_since_straggle >= self.straggler_check_every:
                    self._steps_since_straggle = 0
                    self._detect_stragglers(now)
        self.work_done += worked
        if self.collect is not None:
            # Harvest finished outputs BEFORE supervision: the restart
            # path replaces the worker object, and anything harvestable
            # must be off it by then.
            self.collect(now)
        for worker in self.workers:
            if worker.alive and self._placement_up(worker):
                self.supervisor.heartbeat(worker.name, now)
        self.supervisor.check(now)
        # Elasticity: offered load drives the unit target — queued
        # backlog plus the demand a bounded ingress turned away since the
        # last observation.
        if self.ingress is not None:
            signal = self.queue_depth() + self._rejected_since_observe
            self._rejected_since_observe = 0
            units = max(self.controller.target_size, 1)
            depths: Sequence[float] = [signal / units] * units
        else:
            # Rejected demand counts here too: a mailboxes-fed stage
            # whose virtual consumers park backlog in the topic reports
            # that lag via note_rejected, and it must reach the
            # controller exactly as a bounded ingress's overflow does.
            depths = [w.mailbox.depth() for w in self.workers]
            signal = sum(depths) + self._rejected_since_observe
            if self._rejected_since_observe and depths:
                extra = self._rejected_since_observe / len(depths)
                depths = [d + extra for d in depths]
            self._rejected_since_observe = 0
        if self.elastic:
            old_target = self.controller.target_size
            # Backpressure throttle: evaluate the cap BEFORE the
            # autoscaler moves the target, so a "freeze" cap (cap ==
            # current target) really freezes — then apply it after the
            # decision, suppressing (and undoing) scale-out that would
            # only feed an already-drowning consumer.
            cap = self.throttle() if self.throttle is not None else None
            decision, _ = self.controller.observe(depths, now=now)
            if decision.delta > 0:
                self.metrics.incr(f"{self._px}.scale_out")
            elif decision.delta < 0:
                self.metrics.incr(f"{self._px}.scale_in")
            if cap is not None and self.controller.target_size > max(cap, 1):
                self.controller.target_size = max(cap, 1)
                self.metrics.incr(f"{self._px}.throttled")
            if (
                self.on_scale is not None
                and self.controller.target_size != old_target
            ):
                # Actuate before reconciling: a meshed job must re-lay its
                # state out at the new degree before workers come or go.
                self.on_scale(old_target, self.controller.target_size)
            if (
                self.reconcile_on == "always"
                or decision.delta != 0
                or self.controller.target_size != old_target
            ):
                self._reconcile(now)
        self.metrics.gauge(f"{self._px}.queue_depth", signal, timestamp=now)
        self.metrics.gauge(f"{self._px}.occupancy", self.occupancy(), timestamp=now)
        self.occupancy_log.append(
            (now, self.controller.target_size, self.occupancy(),
             len(self.active_workers()))
        )
        self.steps += 1
        return worked
