"""Multi-stage reactive dataflow: a ``StageGraph`` of ElasticPools over
durable topics.

The paper's Liquid setting is not one pool but *chained incremental
jobs*: Samza-style processing stages connected by Kafka topics, each
independently elastic and resilient (paper §2–§3).  This module adds the
missing layer above ``core.pool``:

  * a **Stage** is one five-layer slice — durable input topic
    (messaging) → ``VirtualConsumerGroup`` in *manual-commit* mode
    (virtual messaging) → worker mailboxes (async messaging) →
    ``ElasticPool`` of workers (processing) → durable output topic —
    with the **chained commit-after-publish** contract: a consumed
    offset becomes committable only once *every* output it produced is
    durably appended downstream.  A chaos-killed worker re-admits
    through the pool; a killed *process* replays the uncommitted suffix
    from the topic, and publish-side dedup (keyed by the input's
    ``(partition, offset)`` source, which survives process death) keeps
    the downstream topic exactly-once.
  * a **StageGraph** wires stages into a DAG — edges are the topics
    themselves: stage B is downstream of stage A iff B consumes the
    topic A publishes.  Linear chains, fan-out (two stages, two consumer
    groups, one topic), and fan-in (two stages publishing one topic,
    keyed re-partitioning via ``data.topics.partition_for_key``) all
    fall out of that identification.  The graph steps every stage under
    one clock and propagates **backpressure upstream**: a downstream
    stage's pending work (input lag + queued + in-flight + rejected
    demand) feeds the upstream pool's ``throttle`` hook as a unit cap,
    so a slow stage slows its producers instead of ballooning the
    intermediate topic.

``ReactiveJob`` is a one-stage graph, ``ServingJob`` a two-stage graph
(decode → response-publish), and ``TrainingJob``'s token-ingestion front
half a terminal stage (``training.job.TokenIngestStage``) — see those
modules.  The paper-figure simulations drive this same graph on the
virtual clock: ``core.simulation.simulate_dataflow`` is a thin harness
that builds real ``Stage``s (optionally on a ``core.cluster.Cluster``)
and steps them via ``core.runtime.VirtualRuntime`` — no restated control
loop.

Exactly-once bookkeeping (all bounded O(uncommitted suffix), evicted on
every watermark advance — the ``DedupWindow`` memory invariant):

  * ``_admitted``   — inputs forwarded into the pool, not yet done
    (blocks double-forwarding when a restarted virtual consumer re-reads
    the suffix its predecessor already delivered);
  * ``_pub``        — ``(partition, offset, k)`` outputs already
    appended downstream (makes publishing idempotent under pool-level
    at-least-once redelivery *and* cross-process replay);
  * ``_expected`` / ``_pubcount`` — how many outputs input ``(p, o)``
    produces vs. how many are durably downstream; an input whose outputs
    are all present replays as a commit, not a re-execution.
"""

from __future__ import annotations

import itertools
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cluster import Cluster, StepCost
from repro_torch.core.elastic import AutoscalerConfig
from repro_torch.core.messages import Mailbox, Message
from repro_torch.core.pool import DedupWindow, ElasticPool, WorkerBase
from repro_torch.core.scheduler import make_scheduler
from repro_torch.core.state import EventJournal
from repro_torch.core.supervision import HeartbeatDetector, Supervisor
from repro_torch.core.virtual_messaging import VirtualConsumerGroup
from repro_torch.data.topics import MessageLog, Topic

class StageWorkerStats:
    """Live counter view over the worker's CRDT replica (the ReactiveTask
    ``stats`` surface, kept for back-compat)."""

    def __init__(self, worker: "StageWorker") -> None:
        self._worker = worker

    @property
    def processed(self) -> int:
        return self._worker.metrics.value("task.processed")

    @property
    def emitted(self) -> int:
        return self._worker.metrics.value("task.emitted")

    @property
    def deduped(self) -> int:
        return self._worker.metrics.value("task.deduped")


class StageWorker(WorkerBase):
    """A function worker inside a stage's pool.

    ``process`` sees the (unwrapped) input message and returns output
    values.  Results park in ``_ready`` until the stage harvests them
    (pool ``collect`` runs before supervision can replace the worker, so
    a kill between processing and harvest loses nothing).  The dedup
    window is keyed by the input's ``(partition, offset)`` — stable
    across redelivery — and *memoizes the outputs*, so a redelivered
    input replays its outputs into the harvest without re-running
    effects (exactly-once effects within a process lifetime; the stage's
    publish-side dedup covers cross-process replay)."""

    _ids = itertools.count()

    def __init__(
        self,
        stage_name: str,
        process: Callable[[Message], List[Any]],
        mailbox_capacity: int = 0,
        dedup_window: int = 65536,
        step_budget: int = 8,
    ) -> None:
        self.task_id = next(StageWorker._ids)
        super().__init__(
            f"{stage_name}:task{self.task_id}",
            mailbox_capacity=mailbox_capacity,
        )
        self.process = process
        self.stats = StageWorkerStats(self)
        self.dedup = DedupWindow(dedup_window)
        self.step_budget = step_budget
        self._ready: List[Tuple[Message, List[Any]]] = []

    def step(self, now: float = 0.0) -> int:
        n = 0
        deduped = emitted = 0
        while n < self.step_budget and self.alive:
            msg = self.mailbox.get()
            if msg is None:
                break
            key = (
                (msg.partition, msg.offset)
                if msg.offset >= 0 else ("id", msg.msg_id)
            )
            if self.dedup.seen(key):
                deduped += 1
                memo = self.dedup.lookup(key)
                if memo is not None:
                    # Redelivered after processing: replay the memoized
                    # outputs (publish dedup drops any already landed).
                    self._ready.append((msg, list(memo)))
                continue
            outputs = list(self.process(msg) or [])
            self.dedup.remember(key, outputs)
            emitted += len(outputs)
            self._ready.append((msg, outputs))
            n += 1
        # Counters batched per step (values at every step boundary are
        # identical to the per-message version).
        if n:
            self.metrics.incr("task.processed", n)
        if emitted:
            self.metrics.incr("task.emitted", emitted)
        if deduped:
            self.metrics.incr("task.deduped", deduped)
        return n

    def load(self) -> int:
        return self.mailbox.depth() + len(self._ready)

    def inflight(self) -> int:
        return len(self._ready)

    def take_ready(self) -> List[Tuple[Message, List[Any]]]:
        out, self._ready = self._ready, []
        return out

    def drain_for_readmission(self) -> List[Message]:
        out = [msg for msg, _ in self._ready]
        self._ready = []
        out.extend(self.mailbox.drain())
        return out


class _GuardedBox:
    """A virtual consumer's view of one pool mailbox: admission dedup
    runs *before* enqueue (a skip still advances the consumer's read
    position — the input is already accounted for), and a raising ``put``
    leaves no bookkeeping behind, so backpressured messages are re-read
    cleanly."""

    def __init__(self, stage: "Stage", box: Mailbox) -> None:
        self.stage = stage
        self.box = box

    def depth(self) -> int:
        return self.box.depth()

    def put(self, msg: Message) -> None:
        if not self.stage._admission_check(msg):
            return
        self.box.put(msg)  # may raise MailboxOverflow -> vc backpressure
        self.stage._note_admitted(msg)


class _IngressView:
    """Same guard, for stages that admit through a central ingress (or a
    subclass ``_admit`` adapter, e.g. the serving decode stage)."""

    def __init__(self, stage: "Stage") -> None:
        self.stage = stage

    def depth(self) -> int:
        return self.stage.pool.queue_depth()

    def put(self, msg: Message) -> None:
        if not self.stage._admission_check(msg):
            return
        if self.stage._admit(msg):  # may raise MailboxOverflow
            self.stage._note_admitted(msg)


class Stage:
    """One dataflow stage: topic → virtual consumers (manual commit) →
    elastic worker pool → topic, commit-after-publish.

    Two processing modes:

      * **function mode** (``process=``): the stage owns an
        ``ElasticPool`` of ``StageWorker``s; ``feed`` selects the paper
        pattern — ``"mailboxes"`` (virtual consumers are the dispatcher,
        scheduler-routed into per-task mailboxes; the ``ReactiveJob``
        shape) or ``"ingress"`` (one central bounded mailbox; the
        serving shape).
      * **adapter mode** (``pool=``): a subclass supplies an existing
        pool plus ``_admit`` / ``_take_results`` (how ``ServingJob``
        mounts ``ElasticServingPool`` as its decode stage).

    ``key_fn`` computes the output partitioning key — keyed inter-stage
    re-partitioning: equal keys land in the same downstream partition
    (``data.topics.partition_for_key``), which is what makes fan-in
    order-preserving per key.
    """

    def __init__(
        self,
        name: str,
        log: MessageLog,
        in_topic: "str | Topic",
        out_topic: "str | Topic | None" = None,
        *,
        process: Optional[Callable[[Message], List[Any]]] = None,
        key_fn: Optional[Callable[[Any], Optional[str]]] = None,
        feed: str = "mailboxes",
        initial_tasks: int = 2,
        scheduler: str = "round_robin",
        batch_n: int = 8,
        step_budget: int = 8,
        mailbox_capacity: int = 0,
        ingress_capacity: int = 0,
        autoscaler: Optional[AutoscalerConfig] = None,
        elastic: bool = True,
        heartbeat_timeout: float = 5.0,
        supervisor: Optional[Supervisor] = None,
        journal_factory: Optional[Callable[[int], EventJournal]] = None,
        journal_write_behind: Optional[Any] = None,
        autoscale_lag_cap: int = 256,
        dedup_window: int = 65536,
        pool: Optional[ElasticPool] = None,
        source: Optional[Any] = None,
        cluster: Optional[Cluster] = None,
        restart_cost: float = 0.0,
        step_cost: Optional[StepCost] = None,
        straggler_threshold: float = 0.0,
        consume_cost: Optional[float] = None,
        completion_window: Optional[int] = 65536,
        metric_prefix: str = "stage",
        worker_noun: str = "task",
    ) -> None:
        if feed not in ("mailboxes", "ingress"):
            raise ValueError(f"feed must be 'mailboxes' or 'ingress', got {feed!r}")
        self.name = name
        self.log = log
        self.in_topic: Topic = log.get(in_topic) if isinstance(in_topic, str) else in_topic
        self.out_topic: Optional[Topic] = (
            (log.get(out_topic) if isinstance(out_topic, str) else out_topic)
            if out_topic is not None else None
        )
        self.key_fn = key_fn
        self.feed = feed
        self.source = source
        self.autoscale_lag_cap = autoscale_lag_cap
        self._px = metric_prefix
        # Hot-path metric names, precomputed once (admission runs per
        # message; the f-string cost was measurable at bench scale).
        self._m_published = f"{metric_prefix}.published"
        self._m_redelivered = f"{metric_prefix}.redelivered"
        self._m_replay_deduped = f"{metric_prefix}.replay_deduped"

        # Write-behind journaling: the commit *decision* stays on the
        # step (watermark advance, dedup eviction — all in-memory), but
        # the journal line's file write defers through the shared worker.
        # ``durable_offsets()`` is the view that gates on the resulting
        # journal-complete tickets instead of the synchronous write.
        self._write_behind = journal_write_behind
        if journal_write_behind is not None and journal_factory is not None:
            base_factory = journal_factory

            def journal_factory(p, _f=base_factory):  # noqa: F811
                j = _f(p)
                j._write_behind = journal_write_behind
                return j

        # partition -> FIFO of (offset, ticket) awaiting durability
        self._commit_tickets: Dict[int, deque] = {}
        self._durable: Dict[int, int] = {}

        self.consumers = VirtualConsumerGroup(
            name,
            self.in_topic,
            scheduler_factory=lambda: make_scheduler(scheduler),
            batch_size=batch_n,
            journal_factory=journal_factory,
            commit_policy="manual",
        )

        if pool is not None:
            self.pool = pool
        else:
            if process is None:
                raise ValueError("Stage needs either process= or pool=")
            self.pool = ElasticPool(
                name,
                lambda: StageWorker(
                    name, process,
                    mailbox_capacity=mailbox_capacity,
                    dedup_window=dedup_window,
                    step_budget=step_budget,
                ),
                scheduler=scheduler,
                initial_units=initial_tasks,
                autoscaler=autoscaler
                or AutoscalerConfig(min_workers=1, max_workers=256, cooldown=0.0),
                elastic=elastic,
                supervisor=supervisor,
                heartbeat_timeout=heartbeat_timeout,
                ingress_capacity=(ingress_capacity if feed == "ingress" else None),
                ingress_name=f"{name}-ingress",
                overflow="defer",
                retire_mode="redistribute",
                collect=self._harvest_workers,
                cluster=cluster,
                restart_cost=restart_cost,
                step_cost=step_cost,
                straggler_threshold=straggler_threshold,
                metric_prefix=metric_prefix,
                worker_noun=worker_noun,
            )

        # Placement for the stage's virtual consumers: they live on
        # nodes (and die with them) but are *weightless* — consume-and-
        # forward is "much simpler than processing a message" (paper
        # §3.1), so they never count toward core dilation.  Adapter-mode
        # stages inherit the supplied pool's cluster.
        self.cluster = (
            cluster if cluster is not None
            else getattr(self.pool, "cluster", None)
        )
        self.restart_cost = (
            restart_cost if restart_cost > 0
            else getattr(self.pool, "restart_cost", 0.0)
        )
        # Consume-cost metering: seconds per consumed message (the
        # paper's ``t_c`` + forward cost).  None = unmetered (live mode:
        # a step consumes up to ``batch_n``).
        self.consume_cost = consume_cost
        self._vc_credit: Dict[int, float] = {}
        self._vc_prev: Dict[int, float] = {}
        self._gate_vcs = self.cluster is not None or self.restart_cost > 0
        # Per-message completion times (forward -> durably done): the
        # paper's Eq. 2 ``n·t_c + t_wi + t_p`` observable, recorded by
        # the stage itself so every tier reports the same quantity.
        # Bounded by default (a long-lived live stage must not leak
        # O(history)); the figure harnesses pass ``None`` to keep the
        # full distribution.
        self.completions: "deque[float]" = deque(maxlen=completion_window)
        self._forward_time: Dict[Tuple[int, int], float] = {}
        self._now = 0.0

        # -- commit-after-publish bookkeeping ------------------------------
        parts = range(self.in_topic.num_partitions)
        self._done: Dict[int, set] = {p: set() for p in parts}
        self._watermark: Dict[int, int] = {
            c.partition: c.offset for c in self.consumers.consumers
        }
        self._admitted: set = set()
        self._pub = DedupWindow(dedup_window)
        self._expected: Dict[Tuple[int, int], int] = {}
        self._pubcount: Dict[Tuple[int, int], int] = {}
        self._fresh: List[Tuple[Message, List[Any]]] = []
        # partition -> (lo, hi): offsets committed since the last
        # eviction round (the targeted-eviction work list).
        self._evict_spans: Dict[int, Tuple[int, int]] = {}
        self._seed_published()
        if self.cluster is not None:
            for vc in self.consumers.consumers:
                vc.node = self.cluster.place()
        for vc in self.consumers.consumers:
            self._supervise_vc(vc.partition)

    # -- recovery ------------------------------------------------------------
    def _seed_published(self) -> None:
        """Rebuild the publish-dedup state from the durable output topic:
        everything this stage appended in a previous life, filtered to
        the uncommitted suffix (entries below the committed watermark can
        never be re-read, so carrying them would be O(history))."""
        if self.out_topic is None:
            return
        for part in self.out_topic.partitions:
            for msg in part.read(0, part.end_offset()):
                if msg.src is None or msg.src[0] != self.name:
                    continue
                _, p, o, k, n = msg.src
                if p < 0 or o < self._watermark.get(p, 0):
                    continue
                if not self._pub.seen((p, o, k)):
                    self._pubcount[(p, o)] = self._pubcount.get((p, o), 0) + 1
                self._expected[(p, o)] = n

    # -- supervision ---------------------------------------------------------
    def _supervise_vc(self, partition: int) -> None:
        self.pool.supervisor.supervise(
            f"{self.name}:vc{partition}",
            restart=lambda p=partition: self._restart_vc(p),
            detector=HeartbeatDetector(self.pool.heartbeat_timeout),
        )
        self.pool.supervisor.heartbeat(f"{self.name}:vc{partition}", self.pool._now)

    def _restart_vc(self, partition: int) -> "None | bool":
        """Let-It-Crash for a virtual consumer: rebuild from the journal,
        relocated to the healthiest live node, warm after restart_cost.
        With no live node, keep the old instance and defer (``False``) —
        it resumes when its own node heals, or the supervisor retries
        next window."""
        node = None
        if self.cluster is not None:
            node = self.cluster.place()
            if node is None:
                return False
        vc = self.consumers.restart_consumer(partition)
        vc.node = node
        if self.restart_cost > 0:
            vc.warm_until = self._now + self.restart_cost

    def _vc_up(self, vc: Any) -> bool:
        """Heartbeat gate: a consumer on a down node is silenced (it
        misses beats and gets relocated), exactly like a pool worker."""
        if self.cluster is None:
            return True
        node = getattr(vc, "node", None)
        return node is not None and node.up

    def _vc_ready(self, vc: Any, now: float) -> bool:
        """Step gate: up *and* past any relocation warm-up."""
        return self._vc_up(vc) and now >= getattr(vc, "warm_until", 0.0)

    def _meter_consumers(self, now: float) -> None:
        """Convert elapsed virtual time to per-consumer batch budgets:
        a consumer may pull ``(now - prev) / consume_cost`` messages this
        round.  Unused capacity is not banked — consuming is
        use-it-or-lose-it, so an idle partition cannot burst later."""
        for vc in self.consumers.consumers:
            prev = self._vc_prev.get(vc.partition, now)
            self._vc_prev[vc.partition] = now
            credit = (
                self._vc_credit.get(vc.partition, 0.0)
                + (now - prev) / self.consume_cost
            )
            batch = int(credit)
            vc.batch_size = batch
            self._vc_credit[vc.partition] = credit - batch

    # -- admission -----------------------------------------------------------
    def _fully_published(self, src: Tuple[int, int]) -> bool:
        n = self._expected.get(src)
        return n is not None and self._pubcount.get(src, 0) >= n and n > 0

    def _admission_check(self, msg: Message) -> bool:
        """True when the input should enter the pool.  Duplicates (an
        already-admitted, already-done, or already-committed source) are
        swallowed; a source whose outputs are all durably downstream
        replays as a commit (``replay_deduped``), not a re-execution."""
        p, o = msg.partition, msg.offset
        if o < 0:
            return True
        if (
            o < self._watermark.get(p, 0)
            or o in self._done.get(p, ())
            or (p, o) in self._admitted
        ):
            self.pool.metrics.incr(self._m_redelivered)
            return False
        if self._fully_published((p, o)):
            self._mark_done(p, o)
            self.pool.metrics.incr(self._m_replay_deduped)
            return False
        return True

    def _note_admitted(self, msg: Message) -> None:
        if msg.offset >= 0:
            self._admitted.add((msg.partition, msg.offset))
            self._forward_time[(msg.partition, msg.offset)] = self._now

    def _admit(self, msg: Message) -> bool:
        """Ingress-feed delivery (adapter stages override).  True when
        the message entered the pool; False when admission handled it
        some other way (the consumer still advances past it); raises
        ``MailboxOverflow`` for backpressure (the consumer re-reads)."""
        self.pool.ingress.put(msg)
        return True

    def _forward_targets(self) -> Sequence[Any]:
        if self.feed == "ingress":
            return [_IngressView(self)]
        boxes = self.pool.mailboxes()
        if not boxes:
            return []
        return [_GuardedBox(self, b) for b in boxes]

    # -- harvest / publish / commit -------------------------------------------
    def _harvest_workers(self, now: float) -> None:
        del now
        for worker in self.pool.workers:
            take = getattr(worker, "take_ready", None)
            if take is not None:
                self._fresh.extend(take())

    def _take_results(self) -> List[Tuple[int, int, List[Any]]]:
        """(partition, offset, outputs) per finished input.  Adapter
        stages override this to harvest from their own pool."""
        out = []
        for msg, outputs in self._fresh:
            if msg.offset >= 0:
                out.append((msg.partition, msg.offset, outputs))
            else:
                # Injected message (no log source): publish-only, keyed
                # by msg_id so redelivery still cannot double-publish.
                out.append((-1, msg.msg_id, outputs))
        self._fresh = []
        return out

    def _publish_result(
        self, p: int, o: int, outputs: List[Any], now: float
    ) -> int:
        """Publish one finished input's outputs downstream (idempotent).
        Returns the number of messages actually appended; completion
        bookkeeping is the caller's (``_mark_done`` /
        ``_mark_done_batch``) — one batched pass per harvest."""
        n = len(outputs)
        from_log = p >= 0
        published = 0
        if self.out_topic is not None:
            for k, value in enumerate(outputs):
                if self._pub.seen((p, o, k)):
                    continue  # already durably downstream (idempotent)
                # Default key = provenance: downstream placement becomes
                # a pure function of the message's identity, never of
                # publish order — so a replayed run lands every message
                # in the same partition (bitwise-identical committed
                # offsets vs. an uninterrupted run).  Keyless round-robin
                # would re-deal the suffix differently after a restart.
                key = (
                    self.key_fn(value) if self.key_fn is not None
                    else f"{self.name}:{p}:{o}:{k}"
                )
                self.out_topic.publish(
                    Message(
                        topic=self.out_topic.name,
                        payload=value,
                        key=key,
                        created_at=now,
                        src=(self.name, p, o, k, n),
                    )
                )
                # _expected/_pubcount drive cross-life replay skipping,
                # which only applies to log-sourced inputs; injected
                # sources rely on the bounded _pub window alone (their
                # plain-dict entries would otherwise never be evicted —
                # the watermark only covers real partitions).
                if from_log:
                    self._pubcount[(p, o)] = self._pubcount.get((p, o), 0) + 1
                published += 1
            if from_log:
                self._expected[(p, o)] = n
        return published

    def _mark_done(self, partition: int, offset: int, now: float = 0.0) -> None:
        """Contiguous-prefix commit: the offset joins the done set; when
        the watermark advances, the virtual consumer durably commits and
        every dedup structure evicts below it (the O(uncommitted-suffix)
        memory bound)."""
        if partition < 0:
            return
        self._admitted.discard((partition, offset))
        t0 = self._forward_time.pop((partition, offset), None)
        if t0 is not None:
            self.completions.append(now - t0)
        self._done[partition].add(offset)
        w = self._watermark[partition]
        while w in self._done[partition]:
            self._done[partition].discard(w)
            w += 1
        if w != self._watermark[partition]:
            old = self._watermark[partition]
            self._watermark[partition] = w
            # The durable commit and dedup eviction are deferred to the
            # end of the publish/commit round (one journal append per
            # partition per step, not per offset; eviction addresses the
            # committed offsets directly instead of scanning every
            # window) — the state observable after every step() is
            # unchanged, and a restart in between merely replays a
            # slightly longer suffix through the admission dedup.
            lo, _ = self._evict_spans.get(partition, (old, old))
            self._evict_spans[partition] = (min(lo, old), w)

    def _mark_done_batch(
        self, done: Sequence[Tuple[int, int]], now: float
    ) -> None:
        """One harvest's worth of :meth:`_mark_done`, batched: per-result
        completion bookkeeping stays in result order (the ``completions``
        trace is order-sensitive), then each partition's done-set joins
        and watermark advance run once over the whole round instead of
        per offset.  Final state is identical to sequential
        ``_mark_done`` calls — the contiguous-prefix watermark is
        order-independent, and the evict span merges exactly as the
        per-advance updates would."""
        by_part: Dict[int, List[int]] = {}
        for p, o in done:
            self._admitted.discard((p, o))
            t0 = self._forward_time.pop((p, o), None)
            if t0 is not None:
                self.completions.append(now - t0)
            by_part.setdefault(p, []).append(o)
        for p, offsets in by_part.items():
            done_set = self._done[p]
            done_set.update(offsets)
            old = self._watermark[p]
            w = old
            while w in done_set:
                done_set.discard(w)
                w += 1
            if w != old:
                self._watermark[p] = w
                lo, _ = self._evict_spans.get(p, (old, old))
                self._evict_spans[p] = (min(lo, old), w)

    def _evict_committed(self, spans: Dict[int, Tuple[int, int]]) -> None:
        """Drop every dedup entry for the offsets committed this round
        (the ``DedupWindow`` memory invariant: a key below the committed
        watermark can never be redelivered).  The spans are known, so
        eviction is O(committed × workers) — addressed directly, never a
        scan over the windows."""
        windows = [
            worker.dedup for worker in self.pool.workers
            if isinstance(getattr(worker, "dedup", None), DedupWindow)
        ]
        for p, (lo, hi) in spans.items():
            for o in range(lo, hi):
                key = (p, o)
                n = self._expected.pop(key, None)
                self._pubcount.pop(key, None)
                for k in range(n if n is not None else 0):
                    self._pub.discard((p, o, k))
                for window in windows:
                    window.discard(key)

    def _publish_and_commit(self, now: float) -> None:
        results = self._take_results()
        if results:
            published = 0
            done: List[Tuple[int, int]] = []
            for p, o, outputs in results:
                published += self._publish_result(p, o, outputs, now)
                if p >= 0:
                    done.append((p, o))
            if published:
                self.pool.metrics.incr(self._m_published, published)
            if done:
                self._mark_done_batch(done, now)
        if self._evict_spans:
            spans, self._evict_spans = self._evict_spans, {}
            for vc in self.consumers.consumers:
                w = self._watermark.get(vc.partition, 0)
                if w > vc.offset:
                    vc.commit_to(w, now=now)
                    if self._write_behind is not None:
                        journal = self.consumers._journals.get(vc.partition)
                        ticket = getattr(journal, "last_ticket", None)
                        if ticket is not None:
                            self._commit_tickets.setdefault(
                                vc.partition, deque()
                            ).append((w, ticket))
            self._evict_committed(spans)

    # -- views ----------------------------------------------------------------
    @property
    def supervisor(self) -> Supervisor:
        return self.pool.supervisor

    def input_lag(self) -> int:
        return self.consumers.total_lag()

    def committed_offsets(self) -> Dict[int, int]:
        return {c.partition: c.offset for c in self.consumers.consumers}

    def durable_offsets(self) -> Dict[int, int]:
        """The commit watermark that is actually on disk.  Without
        write-behind journaling this equals :meth:`committed_offsets`;
        with it, each partition's watermark advances only as its
        journal-complete tickets resolve (FIFO, so the highest done
        ticket covers everything before it)."""
        if self._write_behind is None:
            return self.committed_offsets()
        for p, dq in self._commit_tickets.items():
            while dq and dq[0][1].done():
                offset, ticket = dq.popleft()
                if ticket.error is None:
                    self._durable[p] = offset
        out = {c.partition: self._durable.get(c.partition, 0)
               for c in self.consumers.consumers}
        return out

    def pending(self) -> int:
        """Work not yet durably downstream: unread input suffix + queued
        + in-flight + harvested-but-unpublished.  This is also the
        backpressure signal the graph feeds upstream."""
        return (
            self.input_lag()
            + self.pool.queue_depth()
            + self.pool.occupancy()
            + len(self._fresh)
        )

    def dedup_size(self) -> int:
        """Total dedup entries held (publish window + worker windows) —
        what the memory-bound property test watches."""
        total = len(self._pub) + len(self._admitted) + len(self._expected)
        for worker in self.pool.workers:
            window = getattr(worker, "dedup", None)
            if isinstance(window, DedupWindow):
                total += len(window)
        return total

    def outputs(self) -> List[Any]:
        """Values this stage has published, in per-partition order."""
        if self.out_topic is None:
            return []
        out = []
        for part in self.out_topic.partitions:
            for msg in part.read(0, part.end_offset()):
                if msg.src is not None and msg.src[0] == self.name:
                    out.append(msg.payload)
        return out

    # -- input / chaos ---------------------------------------------------------
    def submit(self, payload: Any, key: Optional[str] = None,
               now: float = 0.0) -> None:
        """Durably append an input to the stage's topic (head-of-graph
        convenience; inner stages are fed by their upstream stage)."""
        self.in_topic.publish(
            Message(topic=self.in_topic.name, payload=payload, key=key,
                    created_at=now)
        )

    def kill_worker(self, index: int = 0) -> str:
        return self.pool.kill_worker(index)

    def kill_all_workers(self) -> List[str]:
        return [self.pool.kill_worker(i) for i in range(len(self.pool.workers))]

    def close(self) -> None:
        if self._write_behind is not None:
            self._write_behind.flush()
        for journal in self.consumers._journals.values():
            journal.close()

    # -- main loop --------------------------------------------------------------
    def step(self, now: float = 0.0) -> int:
        """One stage round: beat + step virtual consumers (forward with
        admission dedup), report parked input lag and source saturation
        as rejected demand, run the pool, then publish-and-commit.
        Placement-aware stages gate consumers on their node's health and
        relocation warm-up; cost-metered stages budget the batch size
        from elapsed virtual time."""
        self._now = now
        if self.cluster is not None:
            for vc in self.consumers.consumers:
                if getattr(vc, "node", None) is None:
                    # Unplaced (the whole cluster was down): adopt the
                    # first healthy node that appears.
                    vc.node = self.cluster.place()
        for vc in self.consumers.consumers:
            if vc.alive and self._vc_up(vc):
                self.pool.supervisor.heartbeat(f"{self.name}:vc{vc.partition}", now)
        if self.consume_cost is not None and self.consume_cost > 0:
            self._meter_consumers(now)
        self.consumers.step_all(
            self._forward_targets(),
            now=now,
            gate=(
                (lambda c: self._vc_ready(c, now)) if self._gate_vcs else None
            ),
        )
        if self.source is not None:
            rejected = self.source.take_rejected()
            if rejected:
                self.pool.note_rejected(rejected)
        lag = self.input_lag()
        if lag and self.pool.elastic:
            self.pool.note_rejected(min(lag, self.autoscale_lag_cap))
        worked = self.pool.step(now)
        self._publish_and_commit(now)
        return worked


class StageGraph:
    """A DAG of stages over one message log, stepped under one clock.

    Wiring is by topic identity: ``downstream(A)`` is every stage whose
    input topic *is* A's output topic.  Add stages in topological order
    (upstream first) — the step order follows insertion order, and the
    paper's chains are acyclic by construction.

    **Backpressure** (on by default): each stage with downstreams gets a
    ``throttle`` hook on its pool.  When the summed downstream pending
    work crosses ``throttle_low`` the stage's unit target is frozen (no
    scale-out into a drowning consumer); past ``throttle_high`` it is
    clamped to one unit, which cascades — the now-slowed stage backs up
    its own input, throttling *its* upstream in turn, until the source
    itself is pacing at the bottleneck rate.  The intermediate topics
    then hold bounded lag instead of the whole imbalance
    (``benchmarks/bench_dataflow.py`` freezes the on/off comparison).
    """

    def __init__(
        self,
        log: MessageLog,
        *,
        backpressure: bool = True,
        throttle_low: int = 16,
        throttle_high: int = 64,
        timer: Optional[Any] = None,
    ) -> None:
        self.log = log
        self.backpressure = backpressure
        self.throttle_low = throttle_low
        self.throttle_high = throttle_high
        # Optional telemetry.StepTimer: per-stage step() wall-time.
        # Write-only bookkeeping — wiring one in changes no behavior.
        self.timer = timer
        self.stages: Dict[str, Any] = {}
        self.lag_log: List[Tuple[float, Dict[str, int]]] = []
        self.steps = 0

    # -- wiring ----------------------------------------------------------------
    def add(self, stage: Any) -> Any:
        if stage.name in self.stages:
            raise ValueError(f"stage {stage.name!r} already in graph")
        self.stages[stage.name] = stage
        self._rewire()
        return stage

    def stage(self, name: str) -> Any:
        return self.stages[name]

    def downstream(self, stage: Any) -> List[Any]:
        if stage.out_topic is None:
            return []
        return [
            s for s in self.stages.values()
            if s is not stage and s.in_topic is stage.out_topic
        ]

    def upstream(self, stage: Any) -> List[Any]:
        return [
            s for s in self.stages.values()
            if s is not stage and s.out_topic is stage.in_topic
        ]

    def _rewire(self) -> None:
        for s in self.stages.values():
            pool = getattr(s, "pool", None)
            if pool is None:
                continue
            if self.backpressure and self.downstream(s):
                pool.throttle = (lambda st=s: self._unit_cap(st))

    def _pressure_on(self, stage: Any) -> int:
        return sum(d.pending() for d in self.downstream(stage))

    def _unit_cap(self, stage: Any) -> Optional[int]:
        """The throttle policy: freeze above ``throttle_low``, clamp to
        one unit above ``throttle_high``, otherwise unthrottled."""
        pressure = self._pressure_on(stage)
        if pressure >= self.throttle_high:
            return 1
        if pressure >= self.throttle_low:
            return stage.pool.controller.target_size
        return None

    # -- views -----------------------------------------------------------------
    def pending(self) -> int:
        return sum(s.pending() for s in self.stages.values())

    def committed_offsets(self) -> Dict[str, Dict[int, int]]:
        return {
            name: s.committed_offsets() for name, s in self.stages.items()
        }

    def input_lags(self) -> Dict[str, int]:
        return {name: s.input_lag() for name, s in self.stages.items()}

    def peak_lag(self, stage_name: str) -> int:
        """Max input lag the named stage's topic reached during the run
        (the bounded-intermediate-topic claim of the throttle bench)."""
        return max(
            (lags.get(stage_name, 0) for _, lags in self.lag_log), default=0
        )

    def terminal_stages(self) -> List[Any]:
        return [s for s in self.stages.values() if not self.downstream(s)]

    # -- chaos ----------------------------------------------------------------
    def kill_worker(self, stage_name: str, index: int = 0) -> str:
        return self.stages[stage_name].kill_worker(index)

    def kill_stage(self, stage_name: str) -> List[str]:
        """Silence every worker of one stage at once (mid-chain chaos)."""
        return self.stages[stage_name].kill_all_workers()

    def close(self) -> None:
        for s in self.stages.values():
            close = getattr(s, "close", None)
            if close is not None:
                close()

    # -- main loop -------------------------------------------------------------
    def step(self, now: float = 0.0) -> int:
        worked = 0
        timer = self.timer
        if timer is not None:
            for name, s in self.stages.items():
                with timer.time(name):
                    worked += s.step(now)
        else:
            for s in self.stages.values():
                worked += s.step(now)
        self.lag_log.append(
            (now, {name: s.input_lag() for name, s in self.stages.items()})
        )
        self.steps += 1
        return worked

    def run_to_completion(
        self, max_rounds: int = 100_000, now: float = 0.0, dt: float = 1.0
    ) -> int:
        """Step until every stage is drained (two consecutive idle
        rounds with zero pending — the ReactiveJob termination rule)."""
        total = 0
        idle = 0
        for _ in range(max_rounds):
            n = self.step(now)
            total += n
            now += dt
            idle = idle + 1 if (n == 0 and self.pending() == 0) else 0
            if idle >= 2:
                break
        return total
