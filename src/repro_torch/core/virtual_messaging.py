"""Virtual messaging layer (paper §3.1, §3.2.3) — the core contribution.

One virtual topic per messaging-layer topic.  A virtual topic owns:

  * a **virtual consumer group** per subscribing job: at most
    ``num_partitions`` virtual consumers (that bound is fundamental — it
    comes from the log, not from us), each a cheap consume-and-forward
    loop that pulls batches of ``n`` messages from its partition and
    forwards them into per-task mailboxes via a pluggable
    message-distribution ``Scheduler``;
  * a **virtual producer group**: an elastic pool of producers that
    publish task results back to the messaging layer, load-balanced.

Because the forwarding step is much cheaper than processing, the task
pool behind the mailboxes can scale past ``num_partitions`` — the Liquid
limitation dissolves.  The cost is the mailbox waiting time ``t_wi`` of
paper Eq. (2); with the paper's load-blind forwarding it regresses
completion time (Fig. 11), which the JSQ/P2C schedulers fix (§5 open
problem, see ``repro_torch.core.scheduler``).

Virtual consumers are *stateful* workers: the committed offset is their
event-sourced state, so Let-It-Crash restart resumes exactly where the
crashed instance stopped (at-least-once; task-side dedup by ``msg_id`` is
available where exactly-once matters).
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.messages import Mailbox, MailboxOverflow, Message
from repro_torch.core.pool import ElasticPool, WorkerBase
from repro_torch.core.scheduler import LoadView, RoundRobinScheduler, Scheduler
from repro_torch.core.state import EventJournal, EventSourcedState
from repro_torch.data.topics import Topic


def _offset_reducer(state: Dict[str, int], ev) -> Dict[str, int]:
    if ev.kind == "committed":
        out = dict(state)
        out["offset"] = ev.data["offset"]
        return out
    return state


class VirtualConsumer:
    """Consume-and-forward worker bound to one partition.

    ``step`` pulls up to ``batch_size`` messages and forwards each via the
    scheduler into one of the task mailboxes, then commits the offset to
    its journal.  On restart, ``VirtualConsumer`` is rebuilt from the same
    journal and resumes from the committed offset.

    ``commit_policy`` selects when the journal records progress:

      * ``"on_forward"`` (default, paper-faithful) — delivery into a task
        mailbox *is* the commit.  Safe against component crashes (the
        mailboxes survive), lossy across a full-process crash.
      * ``"manual"`` — only the in-memory read ``position`` advances on
        forward; the owner calls :meth:`commit_to` once downstream work
        actually completes.  A rebuilt consumer resumes from the durable
        committed offset and re-reads the uncommitted suffix —
        at-least-once replay across *process* failure, which is what the
        log-backed serving path (``repro_torch.serving.job``) relies on.
    """

    def __init__(
        self,
        name: str,
        topic: Topic,
        partition: int,
        scheduler: Scheduler,
        batch_size: int = 8,
        journal: Optional[EventJournal] = None,
        commit_policy: str = "on_forward",
    ) -> None:
        if commit_policy not in ("on_forward", "manual"):
            raise ValueError(f"unknown commit_policy {commit_policy!r}")
        self.name = name
        self.topic = topic
        self.partition = partition
        self.scheduler = scheduler
        self.batch_size = batch_size
        self.commit_policy = commit_policy
        self.state = EventSourcedState({"offset": 0}, _offset_reducer, journal)
        self.position = self.offset  # read cursor (>= committed offset)
        self.forwarded = 0
        self.alive = True  # chaos hooks silence a consumer by clearing this

    @property
    def offset(self) -> int:
        return self.state.state["offset"]

    def lag(self) -> int:
        cursor = self.position if self.commit_policy == "manual" else self.offset
        return self.topic.partitions[self.partition].end_offset() - cursor

    def commit_to(self, offset: int, now: float = 0.0) -> None:
        """Durably commit progress (manual mode): only ever forward."""
        if offset > self.offset:
            self.state.record("committed", {"offset": offset}, timestamp=now)
        self.position = max(self.position, self.offset)

    # Vectorized forwarding (see core.scheduler module docstring); False
    # pins the scalar reference loop.
    vectorize = True

    def step(self, task_queues: Sequence[Mailbox], now: float = 0.0) -> int:
        """One consume-and-forward cycle; returns #messages forwarded."""
        if not task_queues or not self.alive:
            return 0
        start = self.position if self.commit_policy == "manual" else self.offset
        msgs = self.topic.partitions[self.partition].read(start, self.batch_size)
        if not msgs:
            return 0
        scheduler = self.scheduler
        if self.vectorize and scheduler.supports_batch and scheduler.msg_pure:
            # Depth-blind scheduler (round-robin / partition affinity —
            # the paper-faithful default): the whole batch pre-picks in
            # one call; a backpressure abort rewinds the unused picks so
            # the RNG/cursor state matches the scalar loop exactly.
            picks = scheduler.pick_batch(msgs, task_queues)
            delivered = 0
            for msg, idx in zip(msgs, picks):
                try:
                    task_queues[idx].put(msg)
                except MailboxOverflow:
                    scheduler.rewind(len(msgs) - delivered - 1)
                    break
                delivered += 1
        elif self.vectorize and scheduler.supports_batch and len(msgs) > 1:
            # Depth-aware scheduler: one depth snapshot per step (not per
            # message), then per-message picks against the array, noting
            # each delivery.  Identical to the scalar loop under
            # deterministic stepping: our own puts are the only depth
            # changes mid-batch, and the failing message's pick is drawn
            # (and not noted) exactly as the scalar path would.
            view = LoadView(task_queues, bind=False)
            delivered = 0
            for msg in msgs:
                idx = scheduler.pick_view(msg, view)
                try:
                    task_queues[idx].put(msg)
                except MailboxOverflow:
                    break
                view.note(idx, 1)
                delivered += 1
        else:
            delivered = 0
            for msg in msgs:
                idx = scheduler.pick_msg(msg, task_queues)
                try:
                    task_queues[idx].put(msg)
                except MailboxOverflow:
                    # Backpressure: stop forwarding; uncommitted suffix
                    # will be re-read next step. Commit only the
                    # delivered prefix.
                    break
                delivered += 1
        if delivered:
            if self.commit_policy == "manual":
                self.position = start + delivered
            else:
                self.state.record(
                    "committed", {"offset": start + delivered}, timestamp=now
                )
            self.forwarded += delivered
        return delivered


class VirtualConsumerGroup:
    """All virtual consumers a job holds against one topic.

    Membership is capped at ``topic.num_partitions`` — the residual, real
    constraint.  The group exposes aggregate lag for the elastic service.
    """

    def __init__(
        self,
        job_name: str,
        topic: Topic,
        scheduler_factory: Callable[[], Scheduler] = RoundRobinScheduler,
        batch_size: int = 8,
        journal_factory: Optional[Callable[[int], EventJournal]] = None,
        commit_policy: str = "on_forward",
    ) -> None:
        self.job_name = job_name
        self.topic = topic
        self.batch_size = batch_size
        self.scheduler_factory = scheduler_factory
        self.commit_policy = commit_policy
        # The journal is the component's *persistent* state: it outlives any
        # individual consumer instance (Let-It-Crash restarts get the same
        # journal back and replay it). Created once per partition.
        self._journals: Dict[int, EventJournal] = {
            p: (journal_factory(p) if journal_factory else EventJournal())
            for p in range(topic.num_partitions)
        }
        self.consumers: List[VirtualConsumer] = [
            self._make_consumer(p) for p in range(topic.num_partitions)
        ]

    def _make_consumer(self, partition: int) -> VirtualConsumer:
        return VirtualConsumer(
            name=f"vc:{self.job_name}:{self.topic.name}:{partition}",
            topic=self.topic,
            partition=partition,
            scheduler=self.scheduler_factory(),
            batch_size=self.batch_size,
            journal=self._journals[partition],
            commit_policy=self.commit_policy,
        )

    def restart_consumer(self, partition: int) -> VirtualConsumer:
        """Let-It-Crash: build a fresh instance; journal replay restores it."""
        self.consumers[partition] = self._make_consumer(partition)
        return self.consumers[partition]

    def step_all(
        self,
        task_queues: Sequence[Mailbox],
        now: float = 0.0,
        gate: Optional[Callable[[VirtualConsumer], bool]] = None,
    ) -> int:
        """Step every consumer; ``gate`` (when given) filters which ones
        may run this round — the placement-aware ``Stage`` uses it to
        silence consumers whose node is down or whose relocation warm-up
        has not elapsed."""
        return sum(
            c.step(task_queues, now)
            for c in self.consumers
            if gate is None or gate(c)
        )

    def total_lag(self) -> int:
        return sum(c.lag() for c in self.consumers)


class VirtualProducer(WorkerBase):
    """Publishes task output messages to the messaging layer (a pool
    worker: its inbox is the pool-managed mailbox)."""

    def __init__(self, name: str, topic: Topic) -> None:
        super().__init__(name)
        self.topic = topic
        self.inbox = self.mailbox  # historical alias
        self.published = 0
        self.step_budget = 32

    def step(self, now: float = 0.0) -> int:
        n = 0
        while n < self.step_budget:
            msg = self.inbox.get()
            if msg is None:
                break
            self.topic.publish(
                Message(
                    topic=self.topic.name,
                    payload=msg.payload,
                    key=msg.key,
                    created_at=msg.created_at,
                )
            )
            self.published += 1
            n += 1
        if n:
            # One counter bump per step, not per message (the CRDT incr
            # is a dict op but the f-string+lookup cost added up at
            # bench scale); the value at every step boundary is
            # identical to the per-message version.
            self.metrics.incr("vp.published", n)
        return n


class VirtualProducerGroup:
    """Elastic publisher pool: incoming results are balanced over producers.

    The group is the paper's "virtual producer pool ... responsible for
    distributing the messages and balancing the load among the virtual
    producers".  The pool mechanics — sizing, supervision, scale-in that
    drains victims into survivors without overflow — are the shared
    ``core.pool.ElasticPool`` runtime in manual-scaling mode; ``resize``
    is the elastic worker service's actuation point.
    """

    def __init__(
        self,
        topic: Topic,
        initial_size: int = 1,
        scheduler: Optional[Scheduler] = None,
        producer_capacity: int = 0,
    ) -> None:
        self.topic = topic
        self._ids = itertools.count()
        self.producer_capacity = producer_capacity
        # Demand that arrived while every live producer mailbox was at
        # capacity.  Delivery still happens (overflow-safe put_front —
        # accepted work is never dropped), but the saturation must be
        # *reported*: the owning stage feeds it to its autoscaler via
        # ``note_rejected`` (exactly as serving ingress does with topic
        # lag), so a saturated source stage is visible to the graph
        # instead of silently spinning at a fixed size.
        self.rejected = 0
        self._rejected_unreported = 0
        self.pool = ElasticPool(
            f"vp:{topic.name}",
            self._make_producer,
            scheduler=scheduler or RoundRobinScheduler(),
            initial_units=max(1, initial_size),
            elastic=False,
            retire_mode="redistribute",
            metric_prefix="vp",
            worker_noun="producer",
        )

    def _make_producer(self) -> VirtualProducer:
        producer = VirtualProducer(
            f"vp:{self.topic.name}:{next(self._ids)}", self.topic
        )
        if self.producer_capacity > 0:
            producer.mailbox.capacity = self.producer_capacity
            producer.inbox = producer.mailbox
        return producer

    @property
    def producers(self) -> List[VirtualProducer]:
        return self.pool.workers

    @property
    def scheduler(self) -> Scheduler:
        return self.pool.scheduler

    def resize(self, n: int) -> None:
        self.pool.set_target_units(max(1, n))
        # A shrink can leave the survivors saturated (the victims' work
        # redistributes into bounded mailboxes): report the overage as
        # rejected demand so the decision is visible as pressure, not
        # discovered later as a stall.
        if self.producer_capacity > 0:
            over = sum(
                max(p.mailbox.depth() - self.producer_capacity, 0)
                for p in self.pool.active_workers()
            )
            if over:
                self._note_rejected(over)

    def _note_rejected(self, n: int) -> None:
        self.rejected += n
        self._rejected_unreported += n
        self.pool.note_rejected(n)
        self.pool.metrics.incr("vp.rejected", n)

    def take_rejected(self) -> int:
        """Drain the unreported rejected-demand count (stage wiring:
        the owner forwards it into its own pool's ``note_rejected``)."""
        n, self._rejected_unreported = self._rejected_unreported, 0
        return n

    def submit(self, msg: Message) -> None:
        if self.producer_capacity > 0:
            boxes = [
                p.mailbox for p in (self.pool.active_workers() or self.producers)
            ]
            if boxes and all(
                b.capacity > 0 and b.depth() >= b.capacity for b in boxes
            ):
                self._note_rejected(1)
        self.pool.route(msg)

    def step_all(self, max_messages: int = 32) -> int:
        # Step the workers directly rather than through pool.step():
        # callers drive this once per pipeline round with no clock, so
        # the pool's supervision/gauge/occupancy-log machinery would
        # only accumulate state at a frozen timestamp.  Lifecycle
        # (spawn/retire/drain) still belongs exclusively to the pool.
        n = 0
        for p in self.producers:
            if p.alive:
                p.step_budget = max_messages
                n += p.step(0.0)
        return n

    def pending(self) -> int:
        return sum(p.inbox.depth() for p in self.producers)


class VirtualTopic:
    """One virtual topic: consumer groups per subscribing job + producer group."""

    def __init__(self, topic: Topic) -> None:
        self.topic = topic
        self.consumer_groups: Dict[str, VirtualConsumerGroup] = {}
        self.producer_group = VirtualProducerGroup(topic)

    def subscribe(
        self,
        job_name: str,
        scheduler_factory: Callable[[], Scheduler] = RoundRobinScheduler,
        batch_size: int = 8,
        journal_factory: Optional[Callable[[int], EventJournal]] = None,
        commit_policy: str = "on_forward",
    ) -> VirtualConsumerGroup:
        """One consumer group per subscriber: each stage of a dataflow
        graph subscribing the same topic gets independent offsets, which
        is what makes topic-level fan-out (two stages, one topic) safe.
        Stages subscribe with ``commit_policy="manual"`` so offsets
        advance only when the stage's results are durably downstream."""
        group = VirtualConsumerGroup(
            job_name,
            self.topic,
            scheduler_factory=scheduler_factory,
            batch_size=batch_size,
            journal_factory=journal_factory,
            commit_policy=commit_policy,
        )
        self.consumer_groups[job_name] = group
        return group
