"""The shared ElasticPool runtime: generic worker-pool mechanics, the
bounded-mailbox scale-in/restart overflow fix, and lossless CRDT
telemetry across chaos kills (paper §3.2.2–§3.2.4)."""

import itertools

import pytest

from repro_torch.core.elastic import AutoscalerConfig
from repro_torch.core.messages import Mailbox, MailboxOverflow, Message
from repro_torch.core.pool import DedupWindow, ElasticPool, WorkerBase
from repro_torch.core.reactive import ReactiveJob
from repro_torch.data.topics import MessageLog
from repro_torch.telemetry.metrics import MetricsHub


class EchoWorker(WorkerBase):
    """Minimal pool worker: consumes its mailbox, records payloads."""

    _ids = itertools.count()

    def __init__(self, sink, budget=4, capacity=0):
        super().__init__(f"echo{next(EchoWorker._ids)}",
                         mailbox_capacity=capacity)
        self.sink = sink
        self.budget = budget

    def step(self, now: float = 0.0) -> int:
        n = 0
        while n < self.budget and self.alive:
            msg = self.mailbox.get()
            if msg is None:
                break
            self.sink.append(msg.payload)
            self.metrics.incr("task.processed")
            n += 1
        return n


def fill(log: MessageLog, topic: str, n: int, partitions: int = 3) -> None:
    if not log.exists(topic):
        log.create_topic(topic, partitions)
    for i in range(n):
        log.publish(topic, payload=i)


# --- generic pool mechanics ---------------------------------------------------


def test_pool_dispatches_ingress_to_workers():
    sink = []
    pool = ElasticPool("p", lambda: EchoWorker(sink), initial_units=3,
                       ingress_capacity=0, elastic=False)
    for i in range(12):
        assert pool.offer(Message(topic="t", payload=i))
    for t in range(4):
        pool.step(float(t))
    assert sorted(sink) == list(range(12))
    assert pool.counter("pool.admitted") == 12
    assert pool.counter("task.processed") == 12


def test_pool_bounded_ingress_shed_and_defer_feed_autoscaler():
    sink = []
    pool = ElasticPool("p", lambda: EchoWorker(sink, budget=0),
                       initial_units=1, ingress_capacity=2, overflow="shed",
                       autoscaler=AutoscalerConfig(
                           high_watermark=1.0, low_watermark=-1.0,
                           cooldown=0.0, max_workers=4),
                       max_workers=4)
    accepted = [pool.offer(Message(topic="t", payload=i)) for i in range(6)]
    assert sum(accepted) == 2
    assert len(pool.shed) == 4
    assert pool.counter("pool.shed") == 4
    # rejected demand reaches the controller even though the ingress is full
    pool.step(0.0)
    assert pool.target_units() > 1
    assert pool.counter("pool.scale_out") >= 1

    defer = ElasticPool("q", lambda: EchoWorker(sink, budget=0),
                        initial_units=1, ingress_capacity=1, overflow="defer")
    assert defer.offer(Message(topic="t", payload=0))
    assert not defer.offer(Message(topic="t", payload=1))
    assert not defer.shed  # defer never drops: the caller owns the retry
    assert defer.counter("pool.deferred") == 1


def test_pool_unknown_overflow_and_retire_mode_rejected():
    with pytest.raises(ValueError):
        ElasticPool("p", lambda: EchoWorker([]), overflow="explode")
    with pytest.raises(ValueError):
        ElasticPool("p", lambda: EchoWorker([]), retire_mode="vanish")


def test_pool_kill_worker_readmits_without_loss():
    sink = []
    pool = ElasticPool("p", lambda: EchoWorker(sink, budget=1),
                       initial_units=2, ingress_capacity=0,
                       elastic=False, heartbeat_timeout=2.0)
    for i in range(10):
        pool.offer(Message(topic="t", payload=i))
    pool.step(0.0)
    killed = pool.kill_worker(0)
    now = 1.0
    for _ in range(40):
        if pool.queue_depth() == 0:
            break
        pool.step(now)
        now += 1.0
    assert sorted(sink) == list(range(10))
    assert pool.counter("pool.worker_restarts") == 1
    assert pool.counter("pool.readmitted") > 0
    assert any(e[1] == "restarted" and e[2] == killed
               for e in pool.supervisor.events)


def test_route_with_all_workers_dead_parks_message():
    """route() with every worker dead must not crash the *sender*: the
    message parks in a dead worker's mailbox and survives until the
    supervisor's restart drain (it is never lost)."""
    from repro_torch.core.virtual_messaging import VirtualProducerGroup
    from repro_torch.data.topics import Topic

    out = Topic("out", 1)
    pg = VirtualProducerGroup(out, initial_size=1)
    pg.producers[0].alive = False
    pg.submit(Message(topic="out", payload=1))  # must not raise
    assert pg.pending() == 1
    pg.step_all()
    assert out.total_messages() == 0  # dead producer does not publish
    pg.producers[0].alive = True
    pg.step_all()
    assert out.total_messages() == 1


def test_dedup_window_bounded():
    d = DedupWindow(window=4)
    assert not d.seen(1)
    assert d.seen(1)
    for k in range(2, 8):
        d.seen(k)
    assert len(d) <= 5  # overflow dropped the oldest half
    assert not d.seen(1)  # evicted: counts as new again (at-least-once)


# --- the scale-in / restart overflow fix --------------------------------------


def test_bounded_mailbox_scale_in_8_to_1_does_not_overflow():
    """Regression: retiring tasks used Mailbox.put to
    redistribute drained messages, which raised MailboxOverflow when the
    survivors' bounded mailboxes were already full — crashing scale-in
    mid-drain.  Now the drain spills overflow-safely and nothing is
    lost."""
    log = MessageLog()
    fill(log, "in", 120, partitions=3)
    seen = []
    job = ReactiveJob(
        "j", log, "in", lambda m: (seen.append(m.payload), [])[1],
        initial_tasks=8,
        mailbox_capacity=2,
        batch_n=40,
        autoscaler=AutoscalerConfig(
            # low_watermark above any realistic backlog: every observation
            # demands scale-in, so 8 tasks collapse toward 1 while their
            # bounded mailboxes are still loaded.
            high_watermark=1e9, low_watermark=1e9,
            min_workers=1, max_workers=8, cooldown=0.0, step_fraction=1.0,
        ),
    )
    t = 0.0
    for _ in range(400):
        t += 1.0
        job.step(now=t, task_budget=1)
        if job.backlog() == 0:
            break
    assert len(job.tasks) == 1  # scaled all the way in under load
    assert sorted(seen) == sorted(range(120))  # nothing lost, nothing doubled
    assert job.total_processed() == 120


def test_bounded_mailbox_restart_does_not_overflow():
    """A task killed while its bounded mailbox is full (plus put_front
    overage) must restart without raising: pending messages move to the
    fresh instance, overflow spills to the survivors."""
    log = MessageLog()
    fill(log, "in", 60, partitions=3)
    seen = []
    job = ReactiveJob(
        "j", log, "in", lambda m: (seen.append(m.payload), [])[1],
        initial_tasks=4, mailbox_capacity=2, batch_n=30,
        heartbeat_timeout=2.0, elastic=False,
    )
    job.step(now=0.0, task_budget=1)
    victim = job.tasks[0]
    victim.mailbox.put_front(Message(topic="in", payload=999))  # over the bound
    victim.alive = False
    t = 0.0
    for _ in range(400):
        t += 1.0
        job.step(now=t, task_budget=1)
        if job.backlog() == 0:
            break
    assert job.backlog() == 0
    assert sorted(p for p in seen if p != 999) == sorted(range(60))
    assert 999 in seen  # the over-bound message survived the restart too


# --- CRDT telemetry through the unified pool ----------------------------------


def test_reactive_job_metrics_merge_losslessly_across_chaos_kill():
    """ReactiveJob now emits CRDT telemetry via ElasticPool (it emitted
    none before the re-base): admission/restart/processed counters from
    live workers, dead workers (graveyard), and the pool replica merge
    losslessly into a MetricsHub across a chaos kill."""
    log = MessageLog()
    fill(log, "in", 120, partitions=3)
    job = ReactiveJob("j", log, "in", lambda m: [m.payload],
                      out_topic=None, initial_tasks=4, heartbeat_timeout=2.0)
    job.step(now=0.0)
    job.tasks[0].alive = False  # chaos kill mid-stream
    t = 0.0
    for _ in range(400):
        t += 1.0
        job.step(now=t)
        if job.backlog() == 0:
            break
    assert any(e[1] == "restarted" for e in job.supervisor.events)

    hub = MetricsHub()
    # Merge in arbitrary pieces, twice (merge is commutative/idempotent —
    # re-merging a restarted worker's replica must not double-count).
    for task in job.tasks:
        hub.ingest(task.metrics)
    hub.ingest(job.pool.graveyard)
    hub.ingest(job.pool.metrics)
    hub.ingest(job.pool.merged_metrics())  # everything again, at once
    assert hub.counter("task.processed") == 120 == job.total_processed()
    assert hub.counter("job.task_restarts") == 1
    assert hub.counter("job.task_spawns") >= 4


# Not twinned yet: the stub-serving case
# (tests/test_pool.py::test_serving_pool_metrics_merge_losslessly_across_chaos_kill)
# waits for the elastic serving stack (ROADMAP A4), and the two live worker
# handoff cases (::test_worker_handoff_carries_results_and_filters_readmission,
# ::test_worker_handoff_marks_done_exactly_once) wait for checkpoint and
# handoff (ROADMAP A7).
