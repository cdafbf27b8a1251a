"""Liquid vs Reactive live pipelines + the paper's structural claims."""

from repro_torch.core.liquid import LiquidJob
from repro_torch.core.messages import Message
from repro_torch.core.reactive import ReactiveJob
from repro_torch.data.topics import MessageLog


def fill(log: MessageLog, topic: str, n: int, partitions: int = 3) -> None:
    if not log.exists(topic):
        log.create_topic(topic, partitions)
    for i in range(n):
        log.publish(topic, payload=i)


def double(msg: Message):
    return [msg.payload * 2]


def test_liquid_active_task_limit():
    """Six tasks, three partitions: only three make progress (Fig. 2)."""
    log = MessageLog()
    fill(log, "in", 60, partitions=3)
    job = LiquidJob("j", log, "in", double, num_tasks=6)
    assert job.active_tasks == 3
    job.run_to_completion()
    worked = [t.stats.processed for t in job.tasks]
    assert sum(1 for w in worked if w > 0) == 3
    assert sum(worked) == 60


def test_liquid_processes_everything_and_publishes():
    log = MessageLog()
    fill(log, "in", 30, partitions=3)
    log.create_topic("out", 3)
    job = LiquidJob("j", log, "in", double, out_topic="out", num_tasks=3)
    job.run_to_completion()
    assert job.total_processed() == 30
    assert log.get("out").total_messages() == 30


def test_reactive_all_tasks_work_past_partition_limit():
    """Eight tasks on a three-partition topic all receive work."""
    log = MessageLog()
    fill(log, "in", 160, partitions=3)
    job = ReactiveJob("j", log, "in", double, initial_tasks=8, elastic=False)
    job.run_to_completion()
    assert job.total_processed() == 160
    worked = [t.stats.processed for t in job.tasks if t.stats.processed > 0]
    assert len(worked) >= 6  # strictly more than the partition count


def test_reactive_publishes_results():
    log = MessageLog()
    fill(log, "in", 40, partitions=2)
    log.create_topic("out", 2)
    job = ReactiveJob("j", log, "in", double, out_topic="out", initial_tasks=4)
    job.run_to_completion()
    assert log.get("out").total_messages() == 40
    outs = set()
    for p in log.get("out").partitions:
        outs.update(m.payload for m in p.read(0, 1000))
    assert outs == {2 * i for i in range(40)}


def test_reactive_task_crash_heals_and_loses_nothing():
    """Kill a task mid-stream: supervisor restarts it, mailbox moves over,
    dedup prevents double effects."""
    log = MessageLog()
    fill(log, "in", 120, partitions=3)
    seen = []
    job = ReactiveJob("j", log, "in", lambda m: (seen.append(m.payload), [])[1],
                      initial_tasks=4, heartbeat_timeout=2.0)
    job.step(now=0.0)
    victim = job.tasks[0]
    victim.alive = False  # crash: stops processing + heartbeating
    t = 0.0
    for r in range(1, 400):
        t += 1.0
        job.step(now=t)
        if job.backlog() == 0:
            break
    assert any(e[1] == "restarted" for e in job.supervisor.events)
    assert job.backlog() == 0
    assert sorted(seen) == sorted(range(120))  # nothing lost, nothing doubled


def test_reactive_consumer_crash_resumes_from_offset():
    log = MessageLog()
    fill(log, "in", 90, partitions=3)
    got = []
    job = ReactiveJob("j", log, "in", lambda m: (got.append(m.payload), [])[1],
                      initial_tasks=3, heartbeat_timeout=2.0)
    job.step(now=0.0)
    job.consumer_group.consumers[0].alive = False  # crash a virtual consumer
    t = 0.0
    for _ in range(400):
        t += 1.0
        job.step(now=t)
        if job.backlog() == 0:
            break
    assert job.backlog() == 0
    assert sorted(got) == sorted(range(90))


def test_reactive_elastic_scale_out_and_in():
    log = MessageLog()
    fill(log, "in", 400, partitions=2)
    from repro_torch.core.elastic import AutoscalerConfig

    job = ReactiveJob(
        "j", log, "in", double, initial_tasks=2,
        autoscaler=AutoscalerConfig(
            high_watermark=8, low_watermark=1, min_workers=2,
            max_workers=16, cooldown=0.0,
        ),
        batch_n=50,
    )
    t = 0.0
    peak = 2
    for _ in range(200):
        t += 1.0
        job.step(now=t, task_budget=2)  # slow tasks -> backlog builds
        peak = max(peak, len(job.tasks))
        if job.backlog() == 0:
            break
    assert peak > 2  # scaled out under backlog
    for _ in range(10):
        t += 1.0
        job.step(now=t)
    assert len(job.tasks) <= peak  # scaled (or scaling) back in when idle
    assert job.total_processed() == 400
