"""Messaging + virtual-messaging layer: Kafka semantics, the Liquid task
limit, and the Reactive decoupling that removes it (the paper's core claim
at the mechanism level)."""

import pytest
from _hypothesis_support import given, settings, st

from repro_torch.core.messages import Mailbox, MailboxOverflow, Message, MessageBus
from repro_torch.core.scheduler import (
    JoinShortestQueueScheduler,
    PowerOfTwoScheduler,
    RoundRobinScheduler,
    make_scheduler,
)
from repro_torch.core.state import EventJournal
from repro_torch.core.virtual_messaging import (
    VirtualConsumerGroup,
    VirtualProducerGroup,
    VirtualTopic,
)
from repro_torch.data.topics import ConsumerGroup, MessageLog, Topic


def make_topic(n_messages=30, partitions=3, name="in") -> Topic:
    t = Topic(name, partitions)
    for i in range(n_messages):
        t.publish(Message(topic=name, payload=i))
    return t


# --- messaging layer ---------------------------------------------------------


def test_partition_order_and_offsets():
    t = make_topic(30, 3)
    for p in t.partitions:
        msgs = p.read(0, 100)
        assert [m.offset for m in msgs] == list(range(len(msgs)))
        # round-robin publish => payload stride == partition count
        payloads = [m.payload for m in msgs]
        assert payloads == sorted(payloads)


def test_keyed_messages_land_in_one_partition():
    t = Topic("keyed", 4)
    for i in range(20):
        t.publish(Message(topic="keyed", payload=i, key="same-key"))
    non_empty = [p for p in t.partitions if len(p) > 0]
    assert len(non_empty) == 1
    assert len(non_empty[0]) == 20


def test_consumer_group_member_limit():
    """Kafka semantics: at most num_partitions members receive work."""
    t = make_topic(30, 3)
    g = ConsumerGroup("g", t)
    assert g.active_members(6) == 3  # the Liquid limitation (Fig. 2)
    assignment = g.assign(6)
    assert set(assignment.values()) == {0, 1, 2}


def test_at_least_once_redelivery():
    t = make_topic(10, 1)
    g = ConsumerGroup("g", t)
    c = g.consumer_for(0)
    first = c.poll(5)
    assert len(first) == 5
    c.rewind_to_committed()  # crash before commit
    again = c.poll(5)
    assert [m.payload for m in again] == [m.payload for m in first]
    c.commit()
    rest = c.poll(100)
    assert len(rest) == 5


def test_mailbox_backpressure():
    box = Mailbox("t", capacity=2)
    box.put(Message(topic="x", payload=1))
    box.put(Message(topic="x", payload=2))
    with pytest.raises(MailboxOverflow):
        box.put(Message(topic="x", payload=3))
    assert box.dropped == 1


def test_message_bus_location_transparency():
    bus = MessageBus()
    bus.register("worker-1")
    assert bus.send("worker-1", Message(topic="t", payload=1))
    assert not bus.send("worker-404", Message(topic="t", payload=2))
    assert bus.dead_letter_count() == 1
    # re-home the address: senders don't change
    bus.unregister("worker-1")
    fresh = bus.register("worker-1")
    assert bus.send("worker-1", Message(topic="t", payload=3))
    assert fresh.depth() == 1


# --- virtual messaging layer ---------------------------------------------------


def test_tasks_scale_past_partitions():
    """THE core mechanism: 3 partitions, 8 tasks, all 8 receive work."""
    t = make_topic(64, 3)
    group = VirtualConsumerGroup("job", t, batch_size=8)
    queues = [Mailbox(f"task{i}") for i in range(8)]
    while group.step_all(queues) > 0:
        pass
    assert group.total_lag() == 0
    depths = [q.enqueued for q in queues]
    assert all(d > 0 for d in depths), depths
    assert sum(depths) == 64


def test_virtual_consumer_count_capped_at_partitions():
    t = make_topic(10, 3)
    group = VirtualConsumerGroup("job", t)
    assert len(group.consumers) == 3  # bounded by the log, as in the paper


def test_virtual_consumer_restart_resumes_from_committed_offset(tmp_path):
    t = make_topic(40, 1)
    journals = {}

    def journal_factory(partition):
        journals[partition] = EventJournal(str(tmp_path / f"vc{partition}.jsonl"))
        return journals[partition]

    group = VirtualConsumerGroup(
        "job", t, batch_size=10, journal_factory=journal_factory
    )
    queues = [Mailbox("task0")]
    group.step_all(queues)
    assert group.consumers[0].offset == 10
    # Let-It-Crash: rebuild the consumer; journal replay restores the offset.
    journals[0].close()
    vc2 = group.restart_consumer(0)
    assert vc2.offset == 10
    group.step_all(queues)
    assert vc2.offset == 20
    # No duplicates were forwarded.
    payloads = []
    while True:
        m = queues[0].get()
        if m is None:
            break
        payloads.append(m.payload)
    assert payloads == list(range(20))


def test_backpressure_stops_forwarding_and_commits_prefix():
    t = make_topic(20, 1)
    group = VirtualConsumerGroup("job", t, batch_size=10)
    tiny = [Mailbox("task0", capacity=3)]
    group.step_all(tiny)
    assert group.consumers[0].offset == 3  # only the delivered prefix commits
    # drain and continue
    for _ in range(3):
        tiny[0].get()
    group.step_all(tiny)
    assert group.consumers[0].offset == 6


def test_virtual_producer_group_balances_and_publishes():
    out = Topic("out", 2)
    pg = VirtualProducerGroup(out, initial_size=3)
    for i in range(12):
        pg.submit(Message(topic="out", payload=i))
    per_producer = [p.inbox.depth() for p in pg.producers]
    assert per_producer == [4, 4, 4]  # round-robin balance
    pg.step_all()
    assert out.total_messages() == 12
    # scale-in drains victims into survivors
    for i in range(4):
        pg.submit(Message(topic="out", payload=100 + i))
    pg.resize(1)
    assert pg.pending() == 4
    pg.step_all()
    assert out.total_messages() == 16


# --- schedulers ---------------------------------------------------------------


class _Q:
    def __init__(self, d):
        self._d = d

    def depth(self):
        return self._d


def test_round_robin_cycles():
    s = RoundRobinScheduler()
    qs = [_Q(0)] * 4
    assert [s.pick(qs) for _ in range(6)] == [0, 1, 2, 3, 0, 1]


def test_jsq_picks_minimum():
    s = JoinShortestQueueScheduler()
    assert s.pick([_Q(5), _Q(2), _Q(9), _Q(2)]) == 1  # min, lowest index tie


@given(st.lists(st.integers(0, 100), min_size=2, max_size=16), st.integers(0, 1000))
def test_pow2_never_picks_strictly_worse_than_both_samples(depths, seed):
    qs = [_Q(d) for d in depths]
    s = PowerOfTwoScheduler(seed=seed)
    for _ in range(20):
        i = s.pick(qs)
        assert 0 <= i < len(depths)


@settings(max_examples=25)
@given(st.integers(2, 12), st.integers(50, 200), st.integers(0, 10))
def test_jsq_balances_better_than_rr_with_heterogeneous_drain(n, msgs, seed):
    """With one stuck queue, JSQ avoids it; RR keeps feeding it."""
    import random

    rng = random.Random(seed)
    stuck = rng.randrange(n)

    def run(sched):
        boxes = [Mailbox(f"q{i}") for i in range(n)]
        for _ in range(msgs):
            idx = sched.pick(boxes)
            boxes[idx].put(Message(topic="t", payload=0))
            for j, b in enumerate(boxes):  # everyone but `stuck` drains
                if j != stuck:
                    b.get()
        return boxes[stuck].depth()

    assert run(JoinShortestQueueScheduler()) <= run(RoundRobinScheduler())


def test_pow2_prefers_shorter_queue_smoke():
    """Deterministic pow2 check; runs without hypothesis."""
    s = PowerOfTwoScheduler(seed=0)
    qs = [_Q(50), _Q(0), _Q(50), _Q(50)]
    picks = [s.pick(qs) for _ in range(32)]
    assert all(0 <= i < 4 for i in picks)
    # whenever queue 1 is sampled it wins; over 32 picks it must show up
    assert picks.count(1) > 0


def test_make_scheduler_registry():
    assert make_scheduler("round_robin").name == "round_robin"
    assert make_scheduler("jsq").name == "jsq"
    assert make_scheduler("pow2").name == "pow2"
    with pytest.raises(ValueError):
        make_scheduler("nope")
