"""Faithful Liquid baseline pipeline (Fernandez et al., CIDR'15).

The paper compares against Liquid, so we implement it too: jobs whose
tasks consume topic partitions *directly* through Kafka consumer-group
semantics.  The structural property under test: **at most
``num_partitions`` tasks of a job make progress** — extra tasks idle
(paper Fig. 2).

This is the live, step-driven implementation used by tests, the TCMM
example, and the throughput benchmarks' sanity checks; the timing model
for the paper's figures (a discrete-event simulator) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.messages import Message
from repro_torch.data.topics import ConsumerGroup, MessageLog, PartitionConsumer, Topic

# A task processes one message and optionally emits output payloads.
ProcessFn = Callable[[Message], List[Any]]


@dataclass
class LiquidTaskStats:
    consumed: int = 0
    processed: int = 0
    emitted: int = 0


class LiquidTask:
    """One task: owns >= 0 partitions, consume-then-process in batches."""

    def __init__(
        self,
        name: str,
        consumers: List[PartitionConsumer],
        process: ProcessFn,
        out_topic: Optional[Topic],
        batch_n: int = 10,
    ) -> None:
        self.name = name
        self.consumers = consumers
        self.process = process
        self.out_topic = out_topic
        self.batch_n = batch_n
        self.stats = LiquidTaskStats()

    @property
    def active(self) -> bool:
        """A task with no partitions is idle — the Liquid limitation."""
        return bool(self.consumers)

    def step(self) -> int:
        """Consume up to batch_n messages, process them all, commit."""
        if not self.active:
            return 0
        batch: List[Message] = []
        for c in self.consumers:
            if len(batch) >= self.batch_n:
                break
            batch.extend(c.poll(self.batch_n - len(batch)))
        self.stats.consumed += len(batch)
        for msg in batch:
            outputs = self.process(msg)
            self.stats.processed += 1
            if self.out_topic is not None:
                for payload in outputs:
                    self.out_topic.publish(
                        Message(
                            topic=self.out_topic.name,
                            payload=payload,
                            created_at=msg.created_at,
                        )
                    )
                    self.stats.emitted += 1
        for c in self.consumers:
            c.commit()
        return len(batch)


class LiquidJob:
    """A job: ``num_tasks`` tasks over one input topic via a consumer group."""

    def __init__(
        self,
        name: str,
        log: MessageLog,
        in_topic: str,
        process: ProcessFn,
        out_topic: Optional[str] = None,
        num_tasks: int = 3,
        batch_n: int = 10,
    ) -> None:
        self.name = name
        self.log = log
        self.topic = log.get(in_topic)
        self.out_topic = log.get(out_topic) if out_topic else None
        self.group = ConsumerGroup(f"{name}-group", self.topic)
        assignment = self.group.assign(num_tasks)  # partition -> member
        members: Dict[int, List[PartitionConsumer]] = {m: [] for m in range(num_tasks)}
        for partition, member in assignment.items():
            members[member].append(self.group.consumer_for(partition))
        self.tasks = [
            LiquidTask(f"{name}:task{m}", members[m], process, self.out_topic, batch_n)
            for m in range(num_tasks)
        ]

    @property
    def active_tasks(self) -> int:
        return sum(1 for t in self.tasks if t.active)

    def step(self) -> int:
        """One round over all tasks; returns messages processed."""
        return sum(t.step() for t in self.tasks)

    def run_to_completion(self, max_rounds: int = 1_000_000) -> int:
        total = 0
        for _ in range(max_rounds):
            n = self.step()
            total += n
            if n == 0:
                break
        return total

    def total_processed(self) -> int:
        return sum(t.stats.processed for t in self.tasks)
