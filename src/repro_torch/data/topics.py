"""Messaging layer (paper §3.2.1): a partitioned, topic-based, append-only
pub/sub log with Kafka's observable semantics.

Semantics preserved from Kafka (these are what the paper's argument
depends on — see DESIGN.md assumption notes):

  * a topic has a fixed number of partitions; messages are appended to a
    partition chosen by key-hash (or round-robin for keyless messages);
  * per-partition total order; offsets are dense integers;
  * consumers pull by (partition, offset); consumption never deletes;
  * a consumer group assigns each partition to exactly one member, so
    **at most `num_partitions` members of a group are active** — the
    Liquid limitation the paper removes with the virtual messaging layer;
  * consumption is at-least-once: a consumer that crashes before
    committing its offset re-reads from the last committed offset.

The log is in-memory by default with optional file spill (line-delimited
JSON — zero extra deps) so a restarted *process* can ``MessageLog.reopen``
the directory and recover every topic, partition, and message: this is
what gives a log-backed job durable replay after full-process
failure.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence

from repro_torch.core.messages import Message

_MANIFEST = "topics.json"


def partition_for_key(key: str, num_partitions: int) -> int:
    """Deterministic key → partition placement (blake2s hash).

    This is the inter-stage re-partitioning contract: every stage that
    publishes with the same key lands in the same partition of the
    downstream topic, so keyed fan-in from multiple upstream stages
    preserves per-key ordering, and a downstream consumer group sees one
    total order per key.  Shared by ``Topic.publish`` and the dataflow
    layer's keyed stages (``core.dataflow.Stage`` ``key_fn``).
    """
    digest = hashlib.blake2s(key.encode("utf-8"), digest_size=8).digest()
    return int.from_bytes(digest, "little") % max(num_partitions, 1)


def _recover_spill_lines(path: str) -> tuple[List[dict], int]:
    """Read a JSONL spill file, tolerating a torn trailing line.

    A process killed mid-append leaves a final line that is truncated
    (no newline, or malformed JSON).  That trailing fragment is *not*
    data — the append never completed, so the message was never durably
    published and its producer will replay it.  Returns the parsed
    complete records plus the byte length of the valid prefix; a torn
    line anywhere *before* the tail is real corruption and raises.
    """
    records: List[dict] = []
    valid_bytes = 0
    with open(path, "rb") as fh:
        raw = fh.read()
    for line in raw.splitlines(keepends=True):
        stripped = line.strip()
        if not stripped:
            valid_bytes += len(line)
            continue
        try:
            d = json.loads(stripped.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            if valid_bytes + len(line) == len(raw):
                break  # torn tail: truncate to the last complete record
            raise ValueError(
                f"corrupt spill record mid-file in {path!r} "
                f"(byte {valid_bytes}): not a torn tail, refusing to drop data"
            )
        if not line.endswith(b"\n") and valid_bytes + len(line) == len(raw):
            # Complete JSON but no newline: the append was cut between
            # the payload write and the terminator.  The *next* append
            # would otherwise concatenate onto it and poison replay.
            break
        records.append(d)
        valid_bytes += len(line)
    return records, valid_bytes


class Partition:
    """A single append-only, totally-ordered message sequence.

    With ``spill_path`` set, every append is also written (and flushed)
    as one JSON line — payloads must then be JSON-serializable.  Crash
    recovery re-reads the file; offsets are line numbers, so the durable
    and in-memory views agree by construction.
    """

    def __init__(self, topic: str, index: int,
                 spill_path: Optional[str] = None) -> None:
        self.topic = topic
        self.index = index
        self._entries: List[Message] = []
        self._lock = threading.Lock()
        self._spill_path = spill_path
        self._spill_fh = None
        if spill_path is not None:
            if os.path.exists(spill_path):
                records, valid_bytes = _recover_spill_lines(spill_path)
                if valid_bytes < os.path.getsize(spill_path):
                    # Torn tail (killed mid-append): truncate the file to
                    # the last complete record so the next append starts
                    # on a clean line instead of poisoning replay.
                    with open(spill_path, "r+b") as fh:
                        fh.truncate(valid_bytes)
                for d in records:
                    src = d.get("src")
                    msg = Message(
                        topic=topic,
                        payload=d["payload"],
                        key=d.get("key"),
                        created_at=d.get("created_at", 0.0),
                        src=tuple(src) if src is not None else None,
                    )
                    self._entries.append(
                        msg.with_source(index, len(self._entries))
                    )
            self._spill_fh = open(spill_path, "a", encoding="utf-8")

    def append(self, msg: Message) -> int:
        with self._lock:
            offset = len(self._entries)
            self._entries.append(msg.with_source(self.index, offset))
            if self._spill_fh is not None:
                record = {
                    "payload": msg.payload,
                    "key": msg.key,
                    "created_at": msg.created_at,
                }
                if msg.src is not None:
                    record["src"] = list(msg.src)
                self._spill_fh.write(json.dumps(record) + "\n")
                self._spill_fh.flush()
            return offset

    def close(self) -> None:
        if self._spill_fh is not None:
            self._spill_fh.close()
            self._spill_fh = None

    def read(self, offset: int, max_messages: int = 1) -> List[Message]:
        with self._lock:
            return self._entries[offset : offset + max_messages]

    def end_offset(self) -> int:
        with self._lock:
            return len(self._entries)

    def __len__(self) -> int:
        return self.end_offset()


class Topic:
    """A named set of partitions."""

    def __init__(self, name: str, num_partitions: int,
                 spill_dir: Optional[str] = None) -> None:
        if num_partitions < 1:
            raise ValueError("a topic needs >= 1 partition")
        self.name = name
        self.partitions = [
            Partition(
                name, i,
                spill_path=(
                    os.path.join(spill_dir, f"{name}-p{i}.jsonl")
                    if spill_dir is not None else None
                ),
            )
            for i in range(num_partitions)
        ]
        self._rr = itertools.count()

    @property
    def num_partitions(self) -> int:
        return len(self.partitions)

    def _partition_for(self, msg: Message) -> int:
        if msg.key is not None:
            return partition_for_key(msg.key, self.num_partitions)
        return next(self._rr) % self.num_partitions

    def publish(self, msg: Message) -> tuple[int, int]:
        """Append; returns (partition, offset)."""
        p = self._partition_for(msg)
        offset = self.partitions[p].append(msg)
        return p, offset

    def end_offsets(self) -> List[int]:
        return [p.end_offset() for p in self.partitions]

    def total_messages(self) -> int:
        return sum(self.end_offsets())


class MessageLog:
    """The broker: name → Topic registry (the whole messaging layer).

    ``spill_dir`` turns on durable JSONL spill for every topic created
    through this broker, plus a ``topics.json`` manifest, so a crashed
    process recovers the entire log with :meth:`reopen`.
    """

    def __init__(self, spill_dir: Optional[str] = None) -> None:
        self._topics: Dict[str, Topic] = {}
        self._lock = threading.Lock()
        self.spill_dir = spill_dir
        if spill_dir is not None:
            os.makedirs(spill_dir, exist_ok=True)

    @classmethod
    def reopen(cls, spill_dir: str) -> "MessageLog":
        """Rebuild a spilled log after a process restart: the manifest
        names the topics, each partition re-reads its JSONL file, and
        appends continue onto the same files."""
        manifest = os.path.join(spill_dir, _MANIFEST)
        if not os.path.exists(manifest):
            raise FileNotFoundError(
                f"no message-log manifest at {manifest!r} — nothing to reopen"
            )
        with open(manifest, "r", encoding="utf-8") as fh:
            topics = json.load(fh)
        log = cls(spill_dir=spill_dir)
        for name, num_partitions in topics.items():
            log.create_topic(name, num_partitions)
        return log

    def _write_manifest(self) -> None:
        if self.spill_dir is None:
            return
        manifest = os.path.join(self.spill_dir, _MANIFEST)
        with open(manifest, "w", encoding="utf-8") as fh:
            json.dump(
                {n: t.num_partitions for n, t in self._topics.items()}, fh
            )

    def create_topic(self, name: str, num_partitions: int) -> Topic:
        with self._lock:
            if name in self._topics:
                raise ValueError(f"topic {name!r} already exists")
            topic = Topic(name, num_partitions, spill_dir=self.spill_dir)
            self._topics[name] = topic
            self._write_manifest()
            return topic

    def close(self) -> None:
        """Release spill file handles (simulating a clean process exit)."""
        with self._lock:
            for topic in self._topics.values():
                for part in topic.partitions:
                    part.close()

    def get(self, name: str) -> Topic:
        with self._lock:
            return self._topics[name]

    def exists(self, name: str) -> bool:
        with self._lock:
            return name in self._topics

    def publish(self, topic: str, payload: Any, key: Optional[str] = None,
                created_at: float = 0.0) -> tuple[int, int]:
        msg = Message(topic=topic, payload=payload, key=key, created_at=created_at)
        return self.get(topic).publish(msg)

    def topics(self) -> List[str]:
        with self._lock:
            return sorted(self._topics)


@dataclass
class PartitionClaim:
    partition: int
    committed_offset: int  # next offset to read


class PartitionConsumer:
    """A cursor over one partition with explicit offset commits.

    At-least-once: ``poll`` reads from the *committed* offset plus the
    in-flight count; a crash discards in-flight state so the next consumer
    re-reads everything uncommitted.
    """

    def __init__(self, topic: Topic, partition: int, start_offset: int = 0) -> None:
        self.topic = topic
        self.partition = partition
        self.committed = start_offset
        self.position = start_offset  # read cursor (uncommitted)

    def poll(self, max_messages: int = 1) -> List[Message]:
        msgs = self.topic.partitions[self.partition].read(self.position, max_messages)
        self.position += len(msgs)
        return msgs

    def commit(self, offset: Optional[int] = None) -> int:
        self.committed = self.position if offset is None else offset
        return self.committed

    def rewind_to_committed(self) -> None:
        self.position = self.committed

    def lag(self) -> int:
        return self.topic.partitions[self.partition].end_offset() - self.position


class ConsumerGroup:
    """Kafka-style group: each partition owned by exactly one member.

    ``assign(n_members)`` returns the partition→member map; members beyond
    ``num_partitions`` receive nothing (idle) — this is the structural
    scalability limit of the plain Liquid processing layer (paper Fig. 2),
    reproduced faithfully so the baseline comparison is honest.
    """

    def __init__(self, group_id: str, topic: Topic) -> None:
        self.group_id = group_id
        self.topic = topic
        self.offsets: Dict[int, int] = {p: 0 for p in range(topic.num_partitions)}

    def assign(self, n_members: int) -> Dict[int, int]:
        """partition -> member index (range-robin)."""
        if n_members < 1:
            raise ValueError("need >= 1 member")
        return {p: p % n_members for p in range(self.topic.num_partitions)}

    def active_members(self, n_members: int) -> int:
        """How many members actually receive work."""
        return min(n_members, self.topic.num_partitions)

    def consumer_for(self, partition: int) -> PartitionConsumer:
        return PartitionConsumer(self.topic, partition, self.offsets.get(partition, 0))

    def commit(self, partition: int, offset: int) -> None:
        self.offsets[partition] = offset

    def total_lag(self) -> int:
        return sum(
            p.end_offset() - self.offsets.get(p.index, 0) for p in self.topic.partitions
        )
