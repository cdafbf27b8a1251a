"""Asynchronous messaging layer (paper §3.2.4).

Every cross-component interaction in the Reactive Liquid runtime is an
asynchronous message delivered to a bounded mailbox.  This gives the three
properties the Reactive Manifesto asks of a message-driven system: loose
coupling (senders hold only an address), isolation (a crashed receiver
cannot corrupt a sender), and location transparency (an address names a
mailbox, not a node — the cluster simulator is free to move mailboxes
between nodes on restart).

The implementation is deliberately host-side Python: mailboxes model the
control plane; tensors stay on the device.  The continuous batcher, the
elastic pool and the dataflow stages are built on these types.

The port's own copy of the reference package's ``core/messages.py``.
"""

from __future__ import annotations

import itertools
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, Iterator, Optional

_msg_ids = itertools.count()


@dataclass(frozen=True)
class Message:
    """An immutable envelope.

    Attributes:
      topic:    logical stream the payload belongs to ("" for control).
      payload:  arbitrary immutable payload.
      key:      optional partitioning key.
      offset:   position in the source partition (set by the log).
      partition: source partition id (set by the log).
      created_at: simulated/wall time the message entered the system;
        completion time (paper Fig. 11) is measured against this.
      msg_id:   globally unique id (idempotence / dedup on redelivery).
      src:      optional dataflow provenance ``(stage, partition, offset,
        k, n)`` — which stage produced this message, from which input
        offset, as output k of n.  Durable (spilled with the payload):
        it is the cross-process exactly-once key for chained stages
        (``core.dataflow``); msg_id is NOT stable across process
        restarts, src is.
    """

    topic: str
    payload: Any
    key: Optional[str] = None
    offset: int = -1
    partition: int = -1
    created_at: float = 0.0
    msg_id: int = field(default_factory=lambda: next(_msg_ids))
    src: Optional[tuple] = None

    def with_source(self, partition: int, offset: int) -> "Message":
        return Message(
            topic=self.topic,
            payload=self.payload,
            key=self.key,
            offset=offset,
            partition=partition,
            created_at=self.created_at,
            msg_id=self.msg_id,
            src=self.src,
        )


class MailboxOverflow(RuntimeError):
    """Raised on enqueue to a full bounded mailbox (backpressure signal)."""


class Mailbox:
    """A bounded FIFO mailbox.

    ``capacity <= 0`` means unbounded.  ``depth()`` is the live queue-depth
    signal consumed by the elastic worker service (paper §3.2.2) and by the
    JSQ / power-of-two schedulers (our beyond-paper §5 fix).
    """

    def __init__(self, name: str, capacity: int = 0) -> None:
        self.name = name
        self.capacity = capacity
        self._q: Deque[Message] = deque()
        self._lock = threading.Lock()
        self.enqueued = 0
        self.dequeued = 0
        self.dropped = 0
        # (LoadView, index) pairs mirroring this queue's depth: every
        # mutation updates the bound arrays in place (inside the lock),
        # so schedulers read depths from numpy instead of taking this
        # lock per queue per message.  Usually empty or a single entry
        # (the owning pool's view); a virtual consumer forwarding into
        # the same mailboxes binds a second, short-lived one.
        self._views: list = []

    def _bind_view(self, view, idx: int) -> None:
        with self._lock:
            self._views = [
                (v, i) for v, i in self._views if v is not view
            ] + [(view, idx)]

    def _unbind_view(self, view) -> None:
        with self._lock:
            self._views = [(v, i) for v, i in self._views if v is not view]

    def _note(self, delta: int) -> None:
        for view, idx in self._views:
            view.note(idx, delta)

    def put(self, msg: Message) -> None:
        with self._lock:
            if self.capacity > 0 and len(self._q) >= self.capacity:
                self.dropped += 1
                raise MailboxOverflow(
                    f"mailbox {self.name!r} full (capacity={self.capacity})"
                )
            self._q.append(msg)
            self.enqueued += 1
            if self._views:
                self._note(1)

    def try_put(self, msg: Message) -> bool:
        """Non-raising bounded put: False (and a drop count) when full.

        This is the shed/defer entry point for callers that treat overflow
        as a policy decision rather than an error (serving admission)."""
        with self._lock:
            if self.capacity > 0 and len(self._q) >= self.capacity:
                self.dropped += 1
                return False
            self._q.append(msg)
            self.enqueued += 1
            if self._views:
                self._note(1)
            return True

    def put_front(self, msg: Message) -> None:
        """Enqueue at the head, ignoring capacity.

        Re-admission path: work a dead worker already held (its in-flight
        and queued messages) must re-enter ahead of new arrivals and must
        never be shed — the mailbox briefly exceeding its bound is the
        lesser evil (same reasoning as ReactiveJob's restart drain)."""
        with self._lock:
            self._q.appendleft(msg)
            self.enqueued += 1
            if self._views:
                self._note(1)

    def get(self) -> Optional[Message]:
        with self._lock:
            if not self._q:
                return None
            self.dequeued += 1
            if self._views:
                self._note(-1)
            return self._q.popleft()

    def get_many(self, n: int) -> list:
        """Dequeue up to ``n`` messages under one lock acquisition (the
        batched dispatch pull — same FIFO order as ``n`` ``get`` calls)."""
        with self._lock:
            take = min(n, len(self._q))
            if take <= 0:
                return []
            out = [self._q.popleft() for _ in range(take)]
            self.dequeued += take
            if self._views:
                self._note(-take)
            return out

    def peek(self) -> Optional[Message]:
        with self._lock:
            return self._q[0] if self._q else None

    def depth(self) -> int:
        with self._lock:
            return len(self._q)

    def drain(self) -> Iterator[Message]:
        """Remove and yield everything currently queued (work stealing)."""
        with self._lock:
            items, self._q = list(self._q), deque()
            self.dequeued += len(items)
            if self._views and items:
                self._note(-len(items))
        yield from items

    def snapshot(self) -> list:
        """Non-destructive copy of the queued messages (checkpointing)."""
        with self._lock:
            return list(self._q)

    def __len__(self) -> int:  # pragma: no cover - convenience
        return self.depth()


class MessageBus:
    """Name → mailbox registry providing location transparency.

    Components address each other by string address; the bus owns the
    mapping so the supervisor can re-home an address to a fresh mailbox on
    restart without senders noticing.
    """

    def __init__(self) -> None:
        self._boxes: Dict[str, Mailbox] = {}
        self._lock = threading.Lock()
        self._dead_letters: Deque[Message] = deque(maxlen=1024)
        self.on_dead_letter: Optional[Callable[[str, Message], None]] = None

    def register(self, address: str, capacity: int = 0) -> Mailbox:
        with self._lock:
            box = Mailbox(address, capacity=capacity)
            self._boxes[address] = box
            return box

    def unregister(self, address: str) -> None:
        with self._lock:
            self._boxes.pop(address, None)

    def resolve(self, address: str) -> Optional[Mailbox]:
        with self._lock:
            return self._boxes.get(address)

    def send(self, address: str, msg: Message) -> bool:
        """Asynchronous fire-and-forget send. Returns delivery success."""
        box = self.resolve(address)
        if box is None:
            self._dead_letters.append(msg)
            if self.on_dead_letter is not None:
                self.on_dead_letter(address, msg)
            return False
        box.put(msg)
        return True

    def addresses(self) -> list[str]:
        with self._lock:
            return sorted(self._boxes)

    def dead_letter_count(self) -> int:
        return len(self._dead_letters)
