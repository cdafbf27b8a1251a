"""Asynchronous messaging: the envelope and the FIFO mailbox that feed
the continuous batcher.

The port's own copy of the reference package's ``core/messages.py``,
trimmed to what the batcher uses (``put`` / ``get`` / ``depth``).
Capacity bounds, work stealing and the scheduler's load-view binding
arrive with the elastic serving stack.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Optional


@dataclass(frozen=True)
class Message:
    """An immutable envelope.

    Attributes:
      topic:      logical stream the payload belongs to.
      payload:    the carried object (a ``serving.batcher.Request``).
      created_at: time the message entered the system; stalled requests
        are re-queued in this order.
    """

    topic: str
    payload: Any
    created_at: float = 0.0


class Mailbox:
    """An unbounded, thread-safe FIFO mailbox."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._q: Deque[Message] = deque()
        self._lock = threading.Lock()

    def put(self, msg: Message) -> None:
        with self._lock:
            self._q.append(msg)

    def get(self) -> Optional[Message]:
        with self._lock:
            return self._q.popleft() if self._q else None

    def depth(self) -> int:
        with self._lock:
            return len(self._q)
