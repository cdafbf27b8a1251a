"""Event-sourced state management (paper §3.2.2).

"The state management service provides persistent and immutable state by
employing [the] Event Sourcing Pattern which stores all changes to the
state of a component as a sequence of events" — components never mutate
persistent state in place; they append events and reconstruct state by
replaying them (optionally from a snapshot).

This module is the abstract machinery; a checkpoint store layers the
training-specific snapshots and per-step delta events on top (not ported
yet).

Guarantees (property-tested):
  * replay determinism — replay(events) is a pure fold, same events →
    same state;
  * snapshot equivalence — snapshot at k + replay(events[k:]) ==
    replay(events);
  * idempotent redelivery — events carry sequence numbers; an event with
    seq <= applied_seq is skipped, so at-least-once delivery is safe.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Generic, Iterable, List, Optional, Tuple, TypeVar

S = TypeVar("S")


@dataclass(frozen=True)
class Event:
    """An immutable state-change record."""

    seq: int
    kind: str
    data: Any
    timestamp: float = 0.0

    def to_json(self) -> str:
        return json.dumps(
            {"seq": self.seq, "kind": self.kind, "data": self.data, "ts": self.timestamp}
        )

    @staticmethod
    def from_json(line: str) -> "Event":
        d = json.loads(line)
        return Event(seq=d["seq"], kind=d["kind"], data=d["data"], timestamp=d["ts"])


@dataclass(frozen=True)
class Snapshot(Generic[S]):
    """State materialized at a sequence number."""

    seq: int
    state: S


class EventJournal:
    """Append-only event log with optional file persistence.

    The journal is the single source of truth for a stateful component.
    ``append`` assigns sequence numbers; ``events_after`` feeds replay.
    File persistence is line-delimited JSON so a crashed process (not just
    a crashed component) recovers by re-reading the file.
    """

    def __init__(
        self, path: Optional[str] = None, write_behind: Any = None
    ) -> None:
        self._events: List[Event] = []
        self._path = path
        self._fh = None
        # Optional write-behind worker (duck-typed: .submit(fn, *args) ->
        # ticket).  Sequence numbers are still assigned in the caller's
        # thread — only the file write is deferred, so in-memory order
        # (the replay order) never depends on writer timing.
        self._write_behind = write_behind
        self.last_ticket: Any = None
        if path is not None:
            if os.path.exists(path):
                with open(path, "r", encoding="utf-8") as fh:
                    for line in fh:
                        line = line.strip()
                        if line:
                            self._events.append(Event.from_json(line))
            self._fh = open(path, "a", encoding="utf-8")

    @property
    def last_seq(self) -> int:
        return self._events[-1].seq if self._events else -1

    def _write_line(self, line: str) -> None:
        if self._fh is not None:
            self._fh.write(line + "\n")
            self._fh.flush()

    def append(self, kind: str, data: Any, timestamp: float = 0.0) -> Event:
        ev = Event(seq=self.last_seq + 1, kind=kind, data=data, timestamp=timestamp)
        self._events.append(ev)
        if self._fh is not None:
            if self._write_behind is not None:
                # Durability is deferred: the returned ticket resolves
                # when the line is on disk.  Callers that need
                # commit-after-journal gate on it instead of blocking.
                self.last_ticket = self._write_behind.submit(
                    self._write_line, ev.to_json()
                )
            else:
                self._write_line(ev.to_json())
        return ev

    def events_after(self, seq: int) -> List[Event]:
        return [e for e in self._events if e.seq > seq]

    def all_events(self) -> List[Event]:
        return list(self._events)

    def truncate_through(self, seq: int) -> int:
        """Drop events with seq <= seq (after a durable snapshot). Returns
        number dropped. File-backed journals rewrite the file."""
        keep = [e for e in self._events if e.seq > seq]
        dropped = len(self._events) - len(keep)
        self._events = keep
        if self._path is not None:
            if self._fh is not None:
                self._fh.close()
            with open(self._path, "w", encoding="utf-8") as fh:
                for e in keep:
                    fh.write(e.to_json() + "\n")
            self._fh = open(self._path, "a", encoding="utf-8")
        return dropped

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


Reducer = Callable[[S, Event], S]


class EventSourcedState(Generic[S]):
    """A stateful component's state, reconstructed by folding events.

    ``apply``/``replay`` are pure with respect to the reducer; the instance
    tracks ``applied_seq`` to make redelivery idempotent (at-least-once
    delivery from the messaging layer is therefore safe).
    """

    def __init__(
        self,
        initial: S,
        reducer: Reducer,
        journal: Optional[EventJournal] = None,
    ) -> None:
        self.initial = initial
        self.reducer = reducer
        self.journal = journal if journal is not None else EventJournal()
        self.state: S = initial
        self.applied_seq: int = -1
        self._snapshot: Optional[Snapshot[S]] = None
        # Recover anything already in a file-backed journal.
        self.replay()

    def record(self, kind: str, data: Any, timestamp: float = 0.0) -> Event:
        """Append an event and apply it locally."""
        ev = self.journal.append(kind, data, timestamp)
        self._apply(ev)
        return ev

    def _apply(self, ev: Event) -> None:
        if ev.seq <= self.applied_seq:
            return  # idempotent redelivery
        self.state = self.reducer(self.state, ev)
        self.applied_seq = ev.seq

    def replay(self) -> S:
        """Rebuild state from snapshot (if any) + journal suffix."""
        if self._snapshot is not None:
            self.state = self._snapshot.state
            self.applied_seq = self._snapshot.seq
        else:
            self.state = self.initial
            self.applied_seq = -1
        for ev in self.journal.events_after(self.applied_seq):
            self._apply(ev)
        return self.state

    def snapshot(self) -> Snapshot[S]:
        """Materialize current state; lets the journal prefix be truncated."""
        self._snapshot = Snapshot(seq=self.applied_seq, state=self.state)
        return self._snapshot

    def restore(self, snapshot: Snapshot[S]) -> S:
        self._snapshot = snapshot
        return self.replay()

    def compact(self) -> int:
        """Snapshot then truncate the journal prefix."""
        snap = self.snapshot()
        return self.journal.truncate_through(snap.seq)


def dict_reducer(state: Dict[str, Any], ev: Event) -> Dict[str, Any]:
    """A generic reducer for dict states.

    Event kinds: ``set`` {key,value}, ``incr`` {key,amount}, ``del`` {key}.
    Used by offsets tracking and tests.
    """
    out = dict(state)
    if ev.kind == "set":
        out[ev.data["key"]] = ev.data["value"]
    elif ev.kind == "incr":
        out[ev.data["key"]] = out.get(ev.data["key"], 0) + ev.data["amount"]
    elif ev.kind == "del":
        out.pop(ev.data["key"], None)
    else:
        raise ValueError(f"unknown event kind {ev.kind!r}")
    return out
