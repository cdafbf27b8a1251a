"""Conflict-free replicated data types (paper §3.2.2, State Management).

The state-management service shares state across distributed component
instances "without bottlenecks or contention points" by using CRDTs:
replicas are updated independently and merged deterministically, with
inconsistencies resolved mathematically (Shapiro et al. 2011).

These are state-based (convergent) CRDTs.  Every type satisfies the CRDT
laws — ``merge`` is commutative, associative, and idempotent, and local
updates are monotone in the induced semilattice — which the hypothesis
property tests in ``tests/test_crdt.py`` verify directly.

In this framework CRDTs back the telemetry layer: per-worker metric
replicas (messages processed, tokens trained, failures seen) merge at the
supervisor without any coordination, surviving worker restarts (the
restarted worker's replica re-merges losslessly).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, FrozenSet, Generic, Iterable, Optional, Tuple, TypeVar

T = TypeVar("T")

_unique = itertools.count()


def _fresh_tag() -> int:
    return next(_unique)


class GCounter:
    """Grow-only counter: per-replica monotone counts, merge = pointwise max."""

    def __init__(self, replica_id: str, counts: Optional[Dict[str, int]] = None):
        self.replica_id = replica_id
        self.counts: Dict[str, int] = dict(counts or {})

    def increment(self, amount: int = 1) -> None:
        if amount < 0:
            raise ValueError("GCounter cannot decrease; use PNCounter")
        self.counts[self.replica_id] = self.counts.get(self.replica_id, 0) + amount

    def value(self) -> int:
        return sum(self.counts.values())

    def merge(self, other: "GCounter") -> "GCounter":
        keys = set(self.counts) | set(other.counts)
        merged = {k: max(self.counts.get(k, 0), other.counts.get(k, 0)) for k in keys}
        return GCounter(self.replica_id, merged)

    def copy_as(self, replica_id: str) -> "GCounter":
        return GCounter(replica_id, dict(self.counts))

    def __eq__(self, other: object) -> bool:
        return isinstance(other, GCounter) and self.counts == other.counts

    def __repr__(self) -> str:  # pragma: no cover
        return f"GCounter({self.value()}, replicas={len(self.counts)})"


class PNCounter:
    """Increment/decrement counter as a pair of GCounters."""

    def __init__(
        self,
        replica_id: str,
        pos: Optional[Dict[str, int]] = None,
        neg: Optional[Dict[str, int]] = None,
    ):
        self.replica_id = replica_id
        self.pos = GCounter(replica_id, pos)
        self.neg = GCounter(replica_id, neg)

    def increment(self, amount: int = 1) -> None:
        if amount >= 0:
            self.pos.increment(amount)
        else:
            self.neg.increment(-amount)

    def decrement(self, amount: int = 1) -> None:
        self.increment(-amount)

    def value(self) -> int:
        return self.pos.value() - self.neg.value()

    def merge(self, other: "PNCounter") -> "PNCounter":
        out = PNCounter(self.replica_id)
        out.pos = self.pos.merge(other.pos)
        out.neg = self.neg.merge(other.neg)
        return out

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, PNCounter)
            and self.pos == other.pos
            and self.neg == other.neg
        )

    def __repr__(self) -> str:  # pragma: no cover
        return f"PNCounter({self.value()})"


@dataclass(frozen=True)
class LWWRegister(Generic[T]):
    """Last-writer-wins register.

    Total order on (timestamp, tiebreak) makes merge deterministic even for
    concurrent writes at the same timestamp.
    """

    value: Optional[T] = None
    timestamp: float = float("-inf")
    tiebreak: str = ""

    def set(self, value: T, timestamp: float, tiebreak: str = "") -> "LWWRegister[T]":
        return LWWRegister(value, timestamp, tiebreak)

    def merge(self, other: "LWWRegister[T]") -> "LWWRegister[T]":
        # Total order: (timestamp, tiebreak), then a deterministic order on
        # the value repr. The last fallback only matters if two writers share
        # a tiebreak (normally the unique replica id) — without it, merge
        # would not commute for such writes.
        if (other.timestamp, other.tiebreak, repr(other.value)) > (
            self.timestamp,
            self.tiebreak,
            repr(self.value),
        ):
            return other
        return self


class GSet(Generic[T]):
    """Grow-only set, merge = union."""

    def __init__(self, items: Iterable[T] = ()):  # noqa: D401
        self.items: FrozenSet[T] = frozenset(items)

    def add(self, item: T) -> "GSet[T]":
        return GSet(self.items | {item})

    def merge(self, other: "GSet[T]") -> "GSet[T]":
        return GSet(self.items | other.items)

    def __contains__(self, item: T) -> bool:
        return item in self.items

    def __eq__(self, other: object) -> bool:
        return isinstance(other, GSet) and self.items == other.items

    def __len__(self) -> int:
        return len(self.items)


class ORSet(Generic[T]):
    """Observed-remove set.

    Each add gets a unique tag; remove deletes only *observed* tags, so a
    concurrent re-add survives the remove (add-wins semantics).
    """

    def __init__(
        self,
        adds: Optional[Dict[T, FrozenSet[int]]] = None,
        removes: Optional[Dict[T, FrozenSet[int]]] = None,
    ):
        self.adds: Dict[T, FrozenSet[int]] = dict(adds or {})
        self.removes: Dict[T, FrozenSet[int]] = dict(removes or {})

    def add(self, item: T) -> "ORSet[T]":
        out = ORSet(self.adds, self.removes)
        out.adds[item] = out.adds.get(item, frozenset()) | {_fresh_tag()}
        return out

    def remove(self, item: T) -> "ORSet[T]":
        out = ORSet(self.adds, self.removes)
        observed = out.adds.get(item, frozenset())
        out.removes[item] = out.removes.get(item, frozenset()) | observed
        return out

    def __contains__(self, item: T) -> bool:
        live = self.adds.get(item, frozenset()) - self.removes.get(item, frozenset())
        return bool(live)

    def elements(self) -> FrozenSet[T]:
        return frozenset(x for x in self.adds if x in self)

    def merge(self, other: "ORSet[T]") -> "ORSet[T]":
        adds: Dict[T, FrozenSet[int]] = {}
        for k in set(self.adds) | set(other.adds):
            adds[k] = self.adds.get(k, frozenset()) | other.adds.get(k, frozenset())
        removes: Dict[T, FrozenSet[int]] = {}
        for k in set(self.removes) | set(other.removes):
            removes[k] = self.removes.get(k, frozenset()) | other.removes.get(
                k, frozenset()
            )
        return ORSet(adds, removes)

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, ORSet)
            and self.adds == other.adds
            and self.removes == other.removes
        )


class VClock:
    """Vector clock — causality tracking for the event journal merge."""

    def __init__(self, clock: Optional[Dict[str, int]] = None):
        self.clock: Dict[str, int] = dict(clock or {})

    def tick(self, replica_id: str) -> "VClock":
        out = VClock(self.clock)
        out.clock[replica_id] = out.clock.get(replica_id, 0) + 1
        return out

    def merge(self, other: "VClock") -> "VClock":
        keys = set(self.clock) | set(other.clock)
        return VClock(
            {k: max(self.clock.get(k, 0), other.clock.get(k, 0)) for k in keys}
        )

    def happens_before(self, other: "VClock") -> bool:
        """True iff self < other in the causal partial order."""
        le = all(v <= other.clock.get(k, 0) for k, v in self.clock.items())
        lt = any(v < other.clock.get(k, 0) for k, v in self.clock.items()) or any(
            k not in self.clock and v > 0 for k, v in other.clock.items()
        )
        return le and lt

    def concurrent_with(self, other: "VClock") -> bool:
        return (
            not self.happens_before(other)
            and not other.happens_before(self)
            and self.clock != other.clock
        )

    def __eq__(self, other: object) -> bool:
        a = {k: v for k, v in self.clock.items() if v}
        b = {k: v for k, v in other.clock.items() if v} if isinstance(other, VClock) else None
        return b is not None and a == b


def merge_all(replicas: Iterable[Any]) -> Any:
    """Fold merge over replicas (order-independent by the CRDT laws)."""
    it = iter(replicas)
    acc = next(it)
    for r in it:
        acc = acc.merge(r)
    return acc
