"""Message-distribution schedulers.

The paper's virtual consumers forward messages to task mailboxes with no
load awareness (effectively round-robin), which is exactly why its Fig. 11
completion time regresses: mailbox waiting time ``t_wi`` grows unboundedly
on slow tasks.  §5 of the paper names "a message distribution scheduler
algorithm which distributes the messages among the tasks" as the open
problem.

We ship four schedulers:

  * ``RoundRobinScheduler`` — the paper-faithful baseline (registered as
    both ``round_robin`` and ``fcfs``: with FIFO mailboxes it is exactly
    first-come-first-served admission spread blindly over tasks).
  * ``JoinShortestQueueScheduler`` — route to the task with minimum queue
    depth (JSQ); optimal among non-anticipating policies for homogeneous
    servers.
  * ``PowerOfTwoScheduler`` — sample d=2 tasks, pick the shorter queue
    (Mitzenmacher 2001).  O(1) state inspection per message, near-JSQ tail
    latency; this is the variant that scales to thousands of tasks because
    JSQ's full scan is itself a contention point (which the Reactive
    Manifesto forbids).
  * ``DeadlineScheduler`` — earliest-deadline-first admission order plus
    JSQ routing; payloads may carry a ``deadline`` (or ``priority``)
    attribute and urgent work overtakes lax work at the dispatch point.
    This is the serving layer's SLO-aware policy.

Message-aware policies use two extra hooks that default to no-ops for the
load-only schedulers: ``order`` (re-order a dispatch batch) and
``pick_msg`` (route with the message in hand).

**Vectorized dispatch** (the control-plane hot-loop refactor): the
per-message scalar path — ``pick``/``pick_msg`` scanning ``depth()`` over
every mailbox, each call taking a lock — is kept as the reference
implementation, and every registered scheduler additionally supports an
array-backed path over a :class:`LoadView` (a numpy snapshot of mailbox
depths, kept incrementally up to date by the owning pool on every
put/take):

  * ``pick_view(msg, view)`` — the scalar pick, resolved against the
    depth array instead of per-mailbox ``depth()`` calls.  Bitwise
    equivalent to ``pick_msg`` whenever ``view.depths`` mirrors the real
    queues (which a bound view does by construction).
  * ``pick_batch(msgs, view)`` — route a whole admission batch at once:
    JSQ becomes one heap-simulated argmin sweep, P2C two array gathers
    per message after the identical RNG draws, round-robin a single
    ``arange`` — returning the *identical index sequence* the scalar
    path would produce if each message landed on its pick before the
    next pick (``view.depths`` is updated in place with that
    assumption; callers on paths where delivery can deviate — bounded
    overflow, admission dedup — must either pass a ``plan()`` copy and
    guarantee delivery, or use ``pick_view`` per message).

``msg_pure`` marks schedulers whose picks never read queue depths
(round-robin, partition affinity): their ``pick_batch`` accepts any
sized sequence as the view and stays exact no matter what delivery does;
``rewind(n)`` rolls internal state back when a caller aborts a
pre-picked batch mid-way (bounded-mailbox backpressure).
``supports_batch`` gates the vectorized paths — custom schedulers that
override only ``pick``/``pick_msg`` keep the scalar path everywhere.

``benchmarks/bench_scheduler.py`` reproduces the paper's completion-time
regression under RR and shows JSQ/P2C close it — the beyond-paper result.

The same interface also drives MoE token routing at silicon scale (see
DESIGN.md §5): experts are "tasks", tokens are "messages", and capacity
overflow is mailbox backpressure.
"""

from __future__ import annotations

import heapq
import random
from typing import Any, Callable, List, Optional, Protocol, Sequence

import numpy as np


class QueueView(Protocol):
    """Anything with a depth() — Mailbox satisfies this."""

    def depth(self) -> int: ...


class LoadView:
    """Array-backed snapshot of queue depths (the vectorized dispatch
    substrate).

    ``depths`` is a numpy int64 array, one slot per queue.  When a queue
    (or the mailbox behind it — ``.box``/``.mailbox`` attributes are
    followed) supports view binding (``core.messages.Mailbox`` does),
    the view is *bound*: every put/take on the mailbox updates the array
    in place, so the view mirrors the real depths with zero per-read
    locking.  Unbound queues are snapshotted at construction and on
    :meth:`refresh`.

    ``on_decrease`` is the lazy-invalidation hook for the pool's
    least-loaded heap: a depth decrease may make a queue the new
    minimum, so the heap gets a fresh entry (increases are corrected
    lazily at pop time instead).
    """

    def __init__(self, queues: Sequence[Any], bind: bool = True) -> None:
        self.queues: List[Any] = list(queues)
        self.depths = np.array(
            [q.depth() for q in self.queues], dtype=np.int64
        )
        self.on_decrease: Optional[Callable[[int], None]] = None
        self._bound: List[Any] = []
        self.fully_bound = False
        if bind:
            bound = 0
            for i, q in enumerate(self.queues):
                box = getattr(q, "box", None) or getattr(q, "mailbox", None) or q
                if hasattr(box, "_bind_view"):
                    box._bind_view(self, i)
                    self._bound.append(box)
                    bound += 1
            self.fully_bound = bound == len(self.queues) > 0

    def __len__(self) -> int:
        return len(self.queues)

    def note(self, idx: int, delta: int) -> None:
        """Incremental update (mailboxes call this from inside their
        lock; manual callers use it for unbound queues)."""
        self.depths[idx] += delta
        if delta < 0 and self.on_decrease is not None:
            self.on_decrease(idx)

    def refresh(self) -> None:
        """Re-snapshot every queue (unbound views between batches)."""
        for i, q in enumerate(self.queues):
            self.depths[i] = q.depth()

    def detach(self) -> None:
        """Unbind from every mailbox (the owner is replacing the view)."""
        for box in self._bound:
            box._unbind_view(self)
        self._bound = []
        self.fully_bound = False

    def plan(self) -> "LoadView":
        """An unbound working copy for ``pick_batch`` precomputation:
        same queues, private depth array, no binding — mutating it plans
        a batch without double-counting the deliveries that follow."""
        out = LoadView.__new__(LoadView)
        out.queues = self.queues
        out.depths = self.depths.copy()
        out.on_decrease = None
        out._bound = []
        out.fully_bound = False
        return out

    def argmin(self) -> int:
        return int(self.depths.argmin())


def _deadline_of(msg: Any) -> tuple:
    """Admission key (smaller tuple = sooner): messages with a deadline
    sort first, earliest deadline winning; deadline-less messages follow,
    ordered by descending priority (positive before the neutral default 0,
    negative after it).  Works on Messages (inspects the payload) and
    bare payloads alike."""
    payload = getattr(msg, "payload", msg)
    deadline = getattr(payload, "deadline", None)
    if deadline is not None:
        return (0, float(deadline))
    priority = getattr(payload, "priority", None) or 0
    return (1, -float(priority))


class Scheduler:
    """Chooses the destination task index for each message."""

    name = "base"
    # Vectorized-path capability flags (see module docstring): custom
    # schedulers that override only pick/pick_msg keep the scalar path.
    supports_batch = False
    # True when picks never read queue depths: pick_batch is exact no
    # matter what delivery does, and accepts any sized view.
    msg_pure = False

    def pick(self, queues: Sequence[QueueView]) -> int:
        raise NotImplementedError

    def pick_msg(self, msg: Any, queues: Sequence[QueueView]) -> int:
        """Route with the message in hand; load-only policies ignore it."""
        return self.pick(queues)

    def pick_view(self, msg: Any, view: LoadView) -> int:
        """Scalar pick resolved against the view's depth array.  The
        fallback reads the real queues (exact for live bound views);
        registered schedulers override with pure array reads."""
        return self.pick_msg(msg, view.queues)

    def pick_batch(self, msgs: Sequence[Any], view: LoadView) -> List[int]:
        """Batch routing: the index sequence the scalar path would
        produce if each message were enqueued on its pick before the
        next pick.  Mutates ``view.depths`` under that assumption —
        pass ``view.plan()`` when the real deliveries follow on a bound
        view."""
        out = []
        for msg in msgs:
            i = self.pick_view(msg, view)
            view.note(i, 1)
            out.append(i)
        return out

    def rewind(self, n: int) -> None:
        """Roll back internal state consumed by the last ``pick_batch``
        for ``n`` unused picks (a caller aborted mid-batch).  Only
        ``msg_pure`` schedulers support this."""
        raise RuntimeError(f"scheduler {self.name!r} cannot rewind picks")

    def order(self, msgs: Sequence[Any]) -> List[Any]:
        """Admission order for a dispatch batch; FIFO unless overridden."""
        return list(msgs)

    def reset(self, num_tasks: int) -> None:  # pragma: no cover - default
        pass


class RoundRobinScheduler(Scheduler):
    """Paper-faithful: cycle through tasks, ignoring load."""

    name = "round_robin"
    supports_batch = True
    msg_pure = True

    def __init__(self) -> None:
        self._next = 0
        self._last_n = 1  # queue count of the last pick_batch (for rewind)

    def reset(self, num_tasks: int) -> None:
        self._next = 0

    def pick(self, queues: Sequence[QueueView]) -> int:
        i = self._next % len(queues)
        self._next = (self._next + 1) % len(queues)
        return i

    def pick_view(self, msg: Any, view: LoadView) -> int:
        return self.pick(view)  # only len() is read

    def pick_batch(self, msgs: Sequence[Any], view) -> List[int]:
        n = len(view)
        self._last_n = n
        start = self._next
        out = ((start + np.arange(len(msgs))) % n).tolist()
        self._next = (start + len(msgs)) % n
        return out

    def rewind(self, n: int) -> None:
        self._next = (self._next - n) % self._last_n


class JoinShortestQueueScheduler(Scheduler):
    """Route to the minimum-depth queue; ties broken by lowest index."""

    name = "jsq"
    supports_batch = True

    def pick(self, queues: Sequence[QueueView]) -> int:
        best, best_depth = 0, queues[0].depth()
        for i in range(1, len(queues)):
            d = queues[i].depth()
            if d < best_depth:
                best, best_depth = i, d
        return best

    def pick_view(self, msg: Any, view: LoadView) -> int:
        # np.argmin returns the first occurrence of the minimum — the
        # same lowest-index tie-break as the scalar scan.
        return int(view.depths.argmin())

    def pick_batch(self, msgs: Sequence[Any], view: LoadView) -> List[int]:
        # Exact sequential-argmin simulation in O(B log n): a heap keyed
        # (depth, index) pops the lowest-index minimum, each assignment
        # bumps the key by one — identical to B scalar picks with the
        # queue growing under each.
        depths = view.depths
        n = len(depths)
        if n == 1:
            out = [0] * len(msgs)
            depths[0] += len(msgs)
            return out
        heap = [(int(depths[i]), i) for i in range(n)]
        heapq.heapify(heap)
        out = []
        for _ in msgs:
            d, i = heap[0]
            out.append(i)
            heapq.heapreplace(heap, (d + 1, i))
            depths[i] += 1
        return out


class PowerOfTwoScheduler(Scheduler):
    """Sample two queues uniformly, route to the shorter."""

    name = "pow2"
    supports_batch = True

    def __init__(self, seed: int = 0) -> None:
        self._seed = seed
        self._rng = random.Random(seed)

    def reset(self, num_tasks: int) -> None:
        # Restore the *seeded* state: a pool restart/rebuild that resets
        # its scheduler must route exactly like a fresh run, or replay
        # determinism breaks for P2C while holding for every other
        # scheduler.
        self._rng = random.Random(self._seed)

    def _sample(self, n: int) -> tuple:
        i = self._rng.randrange(n)
        j = self._rng.randrange(n - 1)
        if j >= i:
            j += 1
        return i, j

    def pick(self, queues: Sequence[QueueView]) -> int:
        n = len(queues)
        if n == 1:
            return 0
        i, j = self._sample(n)
        return i if queues[i].depth() <= queues[j].depth() else j

    def pick_view(self, msg: Any, view: LoadView) -> int:
        n = len(view)
        if n == 1:
            return 0
        i, j = self._sample(n)
        depths = view.depths
        return i if depths[i] <= depths[j] else j

    def pick_batch(self, msgs: Sequence[Any], view: LoadView) -> List[int]:
        # Identical RNG draw sequence to the scalar loop, resolved as
        # two array gathers per message against the planned depths.
        depths = view.depths
        n = len(depths)
        if n == 1:
            out = [0] * len(msgs)
            depths[0] += len(msgs)
            return out
        out = []
        for _ in msgs:
            i, j = self._sample(n)
            k = i if depths[i] <= depths[j] else j
            depths[k] += 1
            out.append(k)
        return out


class PartitionAffinityScheduler(Scheduler):
    """Route a message to the queue matching its source partition.

    The training pipeline's ordered mode depends on this: with one
    assembly queue per partition and partition-affine forwarding, each
    queue is a per-partition FIFO, so draining the queues round-robin
    yields documents in a strict partition-rotation order — a pure
    function of the committed offsets, which is what makes batch
    assembly (and therefore crash replay) deterministic.  Messages
    without a source partition fall back to queue 0."""

    name = "partition"
    supports_batch = True
    msg_pure = True

    def pick(self, queues: Sequence[QueueView]) -> int:
        return 0

    def pick_msg(self, msg: Any, queues: Sequence[QueueView]) -> int:
        partition = getattr(msg, "partition", -1)
        return partition % len(queues) if partition >= 0 else 0

    def pick_view(self, msg: Any, view: LoadView) -> int:
        partition = getattr(msg, "partition", -1)
        return partition % len(view) if partition >= 0 else 0

    def pick_batch(self, msgs: Sequence[Any], view) -> List[int]:
        n = len(view)
        return [
            p % n if (p := getattr(m, "partition", -1)) >= 0 else 0
            for m in msgs
        ]

    def rewind(self, n: int) -> None:
        pass  # stateless


class DeadlineScheduler(JoinShortestQueueScheduler):
    """Earliest-deadline-first admission over JSQ routing.

    ``order`` sorts a dispatch batch by the payload's ``deadline``
    (fallback: descending ``priority``); the sort is stable, so equal
    deadlines stay FIFO — one stable sort per batch is already the
    vectorized admission path.  Routing inherits JSQ (scalar and batch:
    the heap-simulated argmin sweep) — an urgent message should land on
    the queue that will serve it soonest."""

    name = "edf"

    def order(self, msgs: Sequence[Any]) -> List[Any]:
        return sorted(msgs, key=_deadline_of)


class FleetDeadlinePolicy(DeadlineScheduler):
    """``edf`` lifted one level: cross-pool (multi-tenant) arbitration.

    Message dispatch is inherited unchanged from :class:`DeadlineScheduler`
    (EDF admission order over JSQ routing — scalar and ``pick_batch``
    alike), so a tenant pool running this policy behaves exactly like
    ``edf``.  On top of that, the policy ranks *tenants* the same way
    ``order`` ranks messages: :meth:`urgency` maps a tenant's
    ``(priority, deadline headroom)`` to a sortable key where strict
    priority dominates (a priority-2 tenant always outranks a priority-1
    one — that is what makes preemption *priority* preemption) and,
    within a priority class, earlier head-of-line deadlines rank sooner
    — the ``_deadline_of`` key family applied to pools instead of
    payloads.  ``serving.fleet.FleetManager`` sorts tenants by this key
    when dividing cluster capacity each arbitration round and picks
    preemption victims from the tail of the ranking.
    """

    name = "fleet_edf"

    @staticmethod
    def urgency(priority: int, headroom: Optional[float]) -> tuple:
        """Sort key (ascending = most urgent first): higher priority
        first; within a priority, the smallest deadline headroom (time
        until the oldest waiting request misses its SLO) first; tenants
        with no waiting work (``headroom=None``) last in their class."""
        return (
            -float(priority or 0),
            float(headroom) if headroom is not None else float("inf"),
        )

    def rank(self, demands: Sequence[Any]) -> List[int]:
        """Indices of ``demands`` (objects with ``.priority`` and
        ``.headroom``) from most to least urgent; ties stay in input
        order (stable, deterministic)."""
        return sorted(
            range(len(demands)),
            key=lambda i: self.urgency(
                getattr(demands[i], "priority", 0),
                getattr(demands[i], "headroom", None),
            ),
        )


_REGISTRY: dict[str, Callable[[], Scheduler]] = {
    "round_robin": RoundRobinScheduler,
    "fcfs": RoundRobinScheduler,
    "jsq": JoinShortestQueueScheduler,
    "pow2": PowerOfTwoScheduler,
    "edf": DeadlineScheduler,
    "fleet_edf": FleetDeadlinePolicy,
    "partition": PartitionAffinityScheduler,
}


def make_scheduler(name: str, **kwargs) -> Scheduler:
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown scheduler {name!r}; available: {sorted(_REGISTRY)}"
        ) from None
    return factory(**kwargs)  # type: ignore[call-arg]


def scheduler_names() -> List[str]:
    return sorted(_REGISTRY)
