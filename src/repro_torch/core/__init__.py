"""The paper's contribution: virtual messaging, supervision, elasticity,
event-sourced state, CRDTs, schedulers, the cluster/placement layer, and
the Liquid/Reactive-Liquid pipelines — one actuator, stepped on the
caller's clock.  The discrete-event simulator and the threaded live
runtime are not ported yet."""

from repro_torch.core.cluster import (
    Cluster,
    FailureConfig,
    FailureInjector,
    Node,
    StepCost,
)
from repro_torch.core.messages import Message, Mailbox, MessageBus
from repro_torch.core.crdt import GCounter, PNCounter, LWWRegister, GSet, ORSet, VClock
from repro_torch.core.state import Event, EventJournal, Snapshot, EventSourcedState
from repro_torch.core.scheduler import (
    RoundRobinScheduler,
    JoinShortestQueueScheduler,
    PowerOfTwoScheduler,
    make_scheduler,
)
