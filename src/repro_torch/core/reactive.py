"""The live Reactive Liquid pipeline (paper §3.2).

``ReactiveJob`` is now a **one-stage dataflow graph**: the five-layer
wiring — messaging topic → virtual consumer group → task mailboxes →
``ElasticPool`` of tasks → (optional) output topic — is the generic
``core.dataflow.Stage`` in ``feed="mailboxes"`` mode, held inside a
one-node ``StageGraph``.  This module is only the back-compat surface:
the task view (``tasks``/``stats``), the chaos hooks, and the historical
constructor.  The private virtual-consumer supervision and forwarding
loops this class used to carry live in ``Stage`` now; multi-stage chains
use ``StageGraph`` directly (see DESIGN.md §2).

Semantics upgrade that comes free with the re-base: the consumer group
runs in *manual-commit* mode with **commit-after-publish** — offsets
advance only once a task's outputs are durably appended to the output
topic — so with a spilled log a killed process replays the uncommitted
suffix instead of losing it (the old per-forward commits were lossy
across process death).  Exactly-once effects within a life are the
workers' ``(partition, offset)``-keyed dedup windows; exactly-once
*topic contents* across lives are the stage's publish dedup.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

from repro_torch.core.cluster import Cluster, StepCost
from repro_torch.core.dataflow import Stage, StageGraph, StageWorker, StageWorkerStats
from repro_torch.core.elastic import AutoscalerConfig
from repro_torch.core.messages import Message
from repro_torch.core.state import EventJournal
from repro_torch.core.supervision import Supervisor
from repro_torch.data.topics import MessageLog, Topic

ProcessFn = Callable[[Message], List[Any]]

# Back-compat aliases: ReactiveTask IS the generic stage worker now.
ReactiveTask = StageWorker
ReactiveTaskStats = StageWorkerStats


class ReactiveJob:
    """A job on the Reactive Liquid stack — a thin shim over a one-stage
    ``StageGraph``.

    The task pool is elastic (autoscaled on mailbox depth plus parked
    topic lag) and unlimited by partition count; virtual consumers are
    supervised, stateful (journaled offsets) workers.  All pool
    mechanics — spawn, retire (overflow-safe drain to the survivors),
    Let-It-Crash restart, heartbeat supervision, CRDT telemetry — come
    from ``ElasticPool``; all stage mechanics — forwarding, admission
    dedup, commit-after-publish, vc supervision — from ``Stage``.
    """

    def __init__(
        self,
        name: str,
        log: MessageLog,
        in_topic: str,
        process: ProcessFn,
        out_topic: Optional[str] = None,
        initial_tasks: int = 4,
        scheduler: str = "round_robin",
        batch_n: int = 10,
        mailbox_capacity: int = 0,
        autoscaler: Optional[AutoscalerConfig] = None,
        journal_factory: Optional[Callable[[int], EventJournal]] = None,
        supervisor: Optional[Supervisor] = None,
        heartbeat_timeout: float = 10.0,
        elastic: bool = True,
        cluster: Optional[Cluster] = None,
        restart_cost: float = 0.0,
        step_cost: Optional[StepCost] = None,
        straggler_threshold: float = 0.0,
        consume_cost: Optional[float] = None,
        completion_window: Optional[int] = 65536,
    ) -> None:
        self.name = name
        self.log = log
        self.topic: Topic = log.get(in_topic)
        self.process = process
        self.graph = StageGraph(log)
        self.stage = self.graph.add(Stage(
            name,
            log,
            in_topic,
            out_topic,
            process=process,
            feed="mailboxes",
            initial_tasks=initial_tasks,
            scheduler=scheduler,
            batch_n=batch_n,
            mailbox_capacity=mailbox_capacity,
            autoscaler=autoscaler
            or AutoscalerConfig(min_workers=1, max_workers=256, cooldown=0.0),
            elastic=elastic,
            supervisor=supervisor,
            heartbeat_timeout=heartbeat_timeout,
            journal_factory=journal_factory,
            cluster=cluster,
            restart_cost=restart_cost,
            step_cost=step_cost,
            straggler_threshold=straggler_threshold,
            consume_cost=consume_cost,
            completion_window=completion_window,
            metric_prefix="job",
            worker_noun="task",
        ))
        self.pool = self.stage.pool
        self.consumer_group = self.stage.consumers

    # -- pool views ----------------------------------------------------------
    @property
    def tasks(self) -> List[StageWorker]:
        return self.pool.workers

    @property
    def supervisor(self) -> Supervisor:
        return self.pool.supervisor

    @property
    def elastic(self) -> bool:
        return self.pool.elastic

    # -- main loop ----------------------------------------------------------
    def step(self, now: float = 0.0, task_budget: "int | None" = None) -> int:
        """One pipeline round: consume->forward, process, publish, scale.

        ``task_budget`` overrides every task's per-round budget; ``None``
        (the default) leaves each worker's own ``step_budget`` alone —
        required when the pool's cost metering owns the budgets."""
        if task_budget is not None:
            for task in self.pool.workers:
                task.step_budget = task_budget
        return self.stage.step(now)

    def run_to_completion(self, max_rounds: int = 1_000_000) -> int:
        self.graph.run_to_completion(max_rounds=max_rounds)
        return self.total_processed()

    def total_processed(self) -> int:
        return self.pool.counter("task.processed")

    def backlog(self) -> int:
        return self.stage.pending()
