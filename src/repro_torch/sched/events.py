"""Lifecycle events a running task reports (``EventKind``, ``ProgressEvent``).

Copied from ``repro.sched.events``: every lifecycle transition that can
shrink a task's residual duration — warmup-selection drops, divergence and
overfitting exits, per-job completions, task completion — is one of these
events, which is what makes replanning event-driven rather than
poll-driven. The JAX package's ``ClusterSimulator`` and the journal's JSON
forms belong to the service slice and are not ported yet.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Tuple


class EventKind(enum.Enum):
    """Lifecycle transitions a running task reports to the runtime."""
    TASK_SUBMITTED = "task_submitted"
    TASK_ARRIVED = "task_arrived"           # dynamic admission into a live loop
    TASK_STARTED = "task_started"
    WARMUP_SELECTION = "warmup_selection"   # Pattern-3 drops at the boundary
    JOB_EXITED = "job_exited"               # divergence / overfit / budget
    TASK_PROGRESS = "task_progress"         # chunk heartbeat (no shrink)
    TASK_FUSED = "task_fused"               # co-located onto a live replica
    TASK_PREEMPTED = "task_preempted"       # guest evicted back to the queue
    TASK_MIGRATED = "task_migrated"         # guest moved to another replica
    TASK_COMPLETED = "task_completed"
    TASK_CANCELLED = "task_cancelled"       # tenant cancel (frees capacity)
    REPLAN = "replan"                       # runtime re-solved the queue
    ADAPTER_PUBLISHED = "adapter_published"  # winner pushed to serving tier
    REPLICA_FAILED = "replica_failed"       # injected chunk failure (chaos)
    POD_KILLED = "pod_killed"               # pod loss: task requeued w/ backoff
    TASK_RECOVERED = "task_recovered"       # restored from durable state

# Kinds that can shrink a task's residual duration and therefore trigger
# a replan of the pending queue.
SHRINK_KINDS = frozenset({EventKind.WARMUP_SELECTION, EventKind.JOB_EXITED,
                          EventKind.TASK_COMPLETED, EventKind.TASK_CANCELLED})

# Terminal kinds for a task (the service's handle-state transitions).
TERMINAL_KINDS = frozenset({EventKind.TASK_COMPLETED,
                            EventKind.TASK_CANCELLED})


@dataclasses.dataclass(frozen=True)
class ProgressEvent:
    kind: EventKind
    task: str
    time: float = 0.0            # virtual cluster time (runtime fills this)
    job: str = ""                # job id for JOB_EXITED
    reason: str = ""             # exit reason / replan outcome
    step: int = 0                # executor step at which it fired
    dropped: Tuple[str, ...] = ()  # job ids dropped at warmup selection
    detail: str = ""

    def shrinks(self) -> bool:
        return self.kind in SHRINK_KINDS

    def stamped(self, time: float) -> "ProgressEvent":
        return dataclasses.replace(self, time=time)
