"""Event-driven inter-task replanning (paper §7.2 "Event-driven replanning").

A verbatim copy of ``repro.sched.events`` (pure Python), over the port's
``inter_task``: the port imports nothing of the JAX package.

Two layers live here:

  * ``ProgressEvent``/``EventKind``: the event vocabulary shared by the
    chunked executor (core/executor.py), the elastic cluster runtime
    (sched/cluster.py), and the engine. Every lifecycle transition that can
    shrink a task's residual duration — warmup-selection drops, divergence
    and overfitting exits, per-job completions, task completion — is one of
    these events, which is what makes replanning event-driven rather than
    poll-driven. Placement transitions are events too: ``TASK_FUSED`` (a
    pending task co-located onto a live replica), ``TASK_PREEMPTED`` (a
    guest evicted back to the pending queue, its live adapter state
    suspended bit-exactly), and ``TASK_MIGRATED`` (a guest moved onto a
    different replica mid-task). Contract: the event log is the *complete*
    audit trail of every capacity decision the runtime makes — a consumer
    replaying starts/fusions/preemptions/migrations/completions can
    reconstruct GPU ownership at any virtual time. ``event_to_json`` /
    ``event_from_json`` are its JSON forms.
  * ``ClusterSimulator``: the original coarse (task-granularity)
    discrete-event simulator over the same solver the engine uses, kept for
    the scheduler benchmarks (Figs. 5/12). The elastic runtime in
    sched/cluster.py supersedes it for engine execution: it sees *intra*-task
    events, not just completions.
"""
from __future__ import annotations

import dataclasses
import enum
import heapq
from typing import Dict, List, Optional, Tuple

from repro_torch.sched.inter_task import TaskSpec, solve


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


def event_to_json(event: ProgressEvent) -> Dict:
    """JSON-able dict form of a ``ProgressEvent`` (journal line payload)."""
    d = dataclasses.asdict(event)
    d["kind"] = event.kind.value
    d["dropped"] = list(event.dropped)
    return d


def event_from_json(d: Dict) -> ProgressEvent:
    """Inverse of ``event_to_json`` (journal replay)."""
    return ProgressEvent(
        kind=EventKind(d["kind"]), task=d["task"],
        time=float(d.get("time", 0.0)), job=d.get("job", ""),
        reason=d.get("reason", ""), step=int(d.get("step", 0)),
        dropped=tuple(d.get("dropped", ())), detail=d.get("detail", ""))


@dataclasses.dataclass
class TaskRun:
    spec: TaskSpec
    submit_time: float
    start_time: Optional[float] = None
    end_time: Optional[float] = None
    gpu_ids: Tuple[int, ...] = ()
    actual_duration: Optional[float] = None   # may be < spec.duration (EE)


class ClusterSimulator:
    """Discrete-event multi-tenant cluster with replanning."""

    def __init__(self, G: int, method: str = "cp"):
        self.G = G
        self.method = method
        self.now = 0.0
        self.free: List[int] = list(range(G))
        self.pending: List[TaskRun] = []
        self.running: List[Tuple[float, TaskRun]] = []     # (end, run) heap
        self.done: List[TaskRun] = []
        self.replans = 0

    # ---- events -------------------------------------------------------------
    def submit(self, spec: TaskSpec, actual_duration: Optional[float] = None,
               at: Optional[float] = None) -> TaskRun:
        if at is not None:
            self.now = max(self.now, at)
        run = TaskRun(spec=spec, submit_time=self.now,
                      actual_duration=(actual_duration
                                       if actual_duration is not None
                                       else spec.duration))
        self.pending.append(run)
        self._replan()
        return run

    def _complete(self, run: TaskRun) -> None:
        self.free.extend(run.gpu_ids)
        self.done.append(run)
        self._replan()

    def _replan(self) -> None:
        """Greedy dispatch of the solver's next-start decisions at t=now:
        solve over pending (capacity = whole cluster), then start every task
        the plan places at relative time 0 on currently free GPUs."""
        if not self.pending:
            return
        self.replans += 1
        plan = solve([r.spec for r in self.pending], self.G, self.method)
        by_name: Dict[str, TaskRun] = {}
        for r in self.pending:
            by_name.setdefault(r.spec.name, r)
        started = []
        for p in sorted(plan.placements, key=lambda p: p.start):
            if p.start > 1e-9:
                break
            run = by_name[p.task.name]
            if len(self.free) < run.spec.gpus:
                continue
            ids = tuple(self.free[:run.spec.gpus])
            self.free = self.free[run.spec.gpus:]
            run.start_time = self.now
            run.gpu_ids = ids
            run.end_time = self.now + run.actual_duration
            heapq.heappush(self.running, (run.end_time, id(run), run))
            started.append(run)
        for r in started:
            self.pending.remove(r)

    # ---- clock --------------------------------------------------------------
    def run_until_idle(self) -> float:
        """Advance until all tasks complete. Returns makespan."""
        while self.running or self.pending:
            if not self.running:
                # pending but nothing running => couldn't place (shouldn't
                # happen when g_i <= G); force a replan
                self._replan()
                if not self.running:
                    raise RuntimeError("deadlocked pending tasks")
            end, _, run = heapq.heappop(self.running)
            self.now = end
            self._complete(run)
        return max((r.end_time or 0.0) for r in self.done) if self.done else 0.0
