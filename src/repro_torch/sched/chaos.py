"""Failure-injecting chaos harness for the virtual cluster.

A verbatim copy of ``repro.sched.chaos`` (pure Python), over the port's
``cluster``, ``events`` and ``inter_task``: the port imports nothing of the
JAX package.

Two injection layers:

  * ``FaultyTaskDriver`` — wraps any ``TaskDriver`` and fires planned
    ``REPLICA_FAILED`` faults at chosen *task-local work* times: the
    chunk containing the fault point is lost once and re-executed after
    a bounded ``backoff`` (the chunk is billed ``2*dt + backoff``
    virtual seconds), while the wrapped driver's state only ever
    advances on the successful retry — so the loss trajectory is
    bitwise identical to an un-faulted run. Because faults trigger on
    task-local progress (not global cluster time), wrapping the SAME
    drivers into the elastic runtime and into ``execute_static`` charges
    IDENTICAL penalties to both, which is what lets the exact
    elastic <= static theorem survive injection: ``residual_estimate``
    reserves ``chunk_bound + backoff`` per pending fault, keeping
    residuals sound monotone-shrinking upper bounds, and ``chaos_spec``
    inflates the planner duration by the same reserve.

  * ``ElasticClusterRuntime.inject_fault`` (sched/cluster.py) — a
    runtime-level ``POD_KILLED`` at a chosen *virtual cluster* time: the
    pod's driver is suspended at its last chunk boundary and requeued
    with backoff through the runtime's resume path. Use ``FaultPlan`` +
    ``FaultyTaskDriver`` for property tests (penalties are
    schedule-independent), ``inject_fault`` for end-to-end pod-loss
    drills.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from repro_torch.sched.cluster import DriverChunk, TaskDriver
from repro_torch.sched.events import EventKind, ProgressEvent
from repro_torch.sched.inter_task import TaskSpec

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injected chunk failure at ``at_progress`` task-local work
    seconds, retried after ``backoff`` seconds."""
    at_progress: float
    backoff: float = 0.0


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Task name -> planned faults (the chaos schedule for a workload)."""
    faults: Dict[str, Tuple[Fault, ...]] = dataclasses.field(
        default_factory=dict)

    def for_task(self, name: str) -> List[Fault]:
        return sorted(self.faults.get(name, ()),
                      key=lambda f: f.at_progress)

    def total(self) -> int:
        return sum(len(v) for v in self.faults.values())


class FaultyTaskDriver(TaskDriver):
    """Deterministic fault wrapper around any ``TaskDriver``.

    ``chunk_bound`` must upper-bound the wrapped driver's single-chunk
    ``dt`` (e.g. ``chunk_steps * step_time_s`` for the simulated driver);
    it is what each not-yet-fired fault reserves in the residual."""

    def __init__(self, name: str, inner: TaskDriver,
                 faults: Sequence[Fault], chunk_bound: float):
        self.name = name
        self.inner = inner
        self.chunk_bound = float(chunk_bound)
        self._faults = sorted(faults, key=lambda f: f.at_progress)
        self._fi = 0                      # next fault to fire
        self._progress = 0.0              # successful task-local work time
        self.faults_injected = 0

    def start(self, now: float) -> None:
        self.inner.start(now)

    def step_chunk(self) -> DriverChunk:
        chunk = self.inner.step_chunk()
        dt = chunk.dt
        extra = 0.0
        events = list(chunk.events)
        # every fault landing inside (progress, progress + dt] loses this
        # chunk once: bill the lost attempt + backoff, then the retry
        # (the inner chunk we already hold) succeeds
        while (self._fi < len(self._faults)
               and self._faults[self._fi].at_progress
               <= self._progress + dt + _EPS):
            f = self._faults[self._fi]
            self._fi += 1
            self.faults_injected += 1
            extra += dt + f.backoff
            events.insert(0, ProgressEvent(
                kind=EventKind.REPLICA_FAILED, task=self.name,
                reason="injected",
                detail=f"at={f.at_progress:.3f} backoff={f.backoff:.3f}"))
        self._progress += dt
        return DriverChunk(dt=dt + extra, events=tuple(events),
                           done=chunk.done)

    def _pending_reserve(self) -> float:
        return sum(self.chunk_bound + f.backoff
                   for f in self._faults[self._fi:])

    def residual_estimate(self) -> float:
        # sound upper bound: the inner residual plus a full reserve for
        # each pending fault. When a fault fires it costs dt + backoff
        # <= chunk_bound + backoff, so the estimate never under-counts
        # and shrinks at least as fast as work completes.
        inner = self.inner.residual_estimate()
        if inner == float("inf"):
            return inner
        return inner + self._pending_reserve()

    def slots_bound(self):
        return self.inner.slots_bound()

    def result(self):
        return self.inner.result()


def chaos_spec(spec: TaskSpec, faults: Sequence[Fault],
               chunk_bound: float) -> TaskSpec:
    """Planner-visible duration for a fault-wrapped task: the base
    duration plus the same per-fault reserve ``residual_estimate``
    charges — keeping spec durations upper bounds under injection."""
    reserve = sum(float(chunk_bound) + f.backoff for f in faults)
    return dataclasses.replace(spec, duration=spec.duration + reserve)
