"""Serving replicas as first-class cluster residents.

A verbatim copy of ``repro.serve.driver`` (pure Python), over the port's
``cluster``, ``events`` and ``inter_task``: the port imports nothing of
the JAX package.

A serving replica holds GPUs the training planner must plan *around* —
not via a side-channel reservation API, but as an ordinary runtime task:
``ServingReplicaDriver`` implements the ``TaskDriver`` interface with a
finite serving *lease* (``horizon_s`` of virtual time), so
``ElasticClusterRuntime`` owns its GPUs through the normal ``_owner`` /
projected-skyline machinery — replans, utilization accounting and the
"unplaceable pending" guard all see the replica with zero new planner
mechanics. Retiring the replica early is ``runtime.cancel(name)``; the
lease expiring frees the GPUs like any task completion.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.sched.cluster import DriverChunk, TaskDriver
from repro_torch.sched.events import EventKind, ProgressEvent
from repro_torch.sched.inter_task import TaskSpec


def serving_spec(name: str, gpus: int, horizon_s: float,
                 release: float = 0.0) -> TaskSpec:
    """The TaskSpec a serving lease occupies in the plan."""
    assert horizon_s > 0 and gpus >= 1
    return TaskSpec(name=name, duration=horizon_s, gpus=gpus,
                    release=release)


class ServingReplicaDriver(TaskDriver):
    """A serving lease on the virtual timeline.

    Virtual time is decoupled from the replica's wall-clock decode work
    (serving is driven by tenant requests, not by the cluster loop), so
    ``step_chunk`` just burns the lease down in ``chunk_s`` slices and
    reports heartbeats; ``result`` summarizes what the attached frontend
    served. Deterministic for fixed construction, as the runtime's
    static-baseline property requires."""

    def __init__(self, name: str, *, horizon_s: float,
                 chunk_s: float = 60.0, frontend: Any = None):
        assert horizon_s > 0 and chunk_s > 0
        self.name = name
        self.horizon_s = horizon_s
        self.chunk_s = chunk_s
        self.frontend = frontend
        self._remaining = horizon_s
        self._started: Optional[float] = None

    def start(self, now: float) -> None:
        self._started = now

    def step_chunk(self) -> DriverChunk:
        dt = min(self.chunk_s, self._remaining)
        self._remaining -= dt
        done = self._remaining <= 1e-12
        ev = ProgressEvent(kind=EventKind.TASK_PROGRESS, task=self.name,
                           detail="serving_lease")
        return DriverChunk(dt=dt, events=(ev,), done=done)

    def residual_estimate(self) -> float:
        return self._remaining

    def slots_bound(self) -> Optional[int]:
        return None                 # serving slots live outside training

    def result(self) -> Any:
        out = {"kind": "serving_replica", "lease_s": self.horizon_s}
        fe = self.frontend
        if fe is not None:
            out.update(
                served_requests=fe.served_requests,
                publishes=fe.publishes,
                hot_publishes=fe.hot_publishes,
                resident_adapters=sorted(fe.pool.resident()),
                aggregate_tok_s=fe.replica.aggregate_tok_s)
        return out
