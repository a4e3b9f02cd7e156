"""Elastic cluster runtime: event-driven execution of an inter-task Schedule.

A verbatim copy of ``repro.sched.cluster`` (pure Python), over the port's
``inter_task``, ``intra_task``, ``events`` and ``profiler``: the port
imports nothing of the JAX package. ``ExecutorTaskDriver`` drives the
port's ``BatchedExecutor`` (``run_task_chunks`` / ``resume_task_chunks``
and the ``ChunkReport`` fields it reads are the reference's).

The static engine path executes a precomputed Schedule literally: when a
task's jobs exit early its GPUs idle until the worst-case plan says
otherwise. This runtime closes that gap (paper §7.2 "event-driven
replanning"): it executes the Schedule as an event loop over a simulated
G-GPU cluster, stepping each running task's driver in bounded chunks.
Whenever a chunk surfaces a shrink event (warmup-selection drop,
divergence/overfit exit, completion), the runtime

  1. re-estimates the residual ``TaskSpec`` of every running task from its
     driver's ``residual_estimate()`` (observed survivor counts),
  2. re-solves placement of the pending queue over the projected per-GPU
     skyline (``branch_and_bound`` for small queues, ``lpt_schedule``
     fallback — ``solve_residual``), and
  3. admits newly-placeable tasks immediately instead of at their static
     start times.

Anomaly safety: greedy replanning under shrinking durations is vulnerable
to Graham list-scheduling anomalies (a "better" plan under estimates can
realize worse). With ``delay_delta=None`` (the default, and what the
batch-mode engine path uses) the runtime only *adopts* a re-solved plan
when it starts every pending task no later than the task's incumbent
planned start (``s_j``). Together with non-delay dispatch this yields the
hard guarantee

    realized start(j) <= s_j  for every task j
    => elastic makespan = max_j(start_j + actual_j)
                       <= max_j(s_j + actual_j) = static makespan

on every instance whose actual durations never exceed the estimates — which
holds structurally for ALTO tasks, where events only remove work.

Service sessions (dynamic arrivals) instead use the **bounded-delay
adoption rule** (``delay_delta=δ``): a candidate plan that delays some
pending task past its incumbent bound by ``max_delay`` is adopted only if
its projected makespan beats the regret fallback's by at least
``δ * max_delay``; otherwise the fallback — incumbent placements untouched,
new arrivals appended over the projected skyline — is adopted. Every unit
of promised delay is therefore bought by at least δ units of projected
makespan win, and a task's bound moves only when that price was paid, so
the plan's projected makespan is non-increasing between arrivals and the
session never does worse than the never-delay (anomaly-safe) policy by
more than the sum of bought delays — each of which shrank the projection
by δ× more than it cost.

Fusion-aware planning (``fusion_planning=True``) lifts co-location from an
admission-time backstop to a plan decision: every replan solves with
``plan_fused`` over live ``ReplicaState`` projections (slot headroom +
linearized SS A.3+k2 memory budgets), so the solver itself decides which
queued tasks ride replica slots and which get exclusive GPUs. Adopted
fusion assignments are re-checked against live capacity when applied
(``_apply_planned_fusions``) — capacity drift makes them stale, never
unsound. With ``migrate=True`` the runtime also runs the reverse move:
a guest whose residual extends its replica past the host's own projected
end is migrated to another same-fuse-key replica or preempted back to the
queue (``TASK_MIGRATED`` / ``TASK_PREEMPTED``), but ONLY when the new
placement is projected to complete the guest no later than staying put —
so the fusion-time occupancy bound, and with it elastic <= static,
survives every move. Preempted/migrated drivers keep their internal
progress (the virtual-time analogue of the SlotSnapshot suspend/resume
primitive in core/adapter_state.py, whose restore is bit-exact), which is
why a migrated task's losses are bitwise identical to a never-migrated
run's.

The runtime is an incremental *session*: ``begin()`` opens the event loop,
``step()`` advances it by one event (an arrival, a cancellation, or one
driver chunk), ``submit(..., at=...)`` and ``cancel(...)`` may be called
while the loop is live, and ``report()`` snapshots the state at idle.
``run()`` keeps the original one-shot semantics (begin, drain, report).

Drivers decouple the runtime from what a "task" is:

  * ``BatchedExecutor.run_task_chunks`` wrapped in ``ExecutorTaskDriver``
    (the engine's real training path), and
  * ``SimulatedTaskDriver`` (same lifecycle, virtual time only) for
    benchmarks and property tests.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.early_exit import EarlyExitConfig
from repro_torch.sched.events import EventKind, ProgressEvent
from repro_torch.sched.inter_task import (FusionProfile, Placement,
                                          ReplicaState, Schedule, TaskSpec,
                                          diff_schedules, lpt_schedule,
                                          plan_fused, solve, solve_residual)
from repro_torch.sched.intra_task import (ColoRequest, MemoryModel,
                                          admit_cross_task)

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class DriverChunk:
    """One bounded slice of task progress in virtual time."""
    dt: float                              # virtual seconds consumed
    events: Tuple[ProgressEvent, ...] = ()
    done: bool = False


@dataclasses.dataclass(frozen=True)
class ColocationSpec:
    """A task's shared-backbone co-location profile.

    Tasks with EQUAL ``fuse_key`` may share one frozen-backbone replica.
    Since slots went ragged the key carries only what the fused step
    genuinely requires — (arch, GPU demand, loss kind); per-adapter batch
    size and seq len are PER-SLOT properties now, so heterogeneous widths
    fuse freely and instead enter admission as a token budget:
    ``per_adapter_batch`` x ``seq_len`` is the task's per-slot token
    width, the replica hosting the task has ``replica_slots`` physical
    adapter slots, the task itself needs at most ``slots_needed`` of them
    concurrently, and ``mem`` is the replica's fitted §A.3 memory model
    (token-linear, safety-margin bounded) that ragged cross-task
    admission checks ``admit_cross_task`` against."""
    fuse_key: Tuple
    per_adapter_batch: int
    slots_needed: int
    replica_slots: int
    mem: Optional[MemoryModel] = None
    seq_len: Optional[int] = None      # None => memory model's fit seq
    lora_rank: Optional[int] = None    # TRUE rank; None => charged r_max


class TaskDriver:
    """Interface the runtime steps. Implementations must be deterministic
    for a fixed construction (the same driver replayed standalone must
    produce the same chunk sequence — the static baseline depends on it)."""

    def start(self, now: float) -> None:          # pragma: no cover
        raise NotImplementedError

    def step_chunk(self) -> DriverChunk:          # pragma: no cover
        raise NotImplementedError

    def residual_estimate(self) -> float:         # pragma: no cover
        """Upper bound (seconds) on remaining work; must shrink over time."""
        raise NotImplementedError

    def slots_bound(self) -> Optional[int]:
        """Monotone upper bound on the task's future concurrent adapter-
        slot use, or None if unknown. Cross-task admission uses it to
        reclaim replica capacity the moment survivors free it."""
        return None

    def result(self) -> Any:
        return None


# --------------------------------------------------------------------------
# Co-located replica: several task timelines multiplexed on one GPU set
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _Hosted:
    driver: TaskDriver
    colo: Optional[ColocationSpec]
    offset: float                     # replica-local time at attach
    elapsed: float = 0.0              # own-timeline seconds consumed
    done: bool = False
    end: Optional[float] = None       # replica-local completion time

    @property
    def clock(self) -> float:
        return self.offset + self.elapsed


class ColocatedReplicaDriver(TaskDriver):
    """One frozen-backbone replica hosting adapter slots from SEVERAL
    tasks, multiplexed behind the ordinary ``TaskDriver`` interface.

    The replica owns ONE GPU set (the host task's). Each hosted task
    keeps its own timeline; ``step_chunk`` always advances the lagging
    timeline and reports the movement of the replica-wide frontier
    (max over task clocks), so concurrent tasks consume wall-clock once —
    the fused grouped-GEMM utilization win the paper claims. Per-task
    residuals, completion times, and results stay individually
    addressable (``residual_of`` / ``end_of`` / ``result_of``), and every
    event a hosted task emits already carries its own task attribution.

    Soundness: the runtime only attaches a task whose residual fits
    inside the replica's current projected end (and whose incumbent start
    bound has not passed), so attaching never extends the projected
    occupancy — the elastic <= static argument survives co-location."""

    def __init__(self, name: str, driver: TaskDriver,
                 colo: Optional[ColocationSpec], elapsed: float = 0.0):
        self.name = name
        self._subs: Dict[str, _Hosted] = {
            name: _Hosted(driver, colo, 0.0, elapsed)}
        self._frontier = elapsed

    # ---- capacity ----------------------------------------------------------
    @property
    def capacity(self) -> Optional[ColocationSpec]:
        return self._subs[self.name].colo

    def _bound_of(self, h: _Hosted) -> int:
        b = h.driver.slots_bound()
        if b is not None:
            return b
        return h.colo.slots_needed if h.colo is not None else 0

    def resident_requests(self) -> List[ColoRequest]:
        """Live tasks' current demand on the replica (for cross-task
        admission): shrinking slot bounds reclaim freed capacity. Demand
        is token-denominated (slots x b x seq) — co-located tasks may
        have different widths (ragged slots)."""
        return [ColoRequest(n, self._bound_of(h),
                            h.colo.per_adapter_batch if h.colo else 0,
                            h.colo.seq_len if h.colo else None,
                            h.colo.lora_rank if h.colo else None)
                for n, h in sorted(self._subs.items()) if not h.done]

    # ---- membership --------------------------------------------------------
    def attach(self, name: str, driver: TaskDriver,
               colo: Optional[ColocationSpec]) -> None:
        assert name not in self._subs, f"{name} already hosted"
        self._subs[name] = _Hosted(driver, colo, self._frontier)

    def cancel_hosted(self, name: str) -> None:
        h = self._subs[name]
        h.done = True
        h.end = h.clock

    def detach(self, name: str) -> TaskDriver:
        """Remove a LIVE hosted guest for preemption/migration and return
        its driver with all internal progress intact — the virtual-time
        analogue of a SlotSnapshot suspend. The driver can be re-attached
        to another replica or resumed exclusively; either way it continues
        from exactly where it stopped. The replica owner cannot detach
        (its GPU set IS the replica)."""
        assert name != self.name, "cannot detach the replica owner"
        h = self._subs.pop(name)
        assert not h.done, f"{name} already finished on this replica"
        return h.driver

    def sub_names(self) -> List[str]:
        return list(self._subs)

    def hosted_names(self) -> List[str]:
        return [n for n in self._subs if n != self.name]

    def end_of(self, name: str) -> Optional[float]:
        """Replica-local completion time (absolute = replica start + this)."""
        return self._subs[name].end

    def result_of(self, name: str) -> Any:
        h = self._subs[name]
        return h.driver.result() if h.done else None

    def result(self) -> Any:
        return self.result_of(self.name)

    # ---- TaskDriver --------------------------------------------------------
    def start(self, now: float) -> None:
        self._subs[self.name].driver.start(now)

    def step_chunk(self) -> DriverChunk:
        """Advance the lagging task timeline one chunk; return the
        frontier movement. Zero-progress catch-up chunks are absorbed
        internally so the runtime's stall detector never trips on a
        long-lagging timeline."""
        start = self._frontier
        events: List[ProgressEvent] = []
        spins = 0
        while True:
            live = [(h.clock, n) for n, h in sorted(self._subs.items())
                    if not h.done]
            if not live:
                return DriverChunk(dt=self._frontier - start,
                                   events=tuple(events), done=True)
            spins += 1
            if spins > 10_000:
                # a sub-driver is emitting empty zero-dt chunks: hand a
                # zero chunk back so the runtime's stall detector sees it
                return DriverChunk(dt=self._frontier - start,
                                   events=tuple(events), done=False)
            _, pick = min(live)
            h = self._subs[pick]
            chunk = h.driver.step_chunk()
            h.elapsed += chunk.dt
            events.extend(chunk.events)
            if chunk.done:
                h.done = True
                h.end = h.clock
            self._frontier = max(self._frontier, h.clock)
            if all(s.done for s in self._subs.values()):
                return DriverChunk(dt=self._frontier - start,
                                   events=tuple(events), done=True)
            if self._frontier > start + _EPS or events:
                return DriverChunk(dt=self._frontier - start,
                                   events=tuple(events), done=False)

    def residual_estimate(self) -> float:
        ends = [h.clock + h.driver.residual_estimate()
                for h in self._subs.values() if not h.done]
        if not ends:
            return 0.0
        return max(max(ends) - self._frontier, 0.0)

    def residual_of(self, name: str) -> float:
        h = self._subs[name]
        return 0.0 if h.done else h.driver.residual_estimate()

    def slots_bound(self) -> Optional[int]:
        return sum(self._bound_of(h) for h in self._subs.values()
                   if not h.done)


@dataclasses.dataclass
class _Running:
    spec: TaskSpec
    driver: TaskDriver
    gpu_ids: Tuple[int, ...]
    start: float
    local_time: float
    residual: float
    zero_chunks: int = 0
    saw_completed: bool = False


@dataclasses.dataclass
class RuntimeReport:
    makespan: float
    realized: Schedule                 # actual placements (validates vs G)
    events: List[ProgressEvent]
    replans: int
    plans_adopted: int
    plans_rejected: int
    gpu_busy: List[float]
    utilization: float
    results: Dict[str, Any]
    task_starts: Dict[str, float]
    task_ends: Dict[str, float]
    cancelled: Tuple[str, ...] = ()
    colocated: Dict[str, str] = dataclasses.field(default_factory=dict)
    preemptions: int = 0
    migrations: int = 0
    pod_kills: int = 0

    def per_gpu_utilization(self) -> List[float]:
        mk = max(self.makespan, _EPS)
        return [b / mk for b in self.gpu_busy]


@dataclasses.dataclass(frozen=True)
class _Submission:
    spec: TaskSpec
    factory: Callable[[], TaskDriver]
    at: float
    colo: Optional[ColocationSpec] = None


@dataclasses.dataclass
class _Suspended:
    """A preempted guest between placements: the detached driver keeps its
    internal progress, ``residual`` is the remaining virtual duration the
    solver plans with until the task is re-placed."""
    driver: TaskDriver
    residual: float


class ElasticClusterRuntime:
    """Incremental event-loop session over a simulated G-GPU cluster (see
    module docstring). ``run()`` is the one-shot batch entry; the service
    drives ``begin()``/``step()`` directly and injects ``submit(at=...)``
    arrivals and ``cancel()`` requests while the loop is live."""

    def __init__(self, G: int, method: str = "cp", bnb_max_n: int = 9,
                 validate: bool = True, max_zero_chunks: int = 10_000,
                 delay_delta: Optional[float] = None,
                 colocate: bool = False,
                 fusion_planning: bool = False,
                 migrate: bool = False):
        self.G = G
        self.method = method
        self.bnb_max_n = bnb_max_n
        self.validate = validate
        self.max_zero_chunks = max_zero_chunks
        self.delay_delta = delay_delta
        # fusion_planning: replans solve with plan_fused — co-location is a
        # first-class plan decision (replica slots with token/rank budgets),
        # not just an opportunistic backstop at admission. Implies colocate.
        # migrate: each replan may first evict or migrate a live guest whose
        # residual now extends its replica past the host's own projected end
        # (the host queue regrew relative to the shrunken replica).
        self.fusion_planning = fusion_planning
        self.migrate = migrate
        self.colocate = colocate or fusion_planning
        self.now = 0.0
        self._subs: List[_Submission] = []
        self._by_name: Dict[str, _Submission] = {}
        self._live = False
        self._seq = 0

    # ---------------------------------------------------------- admission
    def submit(self, spec: TaskSpec,
               driver_factory: Callable[[], TaskDriver],
               at: float = 0.0,
               colo: Optional[ColocationSpec] = None) -> None:
        """Queue a task. Before ``begin()`` this only records it (duplicate
        names surface at ``begin``, preserving batch semantics); on a live
        session it becomes an arrival event at virtual time ``at`` (clamped
        to now) that the next ``step()`` admits into the running loop.
        ``colo`` marks the task fusable: when the session runs with
        ``colocate=True``, a pending fusable task may be co-located onto a
        live same-``fuse_key`` replica instead of waiting for free GPUs."""
        assert spec.gpus <= self.G, f"{spec.name} needs {spec.gpus} > {self.G}"
        if not self._live:
            sub = _Submission(spec, driver_factory, max(at, 0.0), colo)
            self._subs.append(sub)
            return
        name = spec.name
        assert name not in self._by_name, f"duplicate task name {name}"
        at = max(at, self.now)
        sub = _Submission(dataclasses.replace(spec, release=at),
                          driver_factory, at, colo)
        self._by_name[name] = sub           # _subs was consumed by begin()
        self._future[name] = at
        self._push_ctrl(at, "arrive", name)

    def cancel(self, name: str, at: Optional[float] = None) -> bool:
        """Schedule cancellation of a task at virtual time ``at`` (default:
        now). Cancelling a running task frees its GPUs and triggers a
        replan; a pending / not-yet-arrived task is simply withdrawn.
        Returns False when the task is already terminal."""
        assert self._live, "cancel() requires a live session (begin/run)"
        assert name in self._by_name, f"unknown task {name}"
        if name in self._results or name in self._cancel_set:
            return False
        at = self.now if at is None else max(at, self.now)
        self._push_ctrl(at, "cancel", name)
        return True

    def inject_fault(self, name: str, at: Optional[float] = None,
                     backoff: float = 0.0) -> None:
        """Chaos injection: kill the pod running ``name`` at virtual time
        ``at``. The task's driver is suspended at its last completed chunk
        boundary (chunks are atomic — the virtual-time analogue of a
        durable checkpoint), its GPUs are freed, and it rejoins the
        pending queue after ``backoff`` seconds, resuming its suspended
        driver through the PR 6 re-admission path. Killing a fused guest
        kills its host replica (the pod), suspending every tenant with
        it. Killing a task that is not running is a no-op at fire time."""
        assert self._live, "inject_fault() requires a live session"
        assert name in self._by_name, f"unknown task {name}"
        at = self.now if at is None else max(at, self.now)
        self._fault_backoffs.setdefault(name, []).append(float(backoff))
        self._push_ctrl(at, "podkill", name)

    def _push_ctrl(self, at: float, kind: str, name: str) -> None:
        self._seq += 1
        heapq.heappush(self._ctrl, (at, self._seq, kind, name))

    # ---------------------------------------------------------- session
    def begin(self, initial: Optional[Schedule] = None) -> None:
        """Open the event loop: plan + admit the t<=0 batch, queue future
        arrivals. ``initial`` (batch mode) supplies the static plan whose
        starts become the anomaly-safety bounds."""
        assert not self._live, "session already live"
        names = [s.spec.name for s in self._subs]
        assert len(set(names)) == len(names), "duplicate task names"
        self._by_name = {s.spec.name: s for s in self._subs}
        batch = [s for s in self._subs if s.at <= 0.0]
        future = [s for s in self._subs if s.at > 0.0]

        self._owner: List[Optional[str]] = [None] * self.G
        self._running: Dict[str, _Running] = {}
        self._pending = {s.spec.name for s in batch}
        self._heap: List[Tuple[float, str]] = []
        self._ctrl: List[Tuple[float, int, str, str]] = []
        self._future: Dict[str, float] = {}
        self._events: List[ProgressEvent] = []
        self._results: Dict[str, Any] = {}
        self._task_starts: Dict[str, float] = {}
        self._task_ends: Dict[str, float] = {}
        self._realized: List[Placement] = []
        self._gpu_busy = [0.0] * self.G
        self._replans = self._adopted = self._rejected = 0
        self._cancel_set: set = set()
        self._bounds: Dict[str, float] = {}
        self._plan: Dict[str, Tuple[float, Tuple[int, ...]]] = {}
        self._hosted: Dict[str, str] = {}        # fused task -> host task
        self._planned_fusions: Dict[str, str] = {}   # plan-level task -> host
        self._suspended: Dict[str, _Suspended] = {}  # preempted guests
        self._preempted_n = 0
        self._migrated_n = 0
        self._fault_backoffs: Dict[str, List[float]] = {}
        self._pod_kills = 0
        self.now = 0.0
        self._live = True

        if batch:
            static = initial if initial is not None else solve(
                [s.spec for s in batch], self.G, self.method)
            if self.validate:
                static.validate(self.G)
            assert (set(p.task.name for p in static.placements)
                    == self._pending), \
                "schedule does not cover the submitted task set"
            # static planned starts = the per-task admission bounds (anomaly
            # safety) and the incumbent pending plan
            for p in static.placements:
                self._bounds[p.task.name] = p.start
                self._plan[p.task.name] = (p.start, p.gpu_ids)
        else:
            assert initial is None or not initial.placements

        for name in sorted(self._pending):
            self._events.append(ProgressEvent(
                kind=EventKind.TASK_SUBMITTED, task=name, time=0.0))
        for s in future:
            self._future[s.spec.name] = s.at
            self._by_name[s.spec.name] = dataclasses.replace(
                s, spec=dataclasses.replace(s.spec, release=s.at))
            self._push_ctrl(s.at, "arrive", s.spec.name)

        self._admit(0.0)
        if self._pending and not self._running:
            raise RuntimeError("no task placeable at t=0 "
                               "(schedule/capacity mismatch)")

    def idle(self) -> bool:
        return (self._live and not self._running and not self._ctrl
                and not self._pending)

    def step(self) -> bool:
        """Advance the loop by one event: the earliest of the next control
        event (arrival / cancellation) and the next driver chunk. Returns
        False once the session is idle."""
        assert self._live, "begin() not called"
        next_chunk = self._peek_chunk()
        next_ctrl = self._ctrl[0][0] if self._ctrl else None
        if next_chunk is None and next_ctrl is None:
            if self._pending:
                # defensive: re-solve and admit whatever is admissible
                self._replan(self.now)
                self._admit(self.now)
                if self._pending and not self._running:
                    raise RuntimeError(
                        f"unplaceable pending tasks: {sorted(self._pending)}")
                return True
            return False
        if next_ctrl is not None and (next_chunk is None
                                      or next_ctrl <= next_chunk):
            at, _, kind, name = heapq.heappop(self._ctrl)
            self._process_ctrl(max(at, self.now), kind, name)
        else:
            self._step_chunk()
        return True

    def _peek_chunk(self) -> Optional[float]:
        while self._heap and self._heap[0][1] not in self._running:
            heapq.heappop(self._heap)        # stale (completed / cancelled)
        return self._heap[0][0] if self._heap else None

    # ---------------------------------------------------------- internals
    def _process_ctrl(self, T: float, kind: str, name: str) -> None:
        self.now = max(self.now, T)
        if kind == "arrive":
            if name in self._cancel_set:
                return                       # cancelled before arrival
            self._future.pop(name, None)
            self._pending.add(name)
            spec = self._by_name[name].spec
            self._events.append(ProgressEvent(
                kind=EventKind.TASK_ARRIVED, task=name, time=T,
                detail=f"gpus={spec.gpus} d={spec.duration:.3f}"))
            self._replan(T)
            self._admit(T)
            return
        if kind == "podkill":
            self._pod_kill(T, name)
            return
        # cancel
        if name in self._results or name in self._cancel_set:
            return
        self._cancel_set.add(name)
        self._events.append(ProgressEvent(
            kind=EventKind.TASK_CANCELLED, task=name, time=T))
        run = self._running.pop(name, None)
        if run is not None:
            for g in run.gpu_ids:
                self._owner[g] = None
                self._gpu_busy[g] += T - run.start
            self._task_ends[name] = T
            self._realized.append(Placement(
                dataclasses.replace(run.spec, duration=T - run.start),
                run.start, run.gpu_ids))
            if isinstance(run.driver, ColocatedReplicaDriver):
                # cancelling the replica owner drops every hosted task's
                # slots with it — cancel the unfinished tenants FIRST
                # (their backbone is gone; harvesting them would report
                # truncated runs as completions and poison the profiler
                # feedback), then record the already-finished ones
                for sub in run.driver.hosted_names():
                    if sub in self._task_ends or sub in self._cancel_set:
                        continue
                    if run.driver.end_of(sub) is None:
                        self._cancel_set.add(sub)
                        self._task_ends[sub] = T
                        self._events.append(ProgressEvent(
                            kind=EventKind.TASK_CANCELLED, task=sub, time=T,
                            detail=f"host {name} cancelled"))
                self._harvest_replica(run, T)
        elif name in self._hosted:
            host = self._hosted.pop(name)
            hrun = self._running.get(host)
            if hrun is not None and isinstance(hrun.driver,
                                               ColocatedReplicaDriver):
                hrun.driver.cancel_hosted(name)
                # BUGFIX: the host's projected end must be revalidated the
                # moment a guest departs — the stale pre-departure residual
                # would keep the skyline and the fusion anomaly guard
                # checking admissions against occupancy the replica no
                # longer has
                self._refresh_residual(hrun)
            self._task_ends[name] = T
        else:
            self._pending.discard(name)
            self._future.pop(name, None)
        self._plan.pop(name, None)
        self._bounds.pop(name, None)
        self._planned_fusions.pop(name, None)
        self._suspended.pop(name, None)
        self._replan(T)
        self._admit(T)

    def _pod_kill(self, T: float, name: str) -> None:
        """Execute an injected pod loss (``inject_fault``): suspend the
        running driver at its last chunk boundary, free and bill its
        GPUs, and requeue the task after its backoff. Driver progress is
        never lost — chunks are atomic, so the kill lands exactly at the
        boundary the in-flight work last committed (the wasted wall time
        between boundary and kill is the recomputed-work cost)."""
        backoffs = self._fault_backoffs.get(name, [])
        backoff = backoffs.pop(0) if backoffs else 0.0
        target = self._hosted.get(name, name)    # a guest dies with its pod
        run = self._running.get(target)
        if run is None or target in self._cancel_set:
            return                                # nothing running: no pod
        Tk = max(T, run.local_time)  # task clock may lead global time
        self.now = max(self.now, Tk)
        self._pod_kills += 1
        self._events.append(ProgressEvent(
            kind=EventKind.POD_KILLED, task=target, time=Tk,
            detail=f"backoff={backoff:.3f}"))
        for g in run.gpu_ids:
            self._owner[g] = None
            self._gpu_busy[g] += Tk - run.start
        self._realized.append(Placement(
            dataclasses.replace(run.spec, duration=Tk - run.start),
            run.start, run.gpu_ids))
        del self._running[target]
        # suspend the WHOLE driver (a replica keeps its guests: all
        # tenants resume together when the pod is re-placed)
        est = run.driver.residual_estimate()
        residual = max(0.0, min(est, run.residual))
        self._suspended[target] = _Suspended(driver=run.driver,
                                             residual=residual)
        self._plan.pop(target, None)
        self._bounds.pop(target, None)
        re_at = Tk + backoff
        sub = self._by_name[target]
        self._by_name[target] = dataclasses.replace(
            sub, spec=dataclasses.replace(
                sub.spec, duration=max(residual, _EPS), release=re_at),
            at=re_at)
        self._future[target] = re_at
        self._push_ctrl(re_at, "arrive", target)
        self._replan(Tk)
        self._admit(Tk)

    def _step_chunk(self) -> None:
        _, name = heapq.heappop(self._heap)
        run = self._running.get(name)
        if run is None:
            return
        chunk = run.driver.step_chunk()
        if chunk.dt <= 0 and not chunk.done:
            run.zero_chunks += 1
            if run.zero_chunks > self.max_zero_chunks:
                raise RuntimeError(f"task {name} stopped progressing")
        else:
            run.zero_chunks = 0
        run.local_time += chunk.dt
        T = run.local_time
        self.now = max(self.now, T)
        # residual upper bounds must be non-increasing in projected-end
        # terms: clamp so local_time + residual never grows
        est = run.driver.residual_estimate()
        run.residual = max(0.0, min(est, run.residual - chunk.dt))
        for e in chunk.events:
            self._events.append(e.stamped(T))
            if e.kind is EventKind.TASK_COMPLETED:
                if e.task == name or not e.task:
                    run.saw_completed = True
                elif e.task in self._hosted:
                    # a co-located task finished inside the replica: its
                    # result is final now even though the replica (and its
                    # GPU set) keeps running the other tenants
                    self._record_hosted_end(run, e.task)
        if isinstance(run.driver, ColocatedReplicaDriver):
            # hosted timelines can finish without a TASK_COMPLETED event
            # riding the same chunk (real executors emit it one chunk
            # early); sweep for freshly-finished tenants either way
            for sub in run.driver.hosted_names():
                if run.driver.end_of(sub) is not None:
                    self._record_hosted_end(run, sub)
        shrink = any(e.shrinks() for e in chunk.events)
        if chunk.done:
            del self._running[name]
            self._plan.pop(name, None)      # a long-lived session must not
            self._bounds.pop(name, None)    # accumulate finished tasks
            for g in run.gpu_ids:
                self._owner[g] = None
                self._gpu_busy[g] += T - run.start
            if isinstance(run.driver, ColocatedReplicaDriver):
                self._harvest_replica(run, T)
            else:
                self._task_ends[name] = T
                self._results[name] = run.driver.result()
            self._realized.append(Placement(
                dataclasses.replace(run.spec, duration=T - run.start),
                run.start, run.gpu_ids))
            if not run.saw_completed:
                self._events.append(ProgressEvent(
                    kind=EventKind.TASK_COMPLETED, task=name, time=T))
            self._replan(T)
            self._admit(T)
        else:
            if shrink:
                self._replan(T)
                self._admit(T)
            elif self.migrate and isinstance(run.driver,
                                             ColocatedReplicaDriver):
                # a replica's own chunk boundary is where its local clock
                # catches up to global time — the only moment a migration
                # deferred on clock skew can fire without delaying the guest
                self._rebalance(T)
            heapq.heappush(self._heap, (run.local_time, name))

    def _record_hosted_end(self, run: "_Running", sub: str) -> None:
        if sub in self._task_ends or sub in self._cancel_set:
            return
        w = run.driver
        assert isinstance(w, ColocatedReplicaDriver)
        end = w.end_of(sub)
        if end is None:
            return
        self._task_ends[sub] = run.start + end
        self._results[sub] = w.result_of(sub)

    def _harvest_replica(self, run: "_Running", T: float) -> None:
        """Record completion times/results of every task a finishing (or
        cancelled) replica hosted, the owner included. Per-task ends are
        the tasks' OWN completion points on the replica timeline — the
        replica's GPU occupancy (run.start..T) is what gpu_busy bills."""
        w = run.driver
        assert isinstance(w, ColocatedReplicaDriver)
        for sub in w.sub_names():
            if sub in self._cancel_set or sub in self._task_ends:
                continue
            end = w.end_of(sub)
            self._task_ends[sub] = run.start + end if end is not None else T
            self._results[sub] = w.result_of(sub)

    def _proj_skyline(self, T: float) -> List[float]:
        """Per-GPU projected free time: running tasks keep their GPUs
        until local_time + residual; free GPUs are free at T."""
        sky = [T] * self.G
        for r in self._running.values():
            end = max(r.local_time + r.residual, T)
            for g in r.gpu_ids:
                sky[g] = end
        return sky

    def _refresh_residual(self, run: "_Running") -> None:
        """Recompute a run's projected-end residual from its driver after a
        guest departure (cancel / preemption / migration). Clamped to never
        grow: the projected end stays monotone non-increasing, which the
        elastic <= static argument relies on."""
        run.residual = max(0.0, min(run.driver.residual_estimate(),
                                    run.residual))

    def _plan_resid(self, name: str) -> float:
        # preempted tasks resume mid-flight: residual = what remains;
        # never-started pending tasks have done no work: full duration
        sus = self._suspended.get(name)
        if sus is not None:
            return sus.residual
        return self._by_name[name].spec.duration

    def _guest_driver(self, name: str, T: float) -> TaskDriver:
        """Driver for a task entering execution: a preempted guest resumes
        its suspended driver (progress intact — the bitwise-determinism
        contract), a fresh task constructs and starts one."""
        sus = self._suspended.pop(name, None)
        if sus is not None:
            return sus.driver
        driver = self._by_name[name].factory()
        driver.start(T)
        return driver

    def _resident_requests_of(self, name: str,
                              run: "_Running") -> List[ColoRequest]:
        """Current admission-relevant demand of a run, replica or not."""
        if isinstance(run.driver, ColocatedReplicaDriver):
            return run.driver.resident_requests()
        c = self._by_name[name].colo
        b = run.driver.slots_bound()
        slots = b if b is not None else (c.slots_needed if c else 0)
        return [ColoRequest(name, slots,
                            c.per_adapter_batch if c else 0,
                            c.seq_len if c else None,
                            c.lora_rank if c else None)]

    def _replica_states(self, T: float) -> List[ReplicaState]:
        """Project every running fusable task as a planner ReplicaState:
        projected end from the live residual, slot headroom from resident
        slot bounds, and the remaining SS A.3+k2 memory budget linearized to
        (bytes, k1, k2) so plan_fused's cost() check equals fits_ranked."""
        reps: List[ReplicaState] = []
        for host in sorted(self._running):
            run = self._running[host]
            cap = self._by_name[host].colo
            if cap is None:
                continue
            res = self._resident_requests_of(host, run)
            used_slots = sum(r.slots for r in res)
            if cap.mem is not None:
                m = cap.mem
                seq = m.seq_len
                rank = m.charged_rank(None)
                tok = sum(r.tokens(seq) for r in res)
                rtok = sum(r.rank_tokens(seq, rank) for r in res)
                budget = (m.capacity * m.safety_margin - m.k0
                          - m.k1 * tok - m.k2 * rtok)
                k1, k2 = m.k1, m.k2
            else:
                budget, k1, k2 = float("inf"), 0.0, 0.0
            reps.append(ReplicaState(
                host=host, fuse_key=cap.fuse_key, gpu_ids=run.gpu_ids,
                projected_end=run.local_time + run.residual,
                slot_headroom=max(cap.replica_slots - used_slots, 0),
                mem_budget=budget, k1=k1, k2=k2))
        return reps

    def _fusion_profiles(self, queue: List[str],
                         T: float) -> Dict[str, FusionProfile]:
        """FusionProfile per fusable queued task, mirroring the ColoRequest
        the admission gate will re-check at apply time. Tasks whose
        incumbent start bound has already passed are excluded — fusing
        them now would break the bound promise, exactly the _try_fuse
        guard, evaluated at plan time."""
        out: Dict[str, FusionProfile] = {}
        for n in queue:
            c = self._by_name[n].colo
            if c is None:
                continue
            bound = self._bounds.get(n)
            if bound is not None and T > bound + _EPS:
                continue
            seq = c.seq_len or (c.mem.seq_len if c.mem is not None else 1)
            rank = c.lora_rank or (c.mem.charged_rank(None)
                                   if c.mem is not None else 1)
            tokens = float(c.slots_needed * c.per_adapter_batch * seq)
            out[n] = FusionProfile(fuse_key=c.fuse_key,
                                   slots=c.slots_needed, tokens=tokens,
                                   rank_tokens=tokens * rank)
        return out

    def _queue_spec(self, name: str, T: float) -> TaskSpec:
        spec = self._by_name[name].spec
        release = self._future.get(name, min(spec.release, T))
        return dataclasses.replace(
            spec, duration=max(self._plan_resid(name), _EPS),
            release=release)

    def _fallback_plan(self, queue: List[str], sky: List[float]
                       ) -> Tuple[Dict[str, Tuple[float, Tuple[int, ...]]],
                                  float]:
        """Regret fallback: incumbent placements untouched, unplanned names
        (new arrivals) appended over the incumbent-reserved skyline.
        Returns (plan entries for unplanned names, projected makespan)."""
        free = list(sky)
        mk = max(free, default=0.0)
        known = sorted((n for n in queue if n in self._plan),
                       key=lambda n: (self._plan[n][0], n))
        for n in known:
            start, gpus = self._plan[n]
            s = max(start, max(free[g] for g in gpus))
            end = s + max(self._plan_resid(n), _EPS)
            for g in gpus:
                free[g] = end
            mk = max(mk, end)
        new = [self._queue_spec(n, mk) for n in sorted(queue)
               if n not in self._plan]
        entries: Dict[str, Tuple[float, Tuple[int, ...]]] = {}
        if new:
            tail = lpt_schedule(new, self.G, free)
            for p in tail.placements:
                entries[p.task.name] = (p.start, p.gpu_ids)
            mk = max(mk, tail.makespan)
        return entries, mk

    def _replan(self, T: float) -> None:
        """Re-solve placement of the queue (arrived-pending plus announced
        future arrivals, release-constrained) over the projected skyline,
        then run the adoption rule: strict (never delay past a bound) when
        ``delay_delta`` is None, bounded-delay otherwise."""
        if self.migrate and self._running:
            self._rebalance(T)
        queue = sorted(self._pending) + sorted(self._future)
        if not queue:
            return
        self._replans += 1
        sky = self._proj_skyline(T)
        resid = [self._queue_spec(n, T) for n in queue]
        if self.fusion_planning:
            cand: Schedule = plan_fused(
                resid, self.G, sky, self._replica_states(T),
                self._fusion_profiles(queue, T), now=T,
                method=self.method, bnb_max_n=self.bnb_max_n)
        else:
            cand = solve_residual(resid, self.G, sky, self.method,
                                  self.bnb_max_n)
        if self.validate:
            cand.validate(self.G)
        delays = {p.task.name: p.start - self._bounds[p.task.name]
                  for p in cand.placements if p.task.name in self._bounds}
        max_delay = max(delays.values(), default=0.0)
        if max_delay <= _EPS:
            self._adopt(cand, T, reason="adopted")
            return
        # the fallback replay is only needed to price a delaying plan or to
        # place first-time names; strict batch mode with a fully planned
        # queue skips it entirely
        unplanned = any(n not in self._plan and n not in self._planned_fusions
                        for n in queue)
        if self.delay_delta is None and not unplanned:
            self._rejected += 1
            self._events.append(ProgressEvent(
                kind=EventKind.REPLAN, task="", time=T, reason="rejected",
                detail="would delay past static start"))
            return
        fb_entries, fb_mk = self._fallback_plan(queue, sky)
        win = fb_mk - cand.makespan
        if (self.delay_delta is not None
                and win >= self.delay_delta * max_delay - _EPS):
            self._adopt(cand, T, reason="adopted_bounded_delay",
                        detail=f"win={win:.3f} max_delay={max_delay:.3f}")
            return
        # regret fallback: keep incumbent entries, append new arrivals;
        # incumbent fusion assignments survive only while still applicable
        self._plan.update(fb_entries)
        for n, (start, _) in fb_entries.items():
            self._bounds.setdefault(n, start)
        self._planned_fusions = {
            n: h for n, h in self._planned_fusions.items()
            if n in self._pending and h in self._running}
        self._rejected += 1
        detail = ("would delay past static start" if self.delay_delta is None
                  else f"win={win:.3f} < delta*max_delay="
                       f"{self.delay_delta * max_delay:.3f}")
        self._events.append(ProgressEvent(
            kind=EventKind.REPLAN, task="", time=T, reason="rejected",
            detail=detail))

    def _adopt(self, cand: Schedule, T: float, reason: str,
               detail: str = "") -> None:
        old = Schedule(
            [Placement(self._by_name[n].spec, self._plan[n][0],
                       self._plan[n][1])
             for n in sorted(self._plan)], 0.0, False, 0.0)
        moved = sum(d.moved_earlier for d in diff_schedules(old, cand))
        # fusion-aware candidates assign some tasks to replica slots rather
        # than exclusive GPUs: those get a fusion assignment (applied at the
        # next _admit, re-checked against live capacity) instead of a plan
        # entry. Their bounds stay — fusing never starts past a bound.
        fused = dict(getattr(cand, "fused", {}) or {})
        for n in fused:
            self._plan.pop(n, None)
        self._planned_fusions = fused
        for p in cand.placements:
            name = p.task.name
            self._plan[name] = (p.start, p.gpu_ids)
            # a bound moves later only when the bounded-delay rule paid for
            # it; first-time names (arrivals) get their planned start
            prev = self._bounds.get(name)
            self._bounds[name] = p.start if prev is None else max(prev,
                                                                  p.start)
        self._adopted += 1
        self._events.append(ProgressEvent(
            kind=EventKind.REPLAN, task="", time=T, reason=reason,
            detail=detail or f"moved_earlier={moved}"))

    def _admit(self, T: float) -> None:
        """Start every pending task whose planned GPUs are free, in
        planned-start order; earlier-planned tasks reserve their GPUs
        so later tasks cannot cause priority inversion. With
        ``colocate=True``, tasks still pending afterwards (i.e. waiting
        for GPUs) are offered to live same-fuse-key replicas — the
        fuse-vs-exclusive decision: immediately placeable tasks place
        exclusively, blocked fusable tasks fuse."""
        if self.fusion_planning and self._planned_fusions:
            stale = self._apply_planned_fusions(T)
            if stale:
                # live capacity moved under the plan (host finished, budget
                # taken): drop the stale assignments and re-solve so those
                # names get exclusive placements (or a fresh fusion)
                self._replan(T)
        reserved: set = set()
        placeable = [n for n in self._pending if n in self._plan]
        for name in sorted(placeable, key=lambda n: (self._plan[n][0], n)):
            gpus = self._plan[name][1]
            if any(self._owner[g] is not None for g in gpus) or \
                    (set(gpus) & reserved):
                reserved.update(gpus)
                continue
            sub = self._by_name[name]
            resumed = name in self._suspended
            residual = max(self._plan_resid(name), _EPS)
            driver = self._guest_driver(name, T)
            run = _Running(spec=sub.spec, driver=driver, gpu_ids=gpus,
                           start=T, local_time=T, residual=residual)
            self._running[name] = run
            self._pending.discard(name)
            for g in gpus:
                self._owner[g] = name
            self._task_starts.setdefault(name, T)
            heapq.heappush(self._heap, (run.local_time, name))
            self._events.append(ProgressEvent(
                kind=EventKind.TASK_STARTED, task=name, time=T,
                detail=("resumed " if resumed else "")
                + f"gpus={','.join(map(str, gpus))}"))
        if self.colocate and self._pending and self._running:
            if self._try_fuse(T):
                # fused tasks left the queue: re-solve what remains and
                # admit anything the smaller plan makes placeable (the
                # recursion terminates — fusing strictly shrinks pending)
                self._replan(T)
                self._admit(T)

    def _try_fuse(self, T: float) -> bool:
        """Co-locate pending fusable tasks onto live replicas. A task may
        fuse onto a replica when (a) their fuse keys match (width-free
        since slots went ragged: arch/gpus/loss — mixed batch sizes and
        seq lens fuse), (b) §A.3 cross-task admission accepts it (slot
        headroom + token-linear memory model, greedy decreasing
        token-width across all pending small tasks), and
        (c) soundness: the task's residual fits inside the replica's
        projected end and the replica clock has not passed the task's
        incumbent start bound — so fusing never extends the replica's
        occupancy nor starts anyone later than the plan promised."""
        cands = [n for n in sorted(self._pending)
                 if self._by_name[n].colo is not None]
        fused_any = False
        for host in sorted(self._running):
            if not cands:
                break
            run = self._running[host]
            cap = self._by_name[host].colo
            if cap is None:
                continue
            ok = []
            for n in cands:
                c = self._by_name[n].colo
                if c.fuse_key != cap.fuse_key:
                    continue
                if self._plan_resid(n) > run.residual + _EPS:
                    continue                 # would extend the replica
                bound = self._bounds.get(n)
                if bound is not None and run.local_time > bound + _EPS:
                    continue                 # would start later than promised
                ok.append(n)
            if not ok:
                continue
            if not isinstance(run.driver, ColocatedReplicaDriver):
                run.driver = ColocatedReplicaDriver(
                    host, run.driver, cap,
                    elapsed=run.local_time - run.start)
            w = run.driver
            admitted = admit_cross_task(
                w.resident_requests(),
                [ColoRequest(n, self._by_name[n].colo.slots_needed,
                             self._by_name[n].colo.per_adapter_batch,
                             self._by_name[n].colo.seq_len,
                             self._by_name[n].colo.lora_rank)
                 for n in ok],
                cap.replica_slots, cap.mem)
            for n in admitted:
                self._fuse_attach(n, host, w, T)
                cands.remove(n)
                fused_any = True
        return fused_any

    def _fuse_attach(self, name: str, host: str,
                     w: ColocatedReplicaDriver, T: float) -> None:
        """Attach a pending task as a guest on a live replica. Preempted
        guests re-fuse with their suspended driver (progress intact)."""
        driver = self._guest_driver(name, T)
        w.attach(name, driver, self._by_name[name].colo)
        self._pending.discard(name)
        self._plan.pop(name, None)
        self._bounds.pop(name, None)
        self._planned_fusions.pop(name, None)
        self._hosted[name] = host
        self._task_starts.setdefault(name, T)
        self._events.append(ProgressEvent(
            kind=EventKind.TASK_FUSED, task=name, time=T,
            detail=f"host={host}"))

    def _apply_planned_fusions(self, T: float) -> List[str]:
        """Realize the adopted plan's fusion assignments against LIVE
        capacity. Every soundness guard the opportunistic path enforces is
        re-checked here (the plan was computed against projections that may
        have drifted): fuse-key match, residual fits inside the replica's
        post-refresh projected end, incumbent bound not passed, SS A.3+k2
        cross-task admission. Returns the assignments that no longer hold,
        which the caller drops and re-solves."""
        stale: List[str] = []
        for name in sorted(n for n in self._planned_fusions
                           if n in self._pending):
            host = self._planned_fusions[name]
            run = self._running.get(host)
            c = self._by_name[name].colo
            cap = self._by_name[host].colo if host in self._by_name else None
            if run is None or c is None or cap is None \
                    or c.fuse_key != cap.fuse_key:
                stale.append(name)
                continue
            if self._plan_resid(name) > run.residual + _EPS:
                stale.append(name)
                continue
            bound = self._bounds.get(name)
            if bound is not None and run.local_time > bound + _EPS:
                stale.append(name)
                continue
            if not isinstance(run.driver, ColocatedReplicaDriver):
                run.driver = ColocatedReplicaDriver(
                    host, run.driver, cap,
                    elapsed=run.local_time - run.start)
            w = run.driver
            req = ColoRequest(name, c.slots_needed, c.per_adapter_batch,
                              c.seq_len, c.lora_rank)
            if name not in admit_cross_task(w.resident_requests(), [req],
                                            cap.replica_slots, cap.mem):
                stale.append(name)
                continue
            self._fuse_attach(name, host, w, T)
        for n in stale:
            self._planned_fusions.pop(n, None)
        return stale

    # ------------------------------------------------------- rebalancing
    def _rebalance(self, T: float) -> None:
        """Slot-level preemption/migration: when a host's own queue regrew
        relative to the shrunken replica, a guest whose residual extends
        the replica past the host's OWN projected end is (a) migrated onto
        another same-fuse-key replica that completes it no later, or
        (b) preempted back to the pending queue when an exclusive restart
        completes it no later than staying put. Both moves free the
        replica's GPUs at the host's own end for the waiting queue without
        ever delaying the moved guest past its in-place projection, so the
        fusion-time bound (<= static makespan) survives every move. Runs
        only under queue pressure — with nothing waiting, an extended
        replica harms nobody."""
        if not (self._pending or self._future):
            return
        for host in sorted(self._running):
            run = self._running.get(host)
            if run is None or not isinstance(run.driver,
                                             ColocatedReplicaDriver):
                continue
            w = run.driver
            host_end = run.local_time + w.residual_of(host)
            for guest in sorted(w.hosted_names()):
                if w.end_of(guest) is not None:
                    continue                    # already finished in place
                g_res = w.residual_of(guest)
                stay_end = run.local_time + g_res
                if stay_end <= host_end + _EPS:
                    continue                    # guest doesn't extend replica
                dest = self._find_migration_dest(host, guest, g_res,
                                                 stay_end)
                if dest is not None:
                    self._migrate_guest(guest, host, dest, T)
                    continue
                if self._find_migration_dest(host, guest, g_res, stay_end,
                                             ignore_skew=True) is not None:
                    # a destination is viable except that its local clock
                    # runs ahead of the host's (chunk skew) — the no-delay
                    # guard will pass at the host's next chunk boundary, so
                    # hold the guest rather than preempt (preemption only
                    # reorders work on the same GPUs; migration removes it)
                    continue
                self._maybe_preempt(guest, host, run, g_res, stay_end, T)

    def _find_migration_dest(self, host: str, guest: str, g_res: float,
                             stay_end: float, *,
                             ignore_skew: bool = False) -> Optional[str]:
        """A live replica that can absorb the guest without extending its
        own occupancy, without delaying the guest past its in-place
        projection, and without the guest overhanging the destination
        owner's own end (else the move would just re-trigger there).
        ``ignore_skew`` drops the no-delay guard, answering "would a
        destination accept the guest once the clocks align?"."""
        c = self._by_name[guest].colo
        if c is None:
            return None
        for dest in sorted(self._running):
            if dest == host:
                continue
            drun = self._running[dest]
            cap = self._by_name[dest].colo
            if cap is None or cap.fuse_key != c.fuse_key:
                continue
            if g_res > drun.residual + _EPS:
                continue                 # would extend the destination
            if not ignore_skew and drun.local_time + g_res > stay_end + _EPS:
                continue                 # would delay the guest
            if isinstance(drun.driver, ColocatedReplicaDriver):
                if g_res > drun.driver.residual_of(dest) + _EPS:
                    continue             # would overhang the dest owner
                res = drun.driver.resident_requests()
            else:
                res = self._resident_requests_of(dest, drun)
            req = ColoRequest(guest, c.slots_needed, c.per_adapter_batch,
                              c.seq_len, c.lora_rank)
            if guest in admit_cross_task(res, [req], cap.replica_slots,
                                         cap.mem):
                return dest
        return None

    def _migrate_guest(self, guest: str, host: str, dest: str,
                       T: float) -> None:
        run = self._running[host]
        assert isinstance(run.driver, ColocatedReplicaDriver)
        driver = run.driver.detach(guest)
        self._refresh_residual(run)          # post-departure projected end
        drun = self._running[dest]
        cap = self._by_name[dest].colo
        if not isinstance(drun.driver, ColocatedReplicaDriver):
            drun.driver = ColocatedReplicaDriver(
                dest, drun.driver, cap,
                elapsed=drun.local_time - drun.start)
        drun.driver.attach(guest, driver, self._by_name[guest].colo)
        self._hosted[guest] = dest
        self._migrated_n += 1
        self._events.append(ProgressEvent(
            kind=EventKind.TASK_MIGRATED, task=guest, time=T,
            detail=f"{host}->{dest}"))

    def _maybe_preempt(self, guest: str, host: str, run: "_Running",
                       g_res: float, stay_end: float, T: float) -> None:
        """Evict the guest back to the queue only when an exclusive restart
        completes it no later than staying put (typically: GPUs freed since
        it fused). The evicted guest leaves with an incumbent plan entry at
        its projected restart, so subsequent replans can only move it
        earlier (strict mode) or must pay for any delay (bounded mode)."""
        w = run.driver
        assert isinstance(w, ColocatedReplicaDriver)
        sky = self._proj_skyline(T)
        # source GPUs free when the replica's REMAINING residents end
        others = [w.residual_of(x) for x in w.sub_names()
                  if x != guest and w.end_of(x) is None]
        rem_end = run.local_time + max(others, default=0.0)
        for g in run.gpu_ids:
            sky[g] = max(rem_end, T)
        gpus = self._by_name[guest].spec.gpus
        if gpus > len(sky):
            return
        order = sorted(range(self.G), key=lambda g: (sky[g], g))
        ids = tuple(sorted(order[:gpus]))
        start = max(max(sky[g] for g in ids), T)
        if start + g_res > stay_end + _EPS:
            return                           # restart would delay the guest
        driver = w.detach(guest)
        self._refresh_residual(run)
        self._hosted.pop(guest, None)
        self._suspended[guest] = _Suspended(driver=driver, residual=g_res)
        self._pending.add(guest)
        self._plan[guest] = (start, ids)
        self._bounds[guest] = start
        self._preempted_n += 1
        self._events.append(ProgressEvent(
            kind=EventKind.TASK_PREEMPTED, task=guest, time=T,
            detail=f"host={host} residual={g_res:.3f}"))

    # ---------------------------------------------------------- observability
    def annotate(self, event: ProgressEvent) -> None:
        """Append an out-of-band audit event (stamped at the current
        virtual time) to the log — e.g. the service's tune-to-serve hook
        recording an ``ADAPTER_PUBLISHED`` alongside the capacity trail."""
        self._events.append(event.stamped(self.now))

    @property
    def event_log(self) -> List[ProgressEvent]:
        return self._events

    @property
    def results_map(self) -> Dict[str, Any]:
        return self._results

    @property
    def task_start_times(self) -> Dict[str, float]:
        return self._task_starts

    @property
    def task_end_times(self) -> Dict[str, float]:
        return self._task_ends

    def is_cancelled(self, name: str) -> bool:
        return name in self._cancel_set

    # ---------------------------------------------------------- reporting
    def report(self) -> RuntimeReport:
        """Snapshot the session at idle (all admitted work drained)."""
        assert self._live, "begin() not called"
        assert not self._pending, f"unstarted tasks: {sorted(self._pending)}"
        makespan = max(self._task_ends.values(), default=0.0)
        schedule = Schedule(list(self._realized), makespan, optimal=False,
                            solve_time_s=0.0)
        if self.validate:
            schedule.validate(self.G)
        util = (sum(self._gpu_busy) / (self.G * makespan)
                if makespan > 0 else 0.0)
        return RuntimeReport(
            makespan=makespan, realized=schedule, events=list(self._events),
            replans=self._replans, plans_adopted=self._adopted,
            plans_rejected=self._rejected, gpu_busy=list(self._gpu_busy),
            utilization=util, results=dict(self._results),
            task_starts=dict(self._task_starts),
            task_ends=dict(self._task_ends),
            cancelled=tuple(sorted(self._cancel_set)),
            colocated=dict(self._hosted),
            preemptions=self._preempted_n,
            migrations=self._migrated_n,
            pod_kills=self._pod_kills)

    # ------------------------------------------------------------------ run
    def run(self, initial: Optional[Schedule] = None) -> RuntimeReport:
        """One-shot batch semantics: open the session, drain it, report."""
        self.begin(initial)
        while self.step():
            pass
        return self.report()


# --------------------------------------------------------------------------
# Static baseline: the same drivers, starts pinned to the precomputed plan
# --------------------------------------------------------------------------

@dataclasses.dataclass
class StaticReport:
    makespan: float
    realized: Schedule
    gpu_busy: List[float]
    utilization: float
    results: Dict[str, Any]
    task_starts: Dict[str, float]
    task_ends: Dict[str, float]

    def per_gpu_utilization(self) -> List[float]:
        mk = max(self.makespan, _EPS)
        return [b / mk for b in self.gpu_busy]


def execute_static(schedule: Schedule, G: int,
                   factories: Dict[str, Callable[[], TaskDriver]],
                   validate: bool = True) -> StaticReport:
    """Execute a Schedule literally: every task starts at its planned start
    (GPUs idle in between), actual durations come from draining the same
    drivers the elastic runtime would step. This is the A/B baseline the
    benchmarks compare against."""
    if validate:
        schedule.validate(G)
    realized: List[Placement] = []
    gpu_busy = [0.0] * G
    results: Dict[str, Any] = {}
    starts: Dict[str, float] = {}
    ends: Dict[str, float] = {}
    for p in schedule.placements:
        name = p.task.name
        driver = factories[name]()
        driver.start(p.start)
        dur = 0.0
        while True:
            chunk = driver.step_chunk()
            dur += chunk.dt
            if chunk.done:
                break
        results[name] = driver.result()
        starts[name] = p.start
        ends[name] = p.start + dur
        for g in p.gpu_ids:
            gpu_busy[g] += dur
        realized.append(Placement(
            dataclasses.replace(p.task, duration=dur), p.start, p.gpu_ids))
    makespan = max(ends.values(), default=0.0)
    sched = Schedule(realized, makespan, optimal=False, solve_time_s=0.0)
    if validate:
        sched.validate(G)
    util = (sum(gpu_busy) / (G * makespan)) if makespan > 0 else 0.0
    return StaticReport(makespan=makespan, realized=sched, gpu_busy=gpu_busy,
                        utilization=util, results=results,
                        task_starts=starts, task_ends=ends)


# --------------------------------------------------------------------------
# Simulated driver: the executor lifecycle in virtual time (no training)
# --------------------------------------------------------------------------

class SimulatedTaskDriver(TaskDriver):
    """Replays the BatchedExecutor lifecycle — warmup waves with rotation,
    Pattern-3 selection at the warmup boundary, continue-training with
    early exits and slot backfill — in virtual time. ``exit_step[j]`` makes
    job j exit (divergence/overfit stand-in) once it has trained that many
    steps; jobs without an entry train to ``total_steps``. Deterministic
    for fixed arguments, as the static baseline requires."""

    def __init__(self, name: str, *, K: int, Z: int, total_steps: int,
                 warmup_steps: int, step_time_s: float,
                 select_ratio: float = 0.25,
                 exit_step: Optional[Dict[int, int]] = None,
                 chunk_steps: int = 5):
        assert K >= 1 and Z >= 1 and total_steps >= 1
        self.name = name
        self.K = K
        self.Z = Z
        self.total_steps = total_steps
        self.warmup_steps = max(min(warmup_steps, total_steps), 1)
        self.step_time_s = step_time_s
        self.select_ratio = select_ratio
        self.exit_step = dict(exit_step or {})
        self.chunk_steps = max(chunk_steps, 1)
        # single source of truth for the Pattern-3 rounding rule: the same
        # EarlyExitConfig.top_k the real executor's warmup_select uses
        self.top_k = EarlyExitConfig(select_ratio=select_ratio).top_k(K)
        # lifecycle state
        self._trained = [0] * K
        self._exited: Dict[int, str] = {}
        self._waves = [list(range(i, min(i + Z, K)))
                       for i in range(0, K, Z)]
        self._wave_idx = 0
        self._wave_left = self.warmup_steps
        self._phase = "warmup"
        self._active: List[int] = []
        self._queue: List[int] = []
        self._done = False

    # -- helpers -----------------------------------------------------------
    def _alive(self, jobs: Sequence[int]) -> List[int]:
        return [j for j in jobs if j not in self._exited]

    def start(self, now: float) -> None:
        pass

    def _job_events(self, jobs: Sequence[int]) -> List[ProgressEvent]:
        out = []
        for j in jobs:
            tgt = self.exit_step.get(j)
            if tgt is not None and self._trained[j] >= tgt \
                    and j not in self._exited:
                self._exited[j] = "diverging"
                out.append(ProgressEvent(
                    kind=EventKind.JOB_EXITED, task=self.name,
                    job=f"{self.name}/j{j}", reason="diverging",
                    step=self._trained[j]))
            elif self._trained[j] >= self.total_steps \
                    and j not in self._exited:
                self._exited[j] = "completed"
                out.append(ProgressEvent(
                    kind=EventKind.JOB_EXITED, task=self.name,
                    job=f"{self.name}/j{j}", reason="completed",
                    step=self._trained[j]))
        return out

    def step_chunk(self) -> DriverChunk:
        assert not self._done
        ev: List[ProgressEvent] = []
        if self._phase == "warmup":
            wave = self._alive(self._waves[self._wave_idx])
            n = min(self.chunk_steps, self._wave_left)
            self._wave_left -= n
            for j in wave:
                self._trained[j] += n
            ev += self._job_events(wave)
            if self._wave_left == 0:
                self._wave_idx += 1
                self._wave_left = self.warmup_steps
                if self._wave_idx >= len(self._waves):
                    ev += self._select()
            return DriverChunk(dt=n * self.step_time_s, events=tuple(ev))
        # continue phase
        self._active = self._alive(self._active)
        while len(self._active) < self.Z and self._queue:
            self._active.append(self._queue.pop(0))
        if not self._active:
            self._done = True
            ev.append(ProgressEvent(
                kind=EventKind.TASK_COMPLETED, task=self.name))
            return DriverChunk(dt=0.0, events=tuple(ev), done=True)
        # clamp the chunk to the next per-job event boundary (budget or
        # early exit) so no job overshoots total_steps — the real executor
        # evicts at the exact step, and the worst-case duration estimate
        # must stay an upper bound on the realized duration
        n = self.chunk_steps
        for j in self._active:
            nxt = min(self.exit_step.get(j, self.total_steps),
                      self.total_steps)
            n = min(n, max(nxt - self._trained[j], 1))
        for j in self._active:
            self._trained[j] += n
        ev += self._job_events(self._active)
        self._active = self._alive(self._active)
        return DriverChunk(dt=n * self.step_time_s, events=tuple(ev))

    def _select(self) -> List[ProgressEvent]:
        self._phase = "continue"
        alive = self._alive(range(self.K))
        kept, dropped = alive[:self.top_k], alive[self.top_k:]
        for j in dropped:
            self._exited[j] = "underperforming"
        self._active = kept[:self.Z]
        self._queue = kept[self.Z:]
        if dropped:
            return [ProgressEvent(
                kind=EventKind.WARMUP_SELECTION, task=self.name,
                reason="underperforming", step=self.warmup_steps,
                dropped=tuple(f"{self.name}/j{j}" for j in dropped))]
        return []

    def residual_estimate(self) -> float:
        if self._done:
            return 0.0
        cont_budget = self.total_steps - self.warmup_steps
        if self._phase == "warmup":
            waves_left = len(self._waves) - self._wave_idx - 1
            surv = min(self.top_k, self.K - sum(
                1 for r in self._exited.values() if r != "completed"))
            surv = max(surv, 0)
            cont = -(-surv // self.Z) * cont_budget if surv else 0
            steps = self._wave_left + waves_left * self.warmup_steps + cont
        else:
            alive = self._alive(self._active) + self._alive(self._queue)
            if not alive:
                steps = 0
            else:
                rem = max(self.total_steps - self._trained[j] for j in alive)
                steps = -(-len(alive) // self.Z) * max(rem, 0)
        return steps * self.step_time_s

    def slots_bound(self) -> Optional[int]:
        """Upper bound on future concurrent slot use — shrinks as waves
        drain and jobs exit, which is the capacity cross-task co-location
        reclaims."""
        if self._done:
            return 0
        cont = min(self.Z, self.top_k)
        if self._phase == "warmup":
            alive_waves = [len(self._alive(w))
                           for w in self._waves[self._wave_idx:]]
            return max(alive_waves + [cont])
        return min(self.Z,
                   len(self._alive(self._active) + self._alive(self._queue)))

    def result(self) -> Dict[str, Any]:
        return {"task": self.name,
                "steps_trained": int(sum(self._trained)),
                "exit_reasons": {f"{self.name}/j{j}": r
                                 for j, r in sorted(self._exited.items())}}


def sim_task_spec(name: str, *, K: int, Z: int, total_steps: int,
                  warmup_steps: int, step_time_s: float, gpus: int,
                  select_ratio: float = 0.25) -> TaskSpec:
    """Worst-case (no pattern exits) duration estimate for a simulated
    task — identical to what the profiler computes for real tasks."""
    from repro_torch.sched import profiler
    warmup = max(min(warmup_steps, total_steps), 1)
    top_k = EarlyExitConfig(select_ratio=select_ratio).top_k(K)
    steps = profiler.lifecycle_steps(K, Z, warmup, total_steps,
                                     survivors=top_k)
    return TaskSpec(name=name, duration=steps * step_time_s, gpus=gpus)


def sim_colo_spec(fuse_key: Tuple, *, K: int, Z: int,
                  per_adapter_batch: int = 4,
                  replica_slots: Optional[int] = None,
                  mem: Optional[MemoryModel] = None,
                  seq_len: Optional[int] = None,
                  lora_rank: Optional[int] = None) -> ColocationSpec:
    """ColocationSpec for a simulated task: it needs at most min(Z, K)
    concurrent slots, and a replica it hosts exposes ``replica_slots``
    physical slots (defaults to its own Z). ``fuse_key`` is the caller's
    choice — ragged admission only needs (arch, gpus, loss)-level keys;
    width enters through per_adapter_batch/seq_len token accounting and
    ``lora_rank`` (the task's true adapter rank) through the rank-aware
    FLOP-token budget; ``lora_rank=None`` is charged at r_max."""
    return ColocationSpec(
        fuse_key=fuse_key, per_adapter_batch=per_adapter_batch,
        slots_needed=min(Z, K),
        replica_slots=replica_slots if replica_slots is not None else Z,
        mem=mem, seq_len=seq_len, lora_rank=lora_rank)


# --------------------------------------------------------------------------
# Real-executor driver (engine integration)
# --------------------------------------------------------------------------

class ExecutorTaskDriver(TaskDriver):
    """Wraps BatchedExecutor.run_task_chunks: chunk steps convert to
    virtual seconds via the profiled step time, and each ChunkReport's
    remaining_steps_bound provides the residual estimate.

    Training is drained eagerly at ``start()`` and the chunk/event timeline
    replayed to the runtime. Tasks don't interact and cluster time is
    virtual, so the replay is observationally identical to live stepping —
    but only ONE executor (slot params, optimizer state, snapshots) is
    resident at a time instead of one per concurrently-scheduled task."""

    def __init__(self, name: str, executor, jobs, total_steps: int,
                 step_time_s: float, resume_state=None, start_chunk: int = 0):
        self.name = name
        self.executor = executor
        self.jobs = jobs
        self.total_steps = total_steps
        self.step_time_s = step_time_s
        # durable-recovery path: a (tree, meta) lifecycle checkpoint from
        # checkpoint/taskstate.py — start() then continues the task from
        # its exact saved step instead of from zero
        self.resume_state = resume_state
        self.start_chunk = start_chunk
        self._chunks: List[DriverChunk] = []
        self._bounds: List[int] = []
        self._slot_bounds: List[int] = []
        self._result = None
        self._last_bound: Optional[int] = None
        self._last_slots: Optional[int] = None
        self._wall_s = 0.0
        self._steps = 0
        self._tokens = 0

    def start(self, now: float) -> None:
        if self.resume_state is not None:
            gen = self.executor.resume_task_chunks(
                self.name, self.jobs, self.total_steps, self.resume_state,
                start_chunk=self.start_chunk)
        else:
            gen = self.executor.run_task_chunks(
                self.name, self.jobs, self.total_steps)
        while True:
            try:
                report = next(gen)
            except StopIteration as fin:
                self._result = fin.value
                break
            self._chunks.append(DriverChunk(
                dt=report.steps_executed * self.step_time_s,
                events=report.events, done=False))
            self._bounds.append(report.remaining_steps_bound)
            self._slot_bounds.append(report.slots_bound)
            self._wall_s += report.wall_time_s
            self._steps += report.steps_executed
            self._tokens += report.tokens_executed
        assert self._chunks, "executor produced no chunks"
        # completion events ride the final chunk so the runtime replans
        # exactly once, with the GPUs actually freed
        self._chunks[-1] = dataclasses.replace(self._chunks[-1], done=True)
        self.executor = None            # release slot/opt state eagerly

    def step_chunk(self) -> DriverChunk:
        assert self._chunks is not None and self._chunks, "start() not called"
        chunk = self._chunks.pop(0)
        self._last_bound = self._bounds.pop(0)
        self._last_slots = self._slot_bounds.pop(0)
        return chunk

    def residual_estimate(self) -> float:
        if self._last_bound is None:        # not stepped yet: no information
            return float("inf")             # runtime clamps to spec duration
        return self._last_bound * self.step_time_s

    def slots_bound(self) -> Optional[int]:
        return self._last_slots

    def observed_wall_step_s(self) -> Optional[float]:
        """Realized host seconds per executor step (profiler feedback)."""
        return self._wall_s / self._steps if self._steps else None

    def observed_wall_token_s(self) -> Optional[float]:
        """Realized host seconds per REAL token (padding excluded). With
        ragged slot widths this is the calibrated feedback quantity — two
        chunks with equal step counts can differ 4x in token throughput,
        so per-step wall time alone would mis-estimate heterogeneous
        mixes."""
        return self._wall_s / self._tokens if self._tokens else None

    def result(self):
        return self._result
