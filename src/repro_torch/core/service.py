"""ALTO as a long-lived tuning service (paper §4: LoRA-tuning-as-a-service).

A copy of ``repro.core.service`` (host-side Python) over the port's engine,
scheduler, journal, checkpoints and serving tier: the port imports nothing
of the JAX package. One addition: ``TuningService(device=...)`` is handed
to the ``Engine`` it builds, so a service runs its tasks on the card unless
the caller passes ``device="cpu"``.

The batch ``Engine`` API hands over a closed task list and waits for one
terminal report. ``TuningService`` is the multi-tenant redesign: tenants
``submit(task, at=...)`` at any virtual time — including while the cluster
is mid-execution — and get back a ``TaskHandle`` with ``status()``,
``result()``, ``cancel()``, and a per-task event ``stream()``. The service
owns an ``ElasticClusterRuntime`` session (``sched/cluster.py``) that
admits arrivals into the running event loop, re-solves residual placement
around them (release-constrained), and applies the bounded-delay plan
adoption rule.

    svc = TuningService(total_gpus=8)
    h = svc.submit(task_a)                       # t = 0
    h2 = svc.submit(task_b, at=120.0)            # arrives mid-session
    h2.cancel(at=300.0)                          # tenant withdraws
    best = h.result()                            # drives the loop to done
    report = svc.run_until_idle()

The service also closes the profiler feedback loop: every
completed task records its realized duration, virtual step time, and wall
step time into a ``ProfileStore`` shared with the engine's profiler, so
later admissions in the same session are scheduled from observed rather
than analytic estimates.

Time is *virtual cluster time* (the same timeline the elastic runtime and
benchmarks use): ``submit``/``cancel`` enqueue events, and the loop only
advances when driven via ``run_until_idle()``, ``handle.result()``, or
``handle.stream()``. On one card, training executes
sequentially either way, so the virtual timeline is observationally
identical to live stepping — which is what makes the service testable.
"""
from __future__ import annotations

import dataclasses
import enum
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.core.early_exit import EarlyExitConfig
from repro_torch.sched import profiler
from repro_torch.sched.cluster import (ColocationSpec,
                                       ElasticClusterRuntime, RuntimeReport,
                                       TaskDriver)
from repro_torch.sched.events import (EventKind, ProgressEvent,
                                      event_to_json)
from repro_torch.sched.inter_task import Schedule, TaskSpec

_log = logging.getLogger(__name__)


def _task_record(task, early_exit: EarlyExitConfig) -> Optional[Dict]:
    """JSON-able description of an ``engine.Task`` for the journal, or
    ``None`` when the task is not serializable (in-memory ModelConfig /
    TaskDataset objects) — recovery then needs the task re-supplied via
    ``recover(tasks=...)``."""
    if not isinstance(task.model, str) or not isinstance(task.dataset, str):
        return None
    rec = {"model": task.model, "dataset": task.dataset,
           "search_space": task.search_space, "num_gpus": task.num_gpus,
           "max_steps": task.max_steps, "num_slots": task.num_slots,
           "seed": task.seed, "name": task.name,
           "loss_kind": task.loss_kind,
           "device_memory": task.device_memory,
           "early_exit": dataclasses.asdict(early_exit)}
    try:
        json.dumps(rec)
    except (TypeError, ValueError):
        return None
    return rec


def _task_from_record(rec: Dict) -> Tuple[Any, EarlyExitConfig]:
    from repro_torch.core.engine import Task
    task = Task(model=rec["model"], dataset=rec["dataset"],
                search_space={k: list(v)
                              for k, v in rec["search_space"].items()},
                num_gpus=int(rec["num_gpus"]),
                max_steps=int(rec["max_steps"]),
                num_slots=int(rec["num_slots"]), seed=int(rec["seed"]),
                name=rec["name"], loss_kind=rec["loss_kind"],
                device_memory=int(rec["device_memory"]))
    return task, EarlyExitConfig(**rec["early_exit"])


class ServiceLoop:
    """Handle for the wall-clock background pump (``run_forever``)."""

    def __init__(self, thread: threading.Thread, stop: threading.Event):
        self._thread = thread
        self._stop = stop

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def stop(self, timeout: Optional[float] = 10.0) -> None:
        self._stop.set()
        self._thread.join(timeout)


class TaskState(enum.Enum):
    PENDING = "pending"        # submitted, not yet started (or not arrived)
    RUNNING = "running"
    COMPLETED = "completed"
    CANCELLED = "cancelled"

    @property
    def terminal(self) -> bool:
        return self in (TaskState.COMPLETED, TaskState.CANCELLED)


class TaskCancelled(Exception):
    """Raised by ``TaskHandle.result()`` when the task was cancelled."""


class QuotaExceeded(Exception):
    """Raised by ``TuningService.submit`` when a tenant's concurrent
    (non-terminal) task count would exceed ``max_tasks_per_tenant``."""


@dataclasses.dataclass(frozen=True)
class TaskStatus:
    name: str
    state: TaskState
    submitted_at: float
    started_at: Optional[float]
    finished_at: Optional[float]
    now: float                 # virtual cluster time of this snapshot


@dataclasses.dataclass
class _TaskMeta:
    spec: TaskSpec               # as admitted (feedback scale applied)
    unscaled_duration: float     # worst-case estimate feedback records vs
    submitted_at: float
    profile_key: Optional[Tuple]
    driver: Optional[TaskDriver] = None
    tenant: str = "default"
    colo: Optional[ColocationSpec] = None   # fuse key for serve metadata


class TaskHandle:
    """Tenant-side view of one submitted task."""

    def __init__(self, service: "TuningService", name: str):
        self._svc = service
        self.name = name

    def status(self) -> TaskStatus:
        return self._svc.status(self.name)

    def events(self) -> List[ProgressEvent]:
        """Events recorded so far for this task (does not drive the loop)."""
        return [e for e in self._svc._runtime_events()
                if e.task == self.name]

    def stream(self) -> Iterator[ProgressEvent]:
        """Yield this task's events as they fire, driving the service loop
        until the task reaches a terminal state."""
        seen = 0
        while True:
            evs = self._svc._runtime_events()
            for e in evs[seen:]:
                if e.task == self.name:
                    yield e
            seen = len(evs)
            if self.status().state.terminal or not self._svc._step():
                break
        for e in self._svc._runtime_events()[seen:]:
            if e.task == self.name:
                yield e

    def result(self) -> Any:
        """Drive the service until this task is terminal; return its result
        (a ``TaskResult`` for engine tasks, the driver result otherwise).
        Raises ``TaskCancelled`` if the task was cancelled."""
        self._svc._drive(lambda: self.status().state.terminal)
        st = self.status().state
        if st is TaskState.CANCELLED:
            raise TaskCancelled(self.name)
        return self._svc._results()[self.name]

    def cancel(self, at: Optional[float] = None) -> bool:
        return self._svc.cancel(self.name, at=at)


@dataclasses.dataclass
class ServiceReport:
    """Terminal report of one service session (superset of the runtime's)."""
    task_results: Dict[str, Any]
    makespan: float
    utilization: float
    replans: int
    plans_adopted: int
    plans_rejected: int
    events: List[ProgressEvent]
    cancelled: Tuple[str, ...]
    task_starts: Dict[str, float]
    task_ends: Dict[str, float]
    runtime: RuntimeReport
    colocated: Dict[str, str] = dataclasses.field(default_factory=dict)
    preemptions: int = 0
    migrations: int = 0


class TuningService:
    """Long-lived multi-tenant LoRA tuning service (see module docstring).

    ``delay_delta`` tunes plan adoption: ``None`` keeps the strict
    anomaly-safe rule (never start a task later than its incumbent bound —
    what batch mode uses for the elastic<=static guarantee); a float δ
    enables the bounded-delay rule (accept a delaying plan only when the
    projected makespan win is at least δ·max_delay, regret fallback
    otherwise), which is the right trade once arrivals make strictness
    systematically conservative.

    ``fusion_planning`` (default on) makes co-location a plan decision:
    every replan solves with fusion-aware placement (replica slots with
    token/rank budgets) instead of relying solely on opportunistic fusion
    at admission; ``migrate`` (default on) additionally lets the runtime
    evict or migrate a live guest whose replica regrew under it, moves
    that never delay the guest past its in-place projection.

    ``fitted=True`` swaps admission budgeting (the engine's memory model,
    hence ``admit_cross_task``/backfill/``plan_fused``) onto the
    profile-fitted (k0, k1, k2) cost models in ``sched/fitted.py`` once
    enough fused-step observations accumulate for a profile key —
    ``_feedback`` records one raw ``StepObservation`` per completed task
    either way, so a session budgets analytically until measurement can
    take over.

    ``device`` goes to the ``Engine`` the service builds (the card unless
    ``"cpu"`` is asked for; without a card the default raises). With an
    explicit ``engine`` it must name the engine's own device.
    """

    def __init__(self, total_gpus: Optional[int] = None,
                 strategy: Optional[str] = None,
                 eval_every: Optional[int] = None,
                 method: str = "cp", delay_delta: Optional[float] = 2.0,
                 profile_store: Optional[profiler.ProfileStore] = None,
                 engine=None, colocate: bool = True,
                 fusion_planning: bool = True, migrate: bool = True,
                 profile_path: Optional[str] = None,
                 max_tasks_per_tenant: Optional[int] = None,
                 serve_dir: Optional[str] = None,
                 fitted: Optional[bool] = None,
                 state_dir: Optional[str] = None,
                 ckpt_every: int = 1, device=None):
        if profile_store is None and profile_path is not None:
            # persistence across sessions: feedback observed by earlier
            # service processes seeds this one
            profile_store = profiler.ProfileStore.load_or_new(profile_path)
        if engine is None:
            from repro_torch.core.engine import Engine
            engine = Engine(strategy=strategy or "adapter_parallel",
                            total_gpus=total_gpus or 8,
                            eval_every=eval_every or 5,
                            profile_store=profile_store,
                            fitted=bool(fitted), device=device)
        else:
            # an explicit engine carries its own configuration; reject
            # conflicting explicit args instead of silently ignoring them
            if total_gpus is not None and total_gpus != engine.total_gpus:
                raise ValueError(f"total_gpus={total_gpus} conflicts with "
                                 f"engine.total_gpus={engine.total_gpus}")
            if strategy is not None and strategy != engine.strategy:
                raise ValueError("strategy conflicts with engine.strategy")
            if eval_every is not None and eval_every != engine.eval_every:
                raise ValueError("eval_every conflicts with "
                                 "engine.eval_every")
            if fitted is not None and bool(fitted) != engine.fitted:
                raise ValueError("fitted conflicts with engine.fitted")
            if device is not None and (torch.device(device)
                                       != engine.device):
                raise ValueError(f"device={device} conflicts with "
                                 f"engine.device={engine.device}")
        self.engine = engine
        self.profile_store = engine.profile_store
        self.total_gpus = engine.total_gpus
        self.profile_path = profile_path
        self._runtime = ElasticClusterRuntime(
            engine.total_gpus, method=method, delay_delta=delay_delta,
            colocate=colocate, fusion_planning=colocate and fusion_planning,
            migrate=colocate and migrate)
        self.max_tasks_per_tenant = max_tasks_per_tenant
        # tune-to-serve: completed tasks' winning adapters are checkpointed
        # under serve_dir and auto-published to an attached serving frontend
        self.serve_dir = serve_dir
        self.serving: Optional[Any] = None
        self._ckpt_paths: Dict[str, str] = {}
        self._meta: Dict[str, _TaskMeta] = {}
        self._handles: Dict[str, TaskHandle] = {}
        self._recorded: set = set()
        self._fb_seen = 0
        self._pre_cancels: List[Tuple[str, Optional[float]]] = []
        # durability (crash recovery): a write-ahead event journal plus an
        # in-flight SlotSnapshot checkpointer installed on every engine
        # executor the service creates. Both live under state_dir.
        self.state_dir = state_dir
        self.ckpt_every = int(ckpt_every)
        self._journal = None
        self._ckpt = None
        if state_dir is not None:
            from repro_torch.checkpoint.taskstate import TaskCheckpointer
            from repro_torch.sched.journal import EventJournal
            self._journal = EventJournal(state_dir)
            self._ckpt = TaskCheckpointer(state_dir, journal=self._journal,
                                          every=self.ckpt_every)
            self._journal.append({
                "rec": "session", "total_gpus": engine.total_gpus,
                "strategy": engine.strategy,
                "eval_every": engine.eval_every,
                "ckpt_every": self.ckpt_every, "serve_dir": serve_dir})
        self._jrn_seen = 0
        # wall-clock driving: submit/cancel/step are serialized under this
        # lock so tenants can call into the service while run_forever pumps
        self._lock = threading.RLock()
        self._loop: Optional[ServiceLoop] = None
        # TASK_RECOVERED / republish audit events buffered until the
        # runtime session is live (annotate() needs a running event loop)
        self._pending_annotations: List[ProgressEvent] = []

    # ------------------------------------------------------------ admission
    def active_tasks_of(self, tenant: str) -> int:
        """Number of this tenant's non-terminal (pending/running) tasks."""
        return sum(1 for name, meta in self._meta.items()
                   if meta.tenant == tenant
                   and not self.status(name).state.terminal)

    def _check_quota(self, tenant: str) -> None:
        quota = self.max_tasks_per_tenant
        if quota is None:
            return
        active = self.active_tasks_of(tenant)
        if active >= quota:
            raise QuotaExceeded(
                f"tenant {tenant!r} has {active} active tasks "
                f"(max_tasks_per_tenant={quota})")

    def submit(self, task, at: float = 0.0,
               early_exit: EarlyExitConfig = EarlyExitConfig(),
               spec: Optional[TaskSpec] = None,
               tenant: str = "default") -> TaskHandle:
        """Submit an ``engine.Task`` at virtual time ``at``. Profiling
        consults the session's ``ProfileStore``, so durations reflect any
        feedback already observed. ``spec`` overrides the profiled spec
        with a worst-case estimate that is used verbatim (the engine's
        batch wrapper relies on it staying a true residual upper bound for
        the elastic<=static guarantee); profiled submissions apply the
        feedback scale exactly once, in ``submit_spec``. ``tenant``
        attributes the task for the per-tenant concurrency quota
        (``max_tasks_per_tenant``): a submission that would push the
        tenant past its quota raises ``QuotaExceeded`` before anything is
        admitted."""
        explicit = spec is not None
        if spec is None:
            spec = self.engine.profile_raw(task, early_exit)
        factory = self.engine.executor_driver_factory(task, early_exit)
        return self.submit_spec(
            spec, factory, at=at, profile_key=self.engine.profile_key(task),
            scale_duration=not explicit,
            colo=self.engine.colocation_spec(task), tenant=tenant,
            _journal_task=_task_record(task, early_exit),
            _journal_kind="engine")

    def submit_spec(self, spec: TaskSpec,
                    driver_factory: Callable[[], TaskDriver],
                    at: float = 0.0, profile_key: Optional[Tuple] = None,
                    scale_duration: bool = True,
                    colo: Optional[ColocationSpec] = None,
                    tenant: str = "default",
                    _journal_task: Optional[Dict] = None,
                    _journal_kind: Optional[str] = None) -> TaskHandle:
        """Low-level admission: any ``TaskDriver`` factory (simulated
        drivers for benchmarks / property tests). When ``profile_key`` is
        given and ``scale_duration`` is on, the estimated duration is
        rescaled by the store's observed realized/estimated ratio for that
        key — the feedback loop. Feedback is always *recorded* against the
        unscaled estimate so the ratio never compounds. ``colo`` marks the
        task fusable: instead of waiting for free GPUs, a small pending
        task is routed onto a live shared-backbone replica with the same
        fuse key the moment cross-task admission accepts it — since the
        ragged refactor the key is width-free (arch/gpus/loss), so mixed
        batch-size submissions land on live replicas too."""
        with self._lock:
            name = spec.name
            assert name not in self._meta, f"duplicate task name {name}"
            self._check_quota(tenant)
            unscaled = spec.duration
            if profile_key is not None and scale_duration:
                spec = dataclasses.replace(
                    spec, duration=self.profile_store.scaled_duration(
                        profile_key, spec.duration))
            meta = _TaskMeta(spec=spec, unscaled_duration=unscaled,
                             submitted_at=max(at, self.now),
                             profile_key=profile_key, tenant=tenant,
                             colo=colo)

            def wrapped() -> TaskDriver:
                drv = driver_factory()
                meta.driver = drv        # kept for wall-time feedback
                # chunk-boundary SlotSnapshot checkpointing: engine drivers
                # expose their BatchedExecutor's hook; simulated drivers
                # don't and simply skip durability
                ex = getattr(drv, "executor", None)
                if (self._ckpt is not None and ex is not None
                        and hasattr(ex, "ckpt_hook")):
                    ex.ckpt_hook = self._ckpt.on_chunk
                return drv

            if self._journal is not None:
                # write-ahead: the submission is durable before the runtime
                # ever sees it, so a crash mid-admission still requeues it
                self._journal.append({
                    "rec": "submit", "name": name, "at": float(at),
                    "tenant": tenant,
                    "kind": _journal_kind or (
                        "engine" if _journal_task is not None else "driver"),
                    "spec": {"name": spec.name,
                             "duration": float(spec.duration),
                             "gpus": int(spec.gpus),
                             "release": float(spec.release)},
                    "unscaled_duration": float(unscaled),
                    "task": _journal_task})
            self._runtime.submit(spec, wrapped, at=at, colo=colo)
            self._meta[name] = meta
            handle = TaskHandle(self, name)
            self._handles[name] = handle
            return handle

    def attach_serving(self, frontend, *, name: str = "serve/replica-0",
                       gpus: int = 1, horizon_s: float = 3600.0,
                       chunk_s: float = 60.0, at: float = 0.0) -> TaskHandle:
        """Admit a serving replica as a first-class cluster resident: the
        replica's GPUs enter the planner's ownership / projected-skyline
        accounting as an ordinary task holding a finite serving lease
        (``horizon_s`` virtual seconds; retire early via the handle's
        ``cancel()``). Also registers ``frontend`` as the tune-to-serve
        target: every completed task's winning adapter is auto-published
        to it (from the durable ``serve_dir`` artifact when configured)."""
        from repro_torch.serve.driver import (ServingReplicaDriver,
                                             serving_spec)
        spec = serving_spec(name, gpus, horizon_s, release=at)
        handle = self.submit_spec(
            spec,
            lambda: ServingReplicaDriver(name, horizon_s=horizon_s,
                                         chunk_s=chunk_s, frontend=frontend),
            at=at, profile_key=None, scale_duration=False)
        self.serving = frontend
        return handle

    def cancel(self, name: str, at: Optional[float] = None) -> bool:
        with self._lock:
            assert name in self._meta, f"unknown task {name}"
            if not self._runtime._live:
                # session not started: queue the cancellation — beginning
                # the loop here would lock out a later
                # run_until_idle(initial=...)
                self._pre_cancels.append((name, at))
                return True
            return self._runtime.cancel(name, at=at)

    # ------------------------------------------------------------ the loop
    @property
    def now(self) -> float:
        return self._runtime.now

    def _ensure_live(self, initial: Optional[Schedule] = None) -> None:
        if not self._runtime._live:
            self._runtime.begin(initial)
            pre, self._pre_cancels = self._pre_cancels, []
            for name, at in pre:
                self._runtime.cancel(name, at=at)
            notes, self._pending_annotations = self._pending_annotations, []
            for e in notes:
                self._runtime.annotate(e)
        else:
            assert initial is None, "session already live"

    def _step(self) -> bool:
        with self._lock:
            self._ensure_live()
            more = self._runtime.step()
            self._feedback()
            self._journal_events()
            return more

    def _journal_events(self) -> None:
        """Append runtime events (arrivals, replans/adoptions, progress,
        completions, pod kills) to the write-ahead journal, once each."""
        if self._journal is None:
            return
        evs = self._runtime_events()
        for e in evs[self._jrn_seen:]:
            self._journal.append({"rec": "event", "event": event_to_json(e)})
        self._jrn_seen = len(evs)

    def _drive(self, done: Callable[[], bool]) -> None:
        self._ensure_live()
        while not done() and self._step():
            pass

    def run_until_idle(self, initial: Optional[Schedule] = None
                       ) -> ServiceReport:
        """Drain every admitted task (arrivals included) and report.
        The session stays open: later ``submit``s re-activate the loop."""
        self._ensure_live(initial)
        while self._step():
            pass
        rt = self._runtime.report()
        if self.profile_path is not None:
            self.profile_store.save(self.profile_path)
        return ServiceReport(
            task_results=dict(rt.results), makespan=rt.makespan,
            utilization=rt.utilization, replans=rt.replans,
            plans_adopted=rt.plans_adopted,
            plans_rejected=rt.plans_rejected, events=list(rt.events),
            cancelled=rt.cancelled, task_starts=dict(rt.task_starts),
            task_ends=dict(rt.task_ends), runtime=rt,
            colocated=dict(rt.colocated),
            preemptions=rt.preemptions, migrations=rt.migrations)

    def save_profile(self, path: Optional[str] = None) -> None:
        """Persist the session's ProfileStore (feedback survives process
        restarts; ``profile_path`` sessions also save automatically at
        every ``run_until_idle``)."""
        target = path or self.profile_path
        assert target, "no profile path configured"
        self.profile_store.save(target)

    def run_forever(self, poll_s: float = 0.05,
                    stall_timeout_s: float = 30.0) -> ServiceLoop:
        """Wall-clock driver: a daemon thread pumps ``step()`` on real
        time so submissions execute as they arrive instead of waiting for
        an explicit ``run_until_idle()``. Virtual cluster time still
        advances by profiled durations (it is the planning clock), while
        wall-clock step observations keep flowing into the ProfileStore
        through the usual ``_feedback`` path; checkpoints fire at the same
        chunk boundaries as in batch driving. A stall watchdog logs a
        warning when the runtime is busy but no event has fired within
        ``stall_timeout_s`` real seconds. Returns a ``ServiceLoop``
        handle — call ``.stop()`` to drain out."""
        assert self._loop is None or not self._loop.alive, \
            "service loop already running"
        stop = threading.Event()

        def pump() -> None:
            seen = 0
            last_change = time.monotonic()
            idle_saved = True
            while not stop.is_set():
                try:
                    with self._lock:
                        more = self._step()
                        busy = not self._runtime.idle()
                        n = len(self._runtime_events())
                except Exception:
                    _log.exception("service loop crashed")
                    return
                nowm = time.monotonic()
                if n != seen:
                    seen, last_change = n, nowm
                elif busy and nowm - last_change > stall_timeout_s:
                    _log.warning(
                        "service stall: no event for %.1fs "
                        "(virtual now=%.3f)", nowm - last_change, self.now)
                    last_change = nowm
                if more:
                    idle_saved = False
                else:
                    if not idle_saved and self.profile_path is not None:
                        with self._lock:
                            self.profile_store.save(self.profile_path)
                        idle_saved = True
                    stop.wait(poll_s)

        t = threading.Thread(target=pump, name="tuning-service-loop",
                             daemon=True)
        t.start()
        self._loop = ServiceLoop(t, stop)
        return self._loop

    # ------------------------------------------------------------ recovery
    @classmethod
    def recover(cls, state_dir: str, *, tasks=None, factories=None,
                engine=None, serve_frontend=None,
                **service_kw) -> "TuningService":
        """Rebuild a service from a crashed session's ``state_dir``.

        Replays the write-ahead journal: every journaled submission
        without a terminal (completed/cancelled) event is re-admitted —
        from its latest durable ``SlotSnapshot`` checkpoint when one
        loads cleanly (the task resumes mid-flight, bitwise), and from
        zero otherwise. Corrupt journal segments or checkpoints degrade
        to requeue-from-zero with a warning rather than failing recovery.
        Winner artifacts under ``serve_dir`` are re-published to
        ``serve_frontend`` when given. Engine tasks whose record was not
        serializable must be re-supplied via ``tasks`` (``Task`` or
        ``(Task, EarlyExitConfig)`` entries, matched by ``task_name``);
        plain driver submissions (benchmark simulations,
        serving leases) need a fresh factory in ``factories`` or are
        skipped. Emits one ``TASK_RECOVERED`` audit event per re-admitted
        task once the new session goes live."""
        from repro_torch.checkpoint.taskstate import load_task_checkpoint
        from repro_torch.sched.journal import replay_journal
        rep = replay_journal(state_dir)
        session = rep.session() or {}
        kw = dict(service_kw)
        if engine is None:
            for k in ("total_gpus", "strategy", "eval_every"):
                if session.get(k) is not None:
                    kw.setdefault(k, session[k])
        kw.setdefault("serve_dir", session.get("serve_dir"))
        kw.setdefault("ckpt_every", int(session.get("ckpt_every") or 1))
        svc = cls(engine=engine, state_dir=state_dir, **kw)
        ckpts = rep.checkpoints()
        if rep.corrupt:
            # a corrupt segment may have swallowed completions or newer
            # checkpoint records: distrust all snapshots, requeue from zero
            _log.warning("journal under %s has %d corrupt segment line(s);"
                         " recovering by requeue-from-zero", state_dir,
                         len(rep.corrupt))
            ckpts = {}
        terminal = rep.terminal_tasks()
        task_by_name: Dict[str, Tuple[Any, Optional[EarlyExitConfig]]] = {}
        for t in (tasks or []):
            task, ee = t if isinstance(t, tuple) else (t, None)
            task_by_name[task.task_name] = (task, ee)
        factories = dict(factories or {})
        for sub in rep.submits():
            name = sub["name"]
            if name in terminal:
                continue
            state = None
            ck = ckpts.get(name)
            if ck is not None:
                state = load_task_checkpoint(ck["path"])  # None if corrupt
            if sub.get("kind") == "engine":
                trec = sub.get("task")
                if name in task_by_name:
                    task, ee = task_by_name[name]
                    if ee is None:
                        ee = (EarlyExitConfig(**trec["early_exit"]) if trec
                              else EarlyExitConfig())
                elif trec is not None:
                    task, ee = _task_from_record(trec)
                else:
                    _log.warning("task %r was submitted with in-memory "
                                 "model/dataset and is not in tasks=: "
                                 "skipped", name)
                    continue
                if state is not None:
                    tree_meta = state[1]
                    chunk = int(tree_meta.get("chunk", 0))
                    # residual spec: remaining-steps bound at profiled
                    # step time stays a true upper bound for the planner
                    dur = (max(int(tree_meta["remaining_steps_bound"]), 1)
                           * svc.engine.profiled_step_time(task))
                    spec = dataclasses.replace(
                        svc.engine.profile_raw(task, ee), duration=dur)
                    svc.submit_spec(
                        spec,
                        svc.engine.resumed_driver_factory(
                            task, ee, state, start_chunk=chunk),
                        at=0.0, profile_key=svc.engine.profile_key(task),
                        scale_duration=False,
                        colo=svc.engine.colocation_spec(task),
                        _journal_task=trec, _journal_kind="engine")
                    reason, detail = "resumed", f"chunk={chunk}"
                else:
                    svc.submit(task, at=0.0, early_exit=ee)
                    reason, detail = "requeued", "from step 0"
            else:
                fac = factories.get(name)
                if fac is None:
                    _log.warning("driver task %r has no recovery factory: "
                                 "skipped", name)
                    continue
                sp = sub["spec"]
                svc.submit_spec(
                    TaskSpec(name=name, duration=float(sp["duration"]),
                             gpus=int(sp["gpus"]), release=0.0),
                    fac, at=0.0, scale_duration=False)
                reason, detail = "requeued", "driver task from zero"
            svc._pending_annotations.append(ProgressEvent(
                kind=EventKind.TASK_RECOVERED, task=name, reason=reason,
                detail=detail))
        if serve_frontend is not None:
            svc.republish_served(serve_frontend)
        return svc

    def republish_served(self, frontend) -> List[str]:
        """Crash recovery of the serving tier: re-publish every winner
        artifact under ``serve_dir`` to ``frontend`` (publishes load from
        disk, never live executor state). Corrupt or rejected artifacts
        are skipped with a warning. Returns the published adapter ids."""
        import glob
        import zipfile

        from repro_torch.serve.frontend import AdmissionError
        from repro_torch.serve.pool import CorruptCheckpoint, PoolFull
        self.serving = frontend
        published: List[str] = []
        if self.serve_dir is None:
            return published
        for path in sorted(glob.glob(os.path.join(self.serve_dir,
                                                  "*.npz"))):
            try:
                aid = frontend.publish_checkpoint(path)
                published.append(aid)
                self._ckpt_paths.setdefault(aid, path)
                self._pending_annotations.append(ProgressEvent(
                    kind=EventKind.ADAPTER_PUBLISHED, task=aid,
                    reason="republished", detail=f"from={path}"))
            except (CorruptCheckpoint, OSError, ValueError, KeyError,
                    zipfile.BadZipFile) as e:
                # the frontend's admission peek reads the artifact before
                # the pool does, so truncation can surface as a raw
                # zip/KeyError there rather than as CorruptCheckpoint
                _log.warning("serve artifact %s unreadable: %s", path, e)
            except AssertionError as e:
                # arch/spec_version mismatch or already resident
                _log.warning("serve artifact %s rejected: %s", path, e)
            except (AdmissionError, PoolFull) as e:
                _log.warning("serve artifact %s refused: %s", path, e)
        return published

    # ------------------------------------------------------------ feedback
    def _feedback(self) -> None:
        """Record realized durations/step times of newly finished tasks
        into the ProfileStore (the profiler feedback loop)."""
        ends = self._runtime.task_end_times
        if len(ends) == self._fb_seen:      # no new completions: stay O(1)
            return
        self._fb_seen = len(ends)
        starts = self._runtime.task_start_times
        for name, end in ends.items():
            if name in self._recorded or self._runtime.is_cancelled(name):
                continue
            self._recorded.add(name)
            meta = self._meta[name]
            self._tune_to_serve(name, meta)
            if meta.profile_key is None:
                continue
            wall = wall_tok = None
            if meta.driver is not None:
                obs = getattr(meta.driver, "observed_wall_step_s", None)
                wall = obs() if callable(obs) else None
                # per-token wall time: the calibrated quantity once fused
                # steps mix heterogeneous slot widths (ragged co-location)
                obs_t = getattr(meta.driver, "observed_wall_token_s", None)
                wall_tok = obs_t() if callable(obs_t) else None
            self.profile_store.record(
                meta.profile_key,
                realized_duration=end - starts[name],
                estimated_duration=meta.unscaled_duration,
                wall_step_time_s=wall,
                wall_token_time_s=wall_tok)
            # raw step observation: the training set for the fitted
            # (k0, k1, k2) step-time/memory models (sched/fitted.py).
            # Always recorded (cheap, FIFO-capped per key); consumed only
            # under fitted=True. Peak memory uses the admission model's
            # rank-aware prediction, as the reference records it, not the
            # card's measured peak (the same framing as profiling).
            if wall is not None and meta.colo is not None:
                colo = meta.colo
                tokens = float(colo.slots_needed * colo.per_adapter_batch
                               * colo.seq_len)
                rank = colo.lora_rank or (
                    colo.mem.charged_rank(None) if colo.mem else 1)
                peak = (colo.mem.predict_ranked(tokens, tokens * rank)
                        if colo.mem is not None else None)
                self.profile_store.record_step(
                    meta.profile_key, tokens=tokens,
                    rank_tokens=tokens * rank, wall_s=wall,
                    peak_memory=peak)

    # ------------------------------------------------------- tune-to-serve
    def _tune_to_serve(self, name: str, meta: _TaskMeta) -> None:
        """On task completion: checkpoint the winning adapter to a durable
        artifact under ``serve_dir`` (rank + fuse key + spec version in the
        metadata) and auto-publish it to the attached serving frontend —
        publish loads from the artifact, not live executor state, so a
        killed pod can replay its serve set from disk."""
        if self.serve_dir is None and self.serving is None:
            return
        res = self._results().get(name)
        best_job = getattr(res, "best_job", None)
        if best_job is None:
            return
        jr = res.job_results.get(best_job)
        if jr is None or getattr(jr, "adapter", None) is None:
            return
        from repro_torch.serve.pool import SPEC_VERSION
        rank = int(jr.config.lora_rank)
        fuse_key = list(meta.colo.fuse_key) if meta.colo is not None else None
        path = None
        if self.serve_dir is not None:
            from repro_torch.checkpoint.checkpoint import save_pytree
            path = os.path.join(self.serve_dir,
                                name.replace("/", "_") + ".npz")
            # atomic (tmp + fsync + os.replace): a crash mid-write never
            # leaves a truncated winner artifact under serve_dir
            save_pytree(path, jr.adapter, meta={
                "adapter_id": name, "task": name, "job": best_job,
                "rank": rank,
                "arch": fuse_key[0] if fuse_key else None,
                "fuse_key": fuse_key, "spec_version": SPEC_VERSION,
                "best_val": float(res.best_val)}, atomic=True)
            self._ckpt_paths[name] = path
            if self._journal is not None:
                self._journal.append({"rec": "serve", "task": name,
                                      "path": path})
        if self.serving is None:
            return
        from repro_torch.serve.frontend import AdmissionError
        from repro_torch.serve.pool import CorruptCheckpoint, PoolFull
        try:
            if path is not None:
                self.serving.publish_checkpoint(path, adapter_id=name)
            else:
                self.serving.publish(name, jr.adapter, rank,
                                     meta={"task": name, "job": best_job})
            reason, detail = "published", (
                f"rank={rank} slot={self.serving.pool.slot_of(name)}"
                + (" from=checkpoint" if path else " from=live"))
        except (AdmissionError, PoolFull, CorruptCheckpoint) as e:
            reason, detail = "refused", str(e)   # artifact still on disk
        self._runtime.annotate(ProgressEvent(
            kind=EventKind.ADAPTER_PUBLISHED, task=name, job=best_job,
            reason=reason, detail=detail))

    # ------------------------------------------------------------ status
    def status(self, name: str) -> TaskStatus:
        assert name in self._meta, f"unknown task {name}"
        meta = self._meta[name]
        rt = self._runtime
        started = rt.task_start_times.get(name) if rt._live else None
        ended = rt.task_end_times.get(name) if rt._live else None
        if rt._live and rt.is_cancelled(name):
            state = TaskState.CANCELLED
        elif ended is not None:
            state = TaskState.COMPLETED
        elif started is not None:
            state = TaskState.RUNNING
        else:
            state = TaskState.PENDING
        return TaskStatus(name=name, state=state,
                          submitted_at=meta.submitted_at,
                          started_at=started, finished_at=ended,
                          now=self.now)

    def handles(self) -> List[TaskHandle]:
        return list(self._handles.values())

    def _runtime_events(self) -> List[ProgressEvent]:
        return self._runtime.event_log if self._runtime._live else []

    def _results(self) -> Dict[str, Any]:
        return self._runtime.results_map
