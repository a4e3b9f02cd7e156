"""ALTO engine: the declarative LoRA-as-a-Service API (paper Listing 1).

    import repro_torch.core.engine as alto
    engine = alto.Engine(strategy="adapter_parallel", total_gpus=8)
    tasks = [alto.Task(model="paper-llama-tiny", num_gpus=1,
                       dataset=..., search_space={...})]
    early_exit = alto.EarlyExit(warmup_ratio=0.05)
    schedule = engine.schedule(tasks, method="cp")
    best = engine.batched_execution(tasks, schedule, early_exit)

The engine profiles each task (duration d_i, GPU need g_i), computes the
inter-task placement, instantiates one BatchedExecutor per task hosting
multiple jobs on a shared base-model replica, monitors loss trajectories,
and returns the best adapter per task — all transparently to the user.

Port of ``repro.core.engine``: the host side (task expansion, slot sizing,
profiling, scheduling, both execution paths, the driver factories) is the
reference's line for line, at the H100 constants of ``sched/profiler.py``.
The engine runs on the card unless the caller passes ``device="cpu"``;
every task trains through the port's ``BatchedExecutor`` and its CUDA
kernels. ``batched_execution(strategy="elastic")`` (the default) is a
one-shot ``TuningService`` session (``core/service.py``): an
``ElasticClusterRuntime`` over ``executor_driver_factory`` drivers under
the strict adoption rule, with exclusive placement.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, List, Optional, Sequence, Union

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.configs.registry import get_arch
from repro_torch.core.early_exit import EarlyExitConfig
from repro_torch.core.executor import BatchedExecutor, TaskResult
from repro_torch.data.synthetic import TaskDataset, make_task_dataset
from repro_torch.models import model as M
from repro_torch.models.common import resolve_device
from repro_torch.sched import fitted as fitted_models
from repro_torch.sched import profiler
from repro_torch.sched.cluster import ColocationSpec, ExecutorTaskDriver
from repro_torch.sched.events import ProgressEvent
from repro_torch.sched.inter_task import Schedule, TaskSpec, solve
from repro_torch.sched.intra_task import fit_memory_model

EarlyExit = EarlyExitConfig     # paper-API alias


@dataclasses.dataclass
class Task:
    """One user task: base model x dataset x hyperparameter search space."""
    model: Union[str, ModelConfig]
    dataset: Union[str, TaskDataset]
    search_space: Dict[str, List]
    num_gpus: int = 1
    max_steps: int = 60
    num_slots: int = 0              # 0 => memory-model-driven (paper §A.3)
    seed: int = 0
    name: str = ""
    loss_kind: str = "sft"
    device_memory: float = profiler.HBM_BYTES   # HBM per device (H100)

    def model_config(self) -> ModelConfig:
        return (self.model if isinstance(self.model, ModelConfig)
                else get_arch(self.model))

    def resolved_dataset(self) -> TaskDataset:
        if isinstance(self.dataset, TaskDataset):
            return self.dataset
        cfg = self.model_config()
        return make_task_dataset(self.dataset, cfg.vocab_size, seq_len=64,
                                 seed=self.seed)

    def jobs(self) -> Dict[str, TrainConfig]:
        """Expand the search space into one job per configuration."""
        keys = sorted(self.search_space)
        out: Dict[str, TrainConfig] = {}
        for combo in itertools.product(*(self.search_space[k] for k in keys)):
            kw = dict(zip(keys, combo))
            tc = TrainConfig(
                learning_rate=kw.get("lr", 1e-4),
                lora_rank=kw.get("rank", 16),
                per_adapter_batch=kw.get("batch_size", 4),
                weight_decay=kw.get("wd", 0.01),
                max_steps=self.max_steps,
                seed=kw.get("seed", self.seed))
            out[f"{self.task_name}/{tc.label()}"] = tc
        return out

    @property
    def task_name(self) -> str:
        if self.name:
            return self.name
        m = self.model if isinstance(self.model, str) else self.model.name
        d = self.dataset if isinstance(self.dataset, str) else self.dataset.name
        return f"{m}:{d}"


@dataclasses.dataclass
class EngineReport:
    task_results: Dict[str, TaskResult]
    schedule: Schedule
    makespan_estimate: float
    wall_time_s: float
    # execution observability — populated on BOTH paths (static fills
    # utilization from the plan's area and has zero replans / no events)
    execution: str = "static"
    virtual_makespan: Optional[float] = None
    utilization: float = 0.0
    replans: int = 0
    events: List[ProgressEvent] = dataclasses.field(default_factory=list)


class Engine:
    def __init__(self, strategy: str = "adapter_parallel",
                 total_gpus: int = 8, eval_every: int = 5,
                 profile_store: Optional[profiler.ProfileStore] = None,
                 fitted: bool = False, device=None):
        assert strategy in ("adapter_parallel", "single_gpu")
        # every task's executor trains on this device: the card unless the
        # caller asks for the CPU (raises without a card)
        self.device = resolve_device(device)
        self.strategy = strategy
        self.total_gpus = total_gpus
        self.eval_every = eval_every
        # fitted=True: admission budgets (memory_model -> ColocationSpec.mem
        # -> admit_cross_task / backfill / plan_fused) swap to the
        # profile-fitted (k0, k1, k2) models in sched/fitted.py once the
        # ProfileStore holds enough step observations for the profile key;
        # the analytic models stay the fallback below the guard.
        self.fitted = fitted
        self.profile_store = (profile_store if profile_store is not None
                              else profiler.ProfileStore())
        self._param_cache: Dict[str, Dict] = {}
        self._dataset_cache: Dict[str, TaskDataset] = {}
        self._mem_cache: Dict[str, object] = {}

    def _dataset(self, task: "Task") -> TaskDataset:
        """Resolve a task's dataset once per engine (profiling, slot
        sizing, and execution all need it; generation is deterministic)."""
        if task.task_name not in self._dataset_cache:
            self._dataset_cache[task.task_name] = task.resolved_dataset()
        return self._dataset_cache[task.task_name]

    # ---- intra-task slot sizing (paper §A.3 memory model) -------------------
    def memory_model(self, task: Task):
        """Fitted M_hat(B) = k0 + k1*B*L from analytic profile points (the
        CPU stand-in for torch.cuda.max_memory_reserved sweeps). Shared by
        slot sizing, the executor's backfill policy, and cross-task
        co-location admission."""
        key = task.task_name
        if key not in self._mem_cache:
            cfg = task.model_config()
            jobs = task.jobs()
            bsz = max(tc.per_adapter_batch for tc in jobs.values())
            ds = self._dataset(task)
            seq = ds.train.shape[1] - 1
            pts = [(z * bsz, profiler.analytic_peak_memory(
                cfg, z, bsz, seq, task.num_gpus)) for z in (1, 2, 4, 8)]
            self._mem_cache[key] = fit_memory_model(
                pts, seq, capacity=task.device_memory)
        mem = self._mem_cache[key]
        if self.fitted:
            # swap in the profile-fitted rank-aware M_hat once the store
            # has enough observed steps for this (arch, gpus); r_max frames
            # the fit so rank-unknown requests stay pessimistically billed.
            # (Not memoized here: fitted.py caches through the store's
            # versioned spec cache, which record_step invalidates.)
            frame = dataclasses.replace(
                mem, r_max=task.model_config().lora.r_max)
            return fitted_models.fitted_memory_model(
                self.profile_store, self.profile_key(task), frame)
        return mem

    def pick_slots(self, task: Task) -> int:
        """Admit the largest slot count whose total batch fits the memory
        model's safety margin (bounded by the search-space size)."""
        if task.num_slots:
            return task.num_slots
        jobs = task.jobs()
        bsz = max(tc.per_adapter_batch for tc in jobs.values())
        max_total = self.memory_model(task).max_batch()
        z = max(min(max_total // max(bsz, 1), len(jobs), 16), 1)
        return int(z)

    def colocation_spec(self, task: Task) -> ColocationSpec:
        """How this task fuses onto a shared frozen-backbone replica.

        The fuse key carries only what the fused step genuinely requires
        — (arch, GPU demand, loss kind). Per-adapter batch size and seq
        len are NOT in the key anymore: slots are ragged, so tasks with
        different widths co-train in one step and the widths instead
        enter §A.3 admission as a token budget (b x seq per slot, checked
        against the replica's token-linear memory model). The replica's
        physical slot capacity is the memory model's bound (NOT capped by
        this task's own search-space size — a small task's replica has
        room for co-tenants)."""
        cfg = task.model_config()
        jobs = task.jobs()
        bsz = max(tc.per_adapter_batch for tc in jobs.values())
        ds = self._dataset(task)
        seq = ds.train.shape[1] - 1
        mem = self.memory_model(task)
        replica = max(min(mem.max_batch() // max(bsz, 1), 16), 1)
        return ColocationSpec(
            fuse_key=(cfg.name, task.num_gpus, task.loss_kind),
            per_adapter_batch=bsz,
            slots_needed=self.pick_slots(task),
            replica_slots=int(replica),
            mem=mem, seq_len=seq,
            lora_rank=self.task_rank(task))

    # ---- profiling + inter-task scheduling ---------------------------------
    def profile_key(self, task: Task) -> tuple:
        """ProfileStore key: feedback generalizes across tasks that share a
        base model and GPU demand (what step time and lifecycle shrink
        actually depend on)."""
        return (task.model_config().name, task.num_gpus)

    def task_rank(self, task: Task) -> int:
        """The task's widest TRUE adapter rank (max over its search-space
        jobs, capped at r_max) — the rank its duration estimates and its
        rank-aware admission charge are billed at."""
        cfg = task.model_config()
        return max(min(tc.lora_rank, cfg.lora.r_max)
                   for tc in task.jobs().values())

    def profiled_step_time(self, task: Task) -> float:
        """Analytic per-step seconds driving the virtual timeline. Kept
        analytic on purpose: for real executors the realized virtual step
        time IS this value, so "observing" it would be circular, and wall
        step times live on a different clock (`ProfileStore.
        wall_step_time`). Duration feedback flows through the store's
        realized/worst-case ratio instead. Rank-aware: the LoRA term is
        billed at the task's true rank (rank-local kernels skip the
        padded rank tiles), not r_max."""
        cfg = task.model_config()
        jobs = task.jobs()
        bsz = max(tc.per_adapter_batch for tc in jobs.values())
        Z = self.pick_slots(task)
        ds = self._dataset(task)
        return profiler.profile_task(cfg, Z, bsz, ds.train.shape[1] - 1,
                                     task.num_gpus,
                                     rank=self.task_rank(task)).step_time_s

    def profile_raw(self, task: Task,
                    early_exit: EarlyExitConfig = EarlyExitConfig()
                    ) -> TaskSpec:
        """Worst-case TaskSpec (no duration feedback), analytic step time.
        Cached per (task name, early-exit config) in the ProfileStore so
        schedule() and batched_execution() profile each task once."""
        cache_key = (task.task_name, early_exit, "raw")
        hit = self.profile_store.get_spec(cache_key)
        if hit is not None:
            return hit
        jobs = task.jobs()
        Z = self.pick_slots(task)
        # duration: warmup waves for all K + full budget for the retained
        # top-k survivors (the scheduler's worst case: no pattern exits;
        # Pattern-3 selection is deterministic so it IS the worst case).
        # Pass the same early_exit here and to batched_execution — the
        # elastic runtime treats this duration as the residual upper bound.
        K = len(jobs)
        warmup = early_exit.warmup_steps(task.max_steps)
        steps = profiler.lifecycle_steps(K, Z, warmup, task.max_steps,
                                         survivors=early_exit.top_k(K))
        dur = profiler.residual_duration(steps, self.profiled_step_time(task))
        spec = TaskSpec(name=task.task_name, duration=max(dur, 1e-9),
                        gpus=task.num_gpus)
        self.profile_store.put_spec(cache_key, spec)
        return spec

    def profile(self, task: Task,
                early_exit: EarlyExitConfig = EarlyExitConfig()) -> TaskSpec:
        """TaskSpec for the inter-task solver: the worst case scaled by the
        ProfileStore's observed realized/worst-case ratio, so later
        schedules in a session use feedback instead of the analytic
        estimate."""
        raw = self.profile_raw(task, early_exit)
        scaled = self.profile_store.scaled_duration(
            self.profile_key(task), raw.duration)
        if scaled == raw.duration:
            return raw
        return dataclasses.replace(raw, duration=scaled)

    def schedule(self, tasks: Sequence[Task], method: str = "cp",
                 early_exit: EarlyExitConfig = EarlyExitConfig()
                 ) -> Schedule:
        specs = [self.profile(t, early_exit) for t in tasks]
        sched = solve(specs, self.total_gpus, method)
        sched.validate(self.total_gpus)
        return sched

    # ---- execution ----------------------------------------------------------
    def _base_params(self, cfg: ModelConfig, seed: int = 0) -> Dict:
        if cfg.name not in self._param_cache:
            self._param_cache[cfg.name] = M.init_params(
                cfg, seed=seed, device=self.device)
        return self._param_cache[cfg.name]

    def _make_executor(self, task: Task,
                       early_exit: EarlyExitConfig) -> BatchedExecutor:
        cfg = task.model_config()
        jobs = task.jobs()
        Z = self.pick_slots(task)
        bsz = max(tc.per_adapter_batch for tc in jobs.values())
        return BatchedExecutor(
            cfg, self._base_params(cfg, task.seed),
            self._dataset(task), Z=Z, per_adapter_batch=bsz,
            ee=early_exit, eval_every=self.eval_every, seed=task.seed,
            loss_kind=task.loss_kind, mem_model=self.memory_model(task),
            device=self.device)

    def executor_driver_factory(self, task: Task,
                                early_exit: EarlyExitConfig):
        """Driver factory for the elastic runtime / tuning service: wraps a
        freshly built BatchedExecutor in an ExecutorTaskDriver converting
        executor steps to virtual seconds at the profiled step time."""
        def factory():
            return ExecutorTaskDriver(
                task.task_name, self._make_executor(task, early_exit),
                task.jobs(), task.max_steps, self.profiled_step_time(task))
        return factory

    def resumed_driver_factory(self, task: Task,
                               early_exit: EarlyExitConfig, state,
                               start_chunk: int = 0):
        """Driver factory continuing a task from a durable mid-task
        checkpoint (``checkpoint/taskstate.py`` ``(tree, meta)`` state):
        the fresh executor's lifecycle is restored to the saved step
        before any chunk runs, so the replayed chunk stream is the
        uninterrupted run's tail, bitwise."""
        def factory():
            return ExecutorTaskDriver(
                task.task_name, self._make_executor(task, early_exit),
                task.jobs(), task.max_steps, self.profiled_step_time(task),
                resume_state=state, start_chunk=start_chunk)
        return factory

    def batched_execution(self, tasks: Sequence[Task], schedule: Schedule,
                          early_exit: EarlyExitConfig = EarlyExitConfig(),
                          strategy: str = "elastic") -> EngineReport:
        """Execute every task and return best adapters.

        A thin wrapper over a one-shot ``TuningService`` session: every
        task is submitted at t=0 and the session is drained to idle.
        strategy="elastic" (default) runs the event loop with the strict
        anomaly-safe adoption rule (delay_delta=None) and no co-location,
        preserving the elastic<=static makespan guarantee; each task's
        residual estimate is seeded with the worst of its planned and its
        executing duration. strategy="static"
        keeps the precomputed plan for A/B: tasks run to completion in
        schedule start order and the makespan estimate is the plan's worst
        case.

        Single-host note: training is sequential on one card either way;
        the strategies differ in the *virtual cluster timeline* (admission
        order, virtual makespan, utilization accounting), which is what the
        cluster benchmarks compare.
        """
        assert strategy in ("elastic", "static"), strategy
        t0 = time.time()
        by_name = {t.task_name: t for t in tasks}
        if strategy == "static":
            results: Dict[str, TaskResult] = {}
            for placement in sorted(schedule.placements,
                                    key=lambda p: p.start):
                task = by_name[placement.task.name]
                ex = self._make_executor(task, early_exit)
                results[task.task_name] = ex.run_task(
                    task.task_name, task.jobs(), task.max_steps)
            area = sum(p.task.duration * p.task.gpus
                       for p in schedule.placements)
            util = (area / (self.total_gpus * schedule.makespan)
                    if schedule.makespan > 0 else 0.0)
            return EngineReport(
                task_results=results, schedule=schedule,
                makespan_estimate=schedule.makespan,
                wall_time_s=time.time() - t0,
                execution="static", virtual_makespan=schedule.makespan,
                utilization=util)

        from repro_torch.core.service import TuningService
        # colocate=False: the batch A/B contract is exclusive placement
        # under the strict adoption rule; shared-replica fusion is the
        # service path's lever (TuningService defaults it on)
        service = TuningService(engine=self, delay_delta=None,
                                colocate=False)
        for placement in schedule.placements:
            task = by_name[placement.task.name]
            # The schedule may have been solved under a different
            # EarlyExitConfig than the one now executing (warmup/selection
            # shape the lifecycle). Seed the runtime's residual estimate
            # with the worst case of both so it stays a true upper bound —
            # otherwise the replanner would project GPUs free too early.
            # (raw: the service applies the feedback scale exactly once)
            exec_spec = self.profile_raw(task, early_exit)
            spec = dataclasses.replace(
                placement.task,
                duration=max(placement.task.duration, exec_spec.duration))
            service.submit(task, at=0.0, early_exit=early_exit, spec=spec)
        report = service.run_until_idle(initial=schedule)
        return EngineReport(
            task_results=dict(report.task_results), schedule=schedule,
            makespan_estimate=schedule.makespan,
            wall_time_s=time.time() - t0,
            execution="elastic", virtual_makespan=report.makespan,
            utilization=report.utilization, replans=report.replans,
            events=report.events)
