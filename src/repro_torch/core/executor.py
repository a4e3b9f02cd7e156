"""Shared-backbone multi-task executor: Z adapter slots, many lifecycles.

Port of ``repro.core.executor`` (PyTorch, eager). Every fused train step
runs the model forward, the backward over the LoRA leaves and AdamW on the
card (``core/steps.py``). Every LoRA projection goes through one of three
CUDA kernel sets forward and backward, chosen once per step on the host:
the rank-local set when a resident slot is below r_max (the rank sweep),
the ragged set when every slot is at r_max but some slot is narrower than
the lane (full-rank mixed-width co-location), the dense set otherwise (the
full-rank lr sweep). The host side — lifecycles, early exit, batch packing,
admission — is the JAX package's, line for line, including
``BatchedExecutor``'s durable checkpoint hook and its resume from a mid-task
checkpoint (``checkpoint/taskstate.py``). The loss kind ("sft" or "dpo",
``core/losses.py``) is fixed per executor: tasks of different kinds never
share one.

Implements the full per-task ALTO lifecycle (paper §4-§6) on top of a
slot-multiplexing shared executor (paper's central claim: concurrent
tuning jobs over one frozen backbone expose optimizations single-job
designs cannot):

  * ``SharedBackboneExecutor`` owns the frozen params, the ``SlotManager``
    (Z slot-stacked adapters), and the train/eval steps. Slots are
    tagged with the task that owns them, so adapter slots belonging to
    *different tasks* can be co-located on one backbone replica — the
    fused grouped-LoRA path trains them all in a single step, and slot
    isolation (tests/test_torch_executor.py) keeps each task's losses
    bitwise identical to running alone.
  * ``TaskLifecycle`` is the per-task state machine — warmup with
    rotation, Pattern-3 selection at the warmup boundary, continue-
    training with online divergence/overfit detection and slot backfill —
    that admits and evicts slots *through* the executor. All of its
    decisions (batch streams, init keys, eval points) are task-local, so
    a lifecycle behaves identically whether it runs alone or co-located —
    and, via ``suspend()``/``resume()`` (SlotSnapshot per resident job +
    exact lane restoration), identically across a MID-TASK move to a
    different replica: migration is invisible to the loss trajectory.
  * ``run_colocated`` drives several lifecycles over one executor with a
    cross-task admission gate (slot headroom + the §A.3 memory model) —
    pending small tasks backfill capacity the moment survivors free it.
  * ``BatchedExecutor`` keeps the original single-task API (one task, Z
    slots) as a thin wrapper: one executor, one lifecycle.

Slots are RAGGED (variable-width): each slot carries its own
(per-adapter batch, seq len), so one replica can fuse tasks with
*different* batch sizes in a single step. ``_assemble`` packs each slot's
own rows into a [Z, b_cap, seq_cap] lane buffer (label padding = -1 =>
masked out of every loss and gradient) and dispatches dense (all resident
slots full-width — the homogeneous fast case, no padding, no masks) vs
ragged (per-slot token-row counts ride the batch as ``slot_rows`` and
confine each slot's LoRA delta to its own rows: the rank-local kernels'
row counts when ranks are bound, the ragged kernels' otherwise). The
kernel-level
dead-tile skip covers BATCH raggedness (whole missing rows); a shorter-seq
guest is exact via label masking but pays padded compute for its seq-pad
columns (mid-lane padding is inexpressible as a row-prefix count). Admission budgets *tokens* (sum of b_z * seq_z), not
same-width slot counts — the §A.3 memory model M_hat is token-linear, so
heterogeneous widths share one replica soundly.

The executor is shape-static at CAPACITY: (Z, b_cap, seq_cap) never
changes, so every admit/evict — at any width — is an in-place tensor
update.

Lifecycle (unchanged from the paper):

  1. WARMUP with rotation: all K candidate jobs get ``warmup_steps`` of
     training, cycling through the task's slot allocation in waves;
     online pattern detection (divergence) is live during warmup; rotated
     jobs carry exact optimizer state via host snapshots.
  2. SELECTION at the warmup boundary: survivors ranked by val loss,
     top ceil(25% * K) continue (underperformance exits).
  3. CONTINUE-TRAINING: survivors train to their step budget with online
     divergence + overfitting detection; overfit exits checkpoint their
     best-val adapter; freed slots are BACKFILLED from the pending queue
     via the §A.3 admission policy (memory-model token budget; ragged
     slots need no width matching — ``sched/intra_task.py``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import losses as LS
from repro_torch.core import steps as STEPS
from repro_torch.core.adapter_state import SlotManager, SlotSnapshot
from repro_torch.core.early_exit import (EarlyExitConfig, ExitDecision,
                                         ExitReason, JobMonitor,
                                         warmup_select)
from repro_torch.data.synthetic import SlotBatcher, TaskDataset
from repro_torch.models import model as M
from repro_torch.models.common import resolve_device
from repro_torch.sched.events import EventKind, ProgressEvent
from repro_torch.sched.intra_task import (ExecutorSlots, MemoryModel,
                                          PendingJob)


@dataclasses.dataclass(frozen=True)
class ChunkReport:
    """One bounded slice of a task's execution (elastic runtime unit).

    The elastic cluster runtime (sched/cluster.py) interleaves many tasks
    by stepping each executor one chunk at a time; ``steps_executed``
    converts to virtual cluster time via the profiled step time, and
    ``events`` carries every lifecycle transition that fired inside the
    chunk (exits, selection, completion) so the runtime can replan.
    ``task`` attributes the chunk to its lifecycle (co-located replicas
    interleave chunks of several tasks), and ``slots_bound`` is a
    monotone upper bound on the task's future concurrent slot use — the
    quantity cross-task admission reclaims as survivors exit.
    ``tokens_executed`` counts the REAL tokens trained inside the chunk
    (padding excluded): with ragged slot widths, wall time per token —
    not per step — is the calibrated profiler-feedback quantity, and
    ``slot_tokens`` exposes each slot's per-step token footprint at flush
    time (0 = slot free)."""
    steps_executed: int
    events: Tuple[ProgressEvent, ...]
    phase: str
    remaining_steps_bound: int
    wall_time_s: float = 0.0     # realized host seconds (profiler feedback)
    task: str = ""
    slots_in_use: int = 0
    slots_bound: int = 0
    tokens_executed: int = 0     # real (non-padding) tokens in the chunk
    slot_tokens: Tuple[int, ...] = ()   # per-slot b*seq at flush (0 = free)
    slot_ranks: Tuple[int, ...] = ()    # per-slot TRUE rank at flush (0=free)


@dataclasses.dataclass
class JobResult:
    job_id: str
    config: TrainConfig
    best_val: float
    best_val_step: int
    exit_reason: Optional[ExitReason]
    steps_trained: int
    samples_trained: int
    adapter: Optional[Dict] = None          # best checkpoint (winner only)


@dataclasses.dataclass
class TaskResult:
    task_name: str
    best_job: Optional[str]     # None iff every job diverged (best_val=inf)
    best_val: float
    job_results: Dict[str, JobResult]
    wall_time_s: float
    total_samples: int
    samples_saved_frac: float
    exit_counts: Dict[str, int]


# ---------------------------------------------------------------------------
# Shared backbone executor
# ---------------------------------------------------------------------------

def _require_on(params: Dict, device: torch.device) -> None:
    """Raise unless every backbone tensor lies on ``device``."""
    stack = [params]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif node.device.type != device.type or (
                device.index is not None and node.device.index != device.index):
            raise ValueError(f"params lie on {node.device}, the executor "
                             f"runs on {device}")

class SharedBackboneExecutor:
    """One frozen-backbone replica: Z adapter slots shared by N tasks.

    Owns the device state and the fused train/eval steps; task lifecycles
    admit/evict slots through it and receive per-slot losses back.
    Resident tasks must share the loss kind and fit within the replica's
    (b_cap, seq_cap) lane capacity — but NOT each other's widths: slots
    are ragged, so adapters with different per-adapter batch sizes (and
    seq lens) train in the same fused step. Homogeneous full-width mixes
    dispatch the dense path (no row counts bound); anything else packs
    per-slot rows and binds their counts. Runs on the card unless
    ``device`` says otherwise; ``params`` must already lie there."""

    def __init__(self, cfg: ModelConfig, params: Dict, *, Z: int,
                 per_adapter_batch: int, eval_every: int = 5, seed: int = 0,
                 loss_kind: str = "sft",
                 mem_model: Optional[MemoryModel] = None,
                 seq_cap: Optional[int] = None, device=None):
        LS.check_loss_kind(loss_kind)
        self.device = resolve_device(device)
        _require_on(params, self.device)
        self.cfg = cfg
        self.params = params
        self.Z = Z
        self.b_cap = per_adapter_batch     # lane capacity, NOT a shared width
        self.seq_cap = seq_cap             # None => max over resident slots
        self.eval_every = eval_every
        self.loss_kind = loss_kind
        self.mem = mem_model
        self.seed = seed
        self.slots = SlotManager(cfg, Z, M.target_shapes(cfg),
                                 device=self.device)
        self._train_step = STEPS.make_train_step(cfg, loss_kind=loss_kind)
        self._eval_step = STEPS.make_eval_step(cfg, loss_kind=loss_kind)
        self._lifecycles: Dict[str, "TaskLifecycle"] = {}
        self._wall = 0.0
        self._tokens = 0

    # ---- task registry -----------------------------------------------------
    def add_task(self, lc: "TaskLifecycle") -> None:
        assert lc.task_name not in self._lifecycles, lc.task_name
        self._lifecycles[lc.task_name] = lc

    def remove_task(self, task_name: str) -> None:
        self._lifecycles.pop(task_name, None)

    def resident_tasks(self) -> List["TaskLifecycle"]:
        """Lifecycles with at least one occupied slot, registration order."""
        return [lc for lc in self._lifecycles.values() if lc.resident]

    def slot_headroom(self) -> int:
        """Physical slots not claimed by any registered task's future-use
        bound (what cross-task admission may hand to a new task)."""
        return self.Z - sum(lc.slots_bound() for lc in
                            self._lifecycles.values())

    def can_admit_task(self, lc: "TaskLifecycle") -> bool:
        """Cross-task admission gate: slot headroom plus the §A.3 memory
        model over the TOKEN budget (sum of per-slot b*seq) — ragged slots
        mean same-width slot counting under-/over-charges; M_hat is
        token-linear, so tokens are the sound budget unit. A rank-aware
        model (k2 > 0) additionally budgets rank-weighted FLOP-tokens
        (b*seq*rank per slot at each job's TRUE rank, not Z*r_max), so
        low-rank guests pack denser than padded accounting would allow."""
        if lc.slots_bound() > self.slot_headroom():
            return False
        if self.mem is None:
            return True
        tokens = sum(x.tokens_bound() for x in self._lifecycles.values())
        rtok = sum(x.rank_tokens_bound() for x in self._lifecycles.values())
        return self.mem.fits_ranked(tokens + lc.tokens_bound(),
                                    rtok + lc.rank_tokens_bound())

    # ---- slot ops (called by lifecycles) -----------------------------------
    def acquire_slot(self) -> int:
        free = self.slots.free_slots()
        assert free, "no free slot (admission gate violated)"
        return free[0]

    def admit(self, slot: int, task: str, job_id: str, tc: TrainConfig,
              gen: torch.Generator, b: int = 0, seq: int = 0) -> None:
        assert not b or b <= self.b_cap, f"slot width {b} > b_cap"
        self.slots.admit(slot, job_id, tc, gen, task=task, b=b, seq=seq)

    def restore(self, slot: int, task: str, snap: SlotSnapshot,
                tc: TrainConfig) -> None:
        self.slots.restore(slot, snap, tc, task=task)

    def evict(self, slot: int) -> None:
        self.slots.evict(slot)

    def snapshot(self, slot: int) -> SlotSnapshot:
        return self.slots.snapshot(slot)

    def adapter_at(self, slot: int) -> Dict:
        return self.slots.adapter_at(slot)

    # ---- fused stepping ----------------------------------------------------
    def _resolved_seq_cap(self) -> int:
        if self.seq_cap is not None:
            return self.seq_cap
        occ = [self.slots.slot_seq[i] for i in range(self.Z)
               if self.slots.slot_jobs[i] is not None]
        cap = max(occ, default=0)
        assert cap > 0, "no resident slot carries a seq len"
        return cap

    def _assemble(self) -> Tuple[Dict[str, torch.Tensor], np.ndarray,
                                 bool, int]:
        """One fused [Z, b_cap, seq_cap] batch with RAGGED slot packing.

        Each resident job's lane draws its OWN (b, seq) rows from its
        task's batcher, scattered into the job's physical slot; the lane
        tail is padding (tokens 0, labels -1 => masked out of loss and
        gradient). Every resident job's stream advances exactly one step
        at its own width — task-local determinism, independent of
        co-tenants. Returns (batch, slot_rows, dense, real_tokens):
        ``slot_rows[z]`` is slot z's valid token-row count in flattened
        b*seq units (the grouped-LoRA row counts), ``dense`` is
        True iff every resident slot is full-width (the homogeneous fast
        case — no padding, identical to the pre-ragged dense step), and
        ``real_tokens`` counts actual (non-padding) tokens this step."""
        S_cap = self._resolved_seq_cap()
        bufs: Dict[str, np.ndarray] = {}
        slot_rows = np.zeros((self.Z,), np.int32)
        dense = True
        tokens = 0
        for lc in self.resident_tasks():
            for job, (lane, slot) in lc.resident.items():
                rows = lc.lane_batch_dict(job)
                b_j = self.slots.slot_b[slot]
                s_j = self.slots.slot_seq[slot] or S_cap
                for k, arr in rows.items():
                    assert arr.shape[0] <= self.b_cap \
                        and arr.shape[1] <= S_cap, \
                        f"task {lc.task_name} rows exceed lane capacity"
                    if k not in bufs:
                        fill = -1 if k.startswith("labels") else 0
                        bufs[k] = np.full(
                            (self.Z, self.b_cap, S_cap) + arr.shape[2:],
                            fill, arr.dtype)
                    bufs[k][slot, :arr.shape[0], :arr.shape[1]] = arr
                slot_rows[slot] = b_j * S_cap
                tokens += b_j * s_j
                if b_j != self.b_cap or s_j != S_cap:
                    dense = False
        return ({k: torch.from_numpy(v).to(self.device)
                 for k, v in bufs.items()}, slot_rows, dense, tokens)

    def run_steps(self, n: int) -> None:
        """Train all active slots for n fused steps; dispatch per-slot
        losses to the owning lifecycles' monitors. Dense vs ragged is
        decided per step: a homogeneous full-width mix never pays the
        masking path, a mixed-width mix threads ``slot_rows`` through the
        batch. The per-slot losses are read to the host after every step
        (a sync), so the wall time accumulated here is the card's work, not
        its enqueue time."""
        t0 = time.time()
        for _ in range(n):
            batch, slot_rows, dense, tokens = self._assemble()
            if not dense:
                batch["slot_rows"] = torch.from_numpy(slot_rows).to(
                    self.device)
            if self.slots.mixed_rank(self.cfg.lora.r_max):
                # some resident rank < r_max: route LoRA through the
                # rank-local kernels (dead rank tiles skip their work); a
                # full-rank mix takes the ragged kernels when slot_rows is
                # bound and the dense ones when it is not
                batch["slot_ranks"] = self.slots.ranks
            self.slots.lora, self.slots.opt_state, metrics = self._train_step(
                self.params, self.slots.lora, self.slots.opt_state,
                self.slots.hp, self.slots.active, self.slots.ranks, batch)
            self._tokens += tokens
            per_loss = metrics["per_slot_loss"].cpu().numpy()
            for lc in self.resident_tasks():
                for job, (_, slot) in lc.resident.items():
                    lc.observe_train(job, float(per_loss[slot]))
        # accumulate actual train/eval host time only — flush-to-flush
        # deltas would also bill time the coordinator spent suspended
        self._wall += time.time() - t0

    def eval_task(self, lc: "TaskLifecycle") -> np.ndarray:
        """Per-slot val losses for ``lc``'s dataset (broadcast to all Z
        slots; slot isolation makes foreign-slot entries meaningless to
        this task and identical-to-solo for its own)."""
        t0 = time.time()
        rows = lc.batcher.val_batch_dict()
        batch = {k: torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
                     v[0][None], (self.Z,) + v.shape[1:]))).to(self.device)
                 for k, v in rows.items()}
        if self.slots.mixed_rank(self.cfg.lora.r_max):
            batch["slot_ranks"] = self.slots.ranks
        val = self._eval_step(self.params, self.slots.lora,
                              self.slots.active, batch).cpu().numpy()
        self._wall += time.time() - t0
        return val

    def take_wall(self) -> float:
        wall, self._wall = self._wall, 0.0
        return wall

    def take_tokens(self) -> int:
        """Real (non-padding) tokens trained since the last flush — the
        per-token profiler-feedback denominator for ragged widths."""
        tok, self._tokens = self._tokens, 0
        return tok

    def slot_token_widths(self) -> Tuple[int, ...]:
        """Per-slot tokens per fused step (b_z * seq_z; 0 = free slot)."""
        return tuple(
            self.slots.slot_tokens(i)
            if self.slots.slot_jobs[i] is not None else 0
            for i in range(self.Z))

    def slot_rank_vector(self) -> Tuple[int, ...]:
        """Per-slot TRUE adapter ranks (0 = free slot) — the rank-local
        observability twin of ``slot_token_widths``."""
        return tuple(self.slots.slot_rank)


# ---------------------------------------------------------------------------
# Per-task lifecycle state machine
# ---------------------------------------------------------------------------

class TaskLifecycle:
    """Warmup-rotation -> selection -> continue/backfill for ONE task,
    admitting/evicting slots through a (possibly shared) executor.

    Everything the lifecycle does is a function of its own construction
    arguments — batch streams, init keys, and eval points are task-local
    (lane-indexed, not physical-slot-indexed) — so its loss trajectory is
    bitwise identical whether the executor hosts it alone or co-located
    with other tasks (the loss-isolation property, tested in
    tests/test_torch_executor.py). That holds for full-rank tasks too,
    whose steps cross between kernel sets as co-tenants come and go: the
    dense kernels alone or beside full-width full-rank co-tenants, the
    ragged ones beside a narrower full-rank co-tenant, the rank-local ones
    beside a lower-rank co-tenant. The three are one template instantiated
    three times (one grid, tiling and fp32 summation order), so a
    full-rank slot's result is bitwise the same on each."""

    def __init__(self, ex: SharedBackboneExecutor, task_name: str,
                 jobs: Dict[str, TrainConfig], total_steps: int, *,
                 ee: EarlyExitConfig = EarlyExitConfig(),
                 max_slots: Optional[int] = None,
                 batcher=None, dataset: Optional[TaskDataset] = None,
                 seed: int = 0):
        assert jobs, f"task {task_name} has no jobs"
        self.ex = ex
        self.task_name = task_name
        self.jobs = dict(jobs)
        self.total_steps = total_steps
        self.ee = ee
        self.m = min(max_slots or ex.Z, ex.Z)     # this task's slot budget
        if batcher is None:
            assert dataset is not None, "need a batcher or a dataset"
            batcher = SlotBatcher(dataset, self.m, ex.b_cap, seed=seed)
        self.batcher = batcher
        # this task's seq len: a per-slot property on the shared executor
        # (co-tenants may differ; lanes are padded to the replica seq cap)
        self.seq_len = int(getattr(batcher, "seq_len", 0) or
                           (dataset.train.shape[1] - 1 if dataset is not None
                            else 0))
        assert self.seq_len > 0, f"task {task_name}: unknown seq len"
        self.K = len(jobs)
        self.warmup_steps = ee.warmup_steps(total_steps)
        self._seed = seed
        self._admissions = 0
        self.monitors: Dict[str, JobMonitor] = {
            j: JobMonitor(ee, j) for j in jobs}
        self.snapshots: Dict[str, SlotSnapshot] = {}
        self._best_ckpt: Dict[str, Dict] = {}
        self.steps_done: Dict[str, int] = {}
        self.resident: Dict[str, Tuple[int, int]] = {}   # job -> (lane, slot)
        self._free_lanes: List[int] = list(range(self.m))
        self._queue: List[str] = []
        # §A.3 admission/backfill policy over this task's slot budget; the
        # executor-level memory model bounds the *replica*, this instance
        # bounds the task's own allocation
        self._policy = ExecutorSlots(
            ex.mem if ex.mem is not None else _PERMISSIVE_MEM, self.m)
        job_ids = list(self.jobs)
        self._waves: List[List[str]] = [job_ids[i:i + self.m]
                                        for i in range(0, self.K, self.m)]
        self._wave_idx = 0
        self._wave_step = 0
        self._cont_step = 0
        self.phase = "idle"
        self._events: List[ProgressEvent] = []
        self._t0 = 0.0
        self._result: Optional[TaskResult] = None
        self._sus: Optional[List[Tuple[str, int]]] = None  # suspended (job, lane)
        self._sus_eval_every = 0
        self._b_cap = ex.b_cap             # cached caps: capacity queries
        self._r_max = ex.cfg.lora.r_max    # stay answerable while suspended

    # ---- helpers -----------------------------------------------------------
    def _next_key(self) -> torch.Generator:
        # (seed, admission counter): per-job init generators depend only on
        # this task's own admission history, never on co-tenant
        # interleaving (the JAX package folds the counter into its key;
        # the numbers differ from JAX's by design)
        self._admissions += 1
        s = np.random.SeedSequence([self._seed, self._admissions])
        return torch.Generator(device=self.ex.device).manual_seed(
            int(s.generate_state(1)[0]))

    def job_width(self, job_id: str) -> int:
        """The job's OWN per-adapter batch size, capped at the replica's
        lane capacity — slots are ragged, so every job trains at its own
        width instead of the executor-wide maximum. (Caps are cached so
        capacity queries stay answerable while the task is suspended
        between replicas.)"""
        b = self.jobs[job_id].per_adapter_batch or self._b_cap
        return max(min(b, self._b_cap), 1)

    def job_rank(self, job_id: str) -> int:
        """The job's TRUE adapter rank (capped at r_max) — what the
        rank-local kernels compute at and the rank-aware §A.3 budget
        charges, instead of the padded r_max."""
        return max(min(self.jobs[job_id].lora_rank, self._r_max), 1)

    def lane_batch_dict(self, job_id: str) -> Dict[str, np.ndarray]:
        """One fused-step draw for a resident job: its lane's stream
        advanced by its own width (task-local, co-tenant independent)."""
        lane, _ = self.resident[job_id]
        return self.batcher.lane_batch_dict(lane, self.job_width(job_id))

    def _admit_job(self, job_id: str, lane: Optional[int] = None) -> None:
        if lane is None:
            lane = self._free_lanes.pop(0)
        else:
            self._free_lanes.remove(lane)     # exact lane (resume/migration)
        slot = self.ex.acquire_slot()
        tc = self.jobs[job_id]
        if job_id in self.snapshots:
            self.ex.restore(slot, self.task_name,
                            self.snapshots.pop(job_id), tc)
        else:
            self.ex.admit(slot, self.task_name, job_id, tc, self._next_key(),
                          b=self.job_width(job_id), seq=self.seq_len)
        self.resident[job_id] = (lane, slot)
        self._policy.resident[job_id] = self.job_width(job_id)
        self._policy.resident_ranks[job_id] = self.job_rank(job_id)

    def _evict_job(self, job_id: str) -> None:
        lane, slot = self.resident.pop(job_id)
        self.ex.evict(slot)
        self._free_lanes.append(lane)
        self._free_lanes.sort()
        self._policy.evict(job_id)

    def observe_train(self, job_id: str, loss: float) -> None:
        self.monitors[job_id].observe_train(loss)
        self.steps_done[job_id] = self.steps_done.get(job_id, 0) + 1

    # ---- suspend / resume (slot-level migration primitive) -----------------
    def suspend(self) -> None:
        """Detach this task from its executor mid-flight: snapshot every
        resident job bit-exactly (``SlotSnapshot`` carries adapter +
        optimizer moments + step count + slot geometry) and release the
        slots. All decision state — batcher lane streams, monitors, phase
        counters, init keys — is task-local and stays in this object, so
        ``resume()`` on another replica continues the loss trajectory
        exactly where it stopped."""
        assert self.phase in ("warmup", "continue"), \
            f"cannot suspend lifecycle in phase {self.phase!r}"
        assert self._sus is None, "already suspended"
        self._sus = []
        for job_id in sorted(self.resident):
            lane, slot = self.resident[job_id]
            self.snapshots[job_id] = self.ex.snapshot(slot)
            self._sus.append((job_id, lane))
            self._evict_job(job_id)
        self._sus_eval_every = self.ex.eval_every
        self.ex.remove_task(self.task_name)
        self.ex = None

    def resume(self, ex: SharedBackboneExecutor) -> None:
        """Re-attach a suspended lifecycle to ``ex`` (typically a different
        replica with a different resident mix). Physical slot indices may
        differ from the old host — that is the point — but lanes are
        restored EXACTLY: lanes index this task's batch streams, and
        lane-exact restoration is what makes the post-migration trajectory
        bitwise identical to a never-migrated run. The caller is
        responsible for the cross-task admission gate
        (``ex.can_admit_task``); eval cadence must match the old host
        (eval points are defined on the task-local step grid)."""
        assert self._sus is not None, "resume() requires a suspended task"
        assert ex.eval_every == self._sus_eval_every, \
            "resume requires the old host's eval cadence"
        assert ex.b_cap == self._b_cap and ex.cfg.lora.r_max == self._r_max, \
            "resume requires a same-shape replica (lane width / r_max)"
        self.ex = ex
        ex.add_task(self)
        for job_id, lane in self._sus:
            self._admit_job(job_id, lane=lane)
        self._sus = None

    @property
    def done(self) -> bool:
        return self.phase == "done"

    def drain_events(self) -> Tuple[ProgressEvent, ...]:
        ev, self._events = tuple(self._events), []
        return ev

    # ---- capacity observability (cross-task admission) ---------------------
    def slots_in_use(self) -> int:
        return len(self.resident)

    def slots_bound(self) -> int:
        """Monotone upper bound on future concurrent slot use. Shrinks as
        warmup waves drain and survivors exit — the freed capacity the
        cross-task admission path reclaims for pending small tasks."""
        if self.phase == "done":
            return 0
        if self.phase in ("idle", "warmup"):
            alive_waves = [len([j for j in w if self.monitors[j].exited
                                is None])
                           for w in self._waves[self._wave_idx:]]
            cont = min(self.m, self.ee.top_k(self.K))
            return max(alive_waves + [cont, len(self.resident)])
        return min(self.m, len(self.resident) + len(self._queue))

    def width_bound(self) -> int:
        """Upper bound on the widest slot this task will still occupy
        (max per-adapter batch over non-exited jobs; shrinks as wide jobs
        exit)."""
        alive = [self.job_width(j) for j in self.jobs
                 if self.monitors[j].exited is None]
        return max(alive, default=0)

    def tokens_bound(self) -> int:
        """Monotone upper bound on this task's per-step TOKEN footprint
        (slots x widest remaining width x seq len) — what the ragged
        cross-task admission gate budgets against the §A.3 memory model
        instead of same-width slot counts."""
        return self.slots_bound() * self.width_bound() * self.seq_len

    def rank_bound(self) -> int:
        """Upper bound on the highest TRUE rank this task will still
        train (max over non-exited jobs; shrinks as high-rank jobs
        exit)."""
        alive = [self.job_rank(j) for j in self.jobs
                 if self.monitors[j].exited is None]
        return max(alive, default=0)

    def rank_tokens_bound(self) -> int:
        """Monotone upper bound on this task's per-step rank-weighted
        FLOP-token footprint (tokens_bound x highest remaining rank) —
        the rank-aware §A.3 budget unit. Charging true ranks instead of
        r_max is what lets mixed-rank guests pack denser."""
        return self.tokens_bound() * self.rank_bound()

    def remaining_steps_bound(self) -> int:
        """Upper bound on executor steps left in this lifecycle, assuming
        no further pattern exits (the residual d_i the elastic runtime
        plans with; shrinks monotonically as events fire)."""
        m = max(self.m, 1)
        cont_budget = self.total_steps - self.warmup_steps
        if self.phase in ("idle", "warmup"):
            survivors = self.ee.top_k(self.K)
            cont = -(-survivors // m) * cont_budget
            waves_left = max(len(self._waves) - self._wave_idx - 1, 0)
            in_wave = (self.warmup_steps - self._wave_step
                       if self.phase == "warmup" else
                       len(self._waves) and self.warmup_steps)
            return in_wave + waves_left * self.warmup_steps + cont
        if self.phase == "continue":
            alive = list(self.resident) + list(self._queue)
            rem = [max(self.total_steps - self.steps_done.get(j, 0), 0)
                   for j in alive]
            if not rem:
                return 0
            return -(-len(rem) // m) * max(rem)
        return 0

    # ---- phase machine -----------------------------------------------------
    def begin(self) -> None:
        assert self.phase == "idle"
        self._t0 = time.time()
        self.phase = "warmup"
        self._start_wave()

    def _start_wave(self) -> None:
        for job_id in self._waves[self._wave_idx]:
            self._admit_job(job_id)
        self._wave_step = 0

    def steps_until_boundary(self) -> int:
        """Steps to this task's next decision point (eval-grid point, wave
        end, or the nearest resident job's budget). Always >= 1 for a
        non-done lifecycle; the coordinator steps the executor by the min
        across co-located tasks so no task overshoots its boundary."""
        ev = self.ex.eval_every
        if self.phase == "warmup":
            to_eval = ev - (self._wave_step % ev)
            return min(self.warmup_steps - self._wave_step, to_eval)
        if self.phase == "continue":
            to_eval = ev - (self._cont_step % ev)
            to_budget = min(
                (self.total_steps - self.steps_done.get(j, 0)
                 for j in self.resident), default=to_eval)
            return max(min(to_eval, to_budget), 1)
        return 1 << 30

    def on_steps(self, n: int) -> None:
        """Advance the task-local clock after the executor trained n fused
        steps; process any boundary that landed. Eval points are defined on
        the task's OWN step grid (every ``eval_every`` phase steps, wave
        ends, budget hits) — a co-tenant's smaller chunk never adds an
        eval, which is what keeps co-located loss histories identical to
        solo ones."""
        if self.phase == "warmup":
            self._wave_step += n
            if (self._wave_step % self.ex.eval_every == 0
                    or self._wave_step >= self.warmup_steps):
                self._eval_and_detect()
            if self._wave_step >= self.warmup_steps:
                self._end_wave()
        elif self.phase == "continue":
            self._cont_step += n
            at_budget = any(self.steps_done.get(j, 0) >= self.total_steps
                            for j in self.resident)
            if self._cont_step % self.ex.eval_every == 0 or at_budget:
                self._eval_and_detect()
            self._settle_continue()

    # ---- warmup ------------------------------------------------------------
    def _end_wave(self) -> None:
        # snapshot+rotate out whatever survived this wave
        for job_id in list(self.resident):
            lane, slot = self.resident[job_id]
            self.snapshots[job_id] = self.ex.snapshot(slot)
            self._evict_job(job_id)
        self._wave_idx += 1
        if self._wave_idx < len(self._waves):
            self._start_wave()
        else:
            self._select_and_continue()

    def _select_and_continue(self) -> None:
        # Pattern-3 selection at the warmup boundary (underperformance)
        kept, dropped = warmup_select(self.monitors, self.ee,
                                      num_candidates=self.K)
        for j in dropped:
            self.monitors[j]._exit(ExitReason.UNDERPERFORMING,
                                   self.steps_done.get(j, self.warmup_steps))
            self.snapshots.pop(j, None)
        if dropped:
            self._events.append(ProgressEvent(
                kind=EventKind.WARMUP_SELECTION, task=self.task_name,
                reason=ExitReason.UNDERPERFORMING.value,
                step=self.warmup_steps, dropped=tuple(dropped)))
        self.phase = "continue"
        self._cont_step = 0
        self._queue = list(kept)
        # §A.3 greedy decreasing-batch-size initial admission (stable sort:
        # a homogeneous-batch queue keeps its val-loss ranking)
        pending = [PendingJob(j, self.job_width(j), self.job_rank(j))
                   for j in self._queue]
        for pj in self._policy.admit_initial(pending):
            self._policy.evict(pj.job_id)            # _admit_job re-adds
            self._queue.remove(pj.job_id)
            self._admit_job(pj.job_id)
        self._settle_continue()

    # ---- continue ----------------------------------------------------------
    def _backfill(self) -> None:
        """§A.3 backfill into freed capacity: pure memory-model budget —
        ragged slots removed the same-batch-size constraint (any width
        that fits the token budget co-trains in the fused step)."""
        if not self._queue or not self._free_lanes:
            return
        pending = [PendingJob(j, self.job_width(j), self.job_rank(j))
                   for j in self._queue]
        pick = self._policy.backfill(pending)
        if pick is None:
            return
        self._policy.evict(pick.job_id)              # _admit_job re-adds
        self._queue.remove(pick.job_id)
        self._admit_job(pick.job_id)

    def _exit_job(self, job_id: str, decision: ExitDecision) -> None:
        self._events.append(ProgressEvent(
            kind=EventKind.JOB_EXITED, task=self.task_name, job=job_id,
            reason=decision.reason.value, step=decision.step))
        self._evict_job(job_id)
        if self.phase == "continue":
            self._backfill()

    def _eval_and_detect(self) -> None:
        if not self.resident:
            return
        val = self.ex.eval_task(self)
        for job_id, (_, slot) in list(self.resident.items()):
            mon = self.monitors[job_id]
            prev_best = mon.best_val
            decision = mon.observe_val(float(val[slot]),
                                       self.steps_done.get(job_id, 0))
            # checkpoint best-val adapter (cheap: host copy of one slot)
            if mon.val_hist[-1] <= prev_best:
                self._best_ckpt[job_id] = self.ex.adapter_at(slot)
            if decision is not None:
                self._exit_job(job_id, decision)

    def _settle_continue(self) -> None:
        """Complete at-budget jobs (possibly newly backfilled ones, who may
        arrive already at budget when warmup == total budget) and finish
        the task once queue + slots drain."""
        changed = True
        while changed:
            changed = False
            for job_id in list(self.resident):
                if self.steps_done.get(job_id, 0) >= self.total_steps:
                    self.monitors[job_id]._exit(
                        ExitReason.COMPLETED, self.steps_done[job_id])
                    self._events.append(ProgressEvent(
                        kind=EventKind.JOB_EXITED, task=self.task_name,
                        job=job_id, reason=ExitReason.COMPLETED.value,
                        step=self.steps_done[job_id]))
                    self._evict_job(job_id)
                    self._backfill()
                    changed = True
        if not self.resident and not self._queue:
            self._finish()

    # ---- results -----------------------------------------------------------
    def _finish(self) -> None:
        self.phase = "done"
        results: Dict[str, JobResult] = {}
        for job_id, tc in self.jobs.items():
            mon = self.monitors[job_id]
            results[job_id] = JobResult(
                job_id=job_id, config=tc, best_val=mon.best_val,
                best_val_step=mon.best_val_step,
                exit_reason=(mon.exited.reason if mon.exited else None),
                steps_trained=mon.steps_trained,
                samples_trained=mon.steps_trained * self.job_width(job_id))
        finite = {j: r for j, r in results.items()
                  if np.isfinite(r.best_val)}
        # all jobs can diverge (every val loss inf/nan): report an empty
        # winner instead of crashing — the tenant sees best_job=None
        best_job: Optional[str] = (
            min(finite, key=lambda j: finite[j].best_val) if finite else None)
        best_val = results[best_job].best_val if best_job else float("inf")
        if best_job is not None:
            results[best_job].adapter = self._best_ckpt.get(best_job)
        total_samples = sum(r.samples_trained for r in results.values())
        full_samples = sum(self.total_steps * self.job_width(j)
                           for j in self.jobs)
        exit_counts: Dict[str, int] = {}
        for r in results.values():
            if r.exit_reason is not None:
                exit_counts[r.exit_reason.value] = (
                    exit_counts.get(r.exit_reason.value, 0) + 1)
        self._events.append(ProgressEvent(
            kind=EventKind.TASK_COMPLETED, task=self.task_name,
            detail=f"best={best_job}"))
        self._result = TaskResult(
            task_name=self.task_name, best_job=best_job, best_val=best_val,
            job_results=results, wall_time_s=time.time() - self._t0,
            total_samples=total_samples,
            samples_saved_frac=1.0 - total_samples / max(full_samples, 1),
            exit_counts=exit_counts)

    def result(self) -> TaskResult:
        assert self._result is not None, "lifecycle not finished"
        return self._result


_PERMISSIVE_MEM = MemoryModel(k0=0.0, k1=0.0, seq_len=1,
                              capacity=float("inf"))


# ---------------------------------------------------------------------------
# Coordinators
# ---------------------------------------------------------------------------

def run_colocated(ex: SharedBackboneExecutor,
                  lifecycles: Sequence[TaskLifecycle],
                  ) -> Dict[str, TaskResult]:
    """Drive several task lifecycles over ONE shared executor.

    Tasks are admitted in order the moment the cross-task gate (slot
    headroom + memory model, ``can_admit_task``) accepts them — a pending
    small task starts as soon as survivors of the running tasks free
    enough capacity, instead of waiting for a whole replica. The fused
    executor steps by the min boundary across resident tasks, so every
    task hits its own eval grid exactly as it would alone."""
    waiting = list(lifecycles)
    live: List[TaskLifecycle] = []
    results: Dict[str, TaskResult] = {}
    guard = 10 + 20 * sum(
        lc.total_steps * max(lc.K, 1) for lc in lifecycles)

    def try_admit() -> None:
        for lc in list(waiting):
            if ex.can_admit_task(lc):
                ex.add_task(lc)
                lc.begin()
                waiting.remove(lc)
                live.append(lc)

    try_admit()
    while (waiting or live) and guard > 0:
        for lc in list(live):
            if lc.done:
                results[lc.task_name] = lc.result()
                ex.remove_task(lc.task_name)
                live.remove(lc)
        try_admit()
        if not live:
            if waiting:
                raise RuntimeError(
                    f"unplaceable tasks: {[lc.task_name for lc in waiting]}")
            break
        n = min(lc.steps_until_boundary() for lc in live)
        n = max(min(n, ex.eval_every), 1)
        ex.run_steps(n)
        guard -= n
        for lc in live:
            lc.on_steps(n)
    assert guard > 0, "colocated coordinator stopped progressing"
    return results


class BatchedExecutor:
    """Single-task compatibility wrapper: one SharedBackboneExecutor, one
    TaskLifecycle, the original run_task / run_task_chunks API."""

    def __init__(self, cfg: ModelConfig, params: Dict, dataset: TaskDataset,
                 *, Z: int, per_adapter_batch: int,
                 ee: EarlyExitConfig = EarlyExitConfig(),
                 eval_every: int = 5, seed: int = 0,
                 loss_kind: str = "sft", batcher=None,
                 mem_model: Optional[MemoryModel] = None,
                 seq_cap: Optional[int] = None, device=None):
        if seq_cap is None and dataset is not None:
            seq_cap = dataset.train.shape[1] - 1
        self.backbone = SharedBackboneExecutor(
            cfg, params, Z=Z, per_adapter_batch=per_adapter_batch,
            eval_every=eval_every, seed=seed, loss_kind=loss_kind,
            mem_model=mem_model, seq_cap=seq_cap, device=device)
        self.cfg = cfg
        self.dataset = dataset
        self.Z = Z
        self.b = per_adapter_batch
        self.ee = ee
        self.eval_every = eval_every
        self.seed = seed
        self._batcher = batcher
        self.slots = self.backbone.slots      # compat: direct slot access
        # Optional durability hook, called as ``ckpt_hook(lc, chunk_i)``
        # after every completed chunk while the lifecycle is still live —
        # a ``checkpoint.taskstate.TaskCheckpointer.on_chunk`` goes here.
        self.ckpt_hook = None

    # ------------------------------------------------------------------ run
    def run_task(self, task_name: str, jobs: Dict[str, TrainConfig],
                 total_steps: int) -> TaskResult:
        """Run the full lifecycle to completion (static path)."""
        gen = self.run_task_chunks(task_name, jobs, total_steps)
        while True:
            try:
                next(gen)
            except StopIteration as done:
                return done.value

    def run_task_chunks(self, task_name: str, jobs: Dict[str, TrainConfig],
                        total_steps: int):
        """Generator form of the lifecycle: yields a ChunkReport after every
        bounded chunk (<= eval_every steps) so the elastic cluster runtime
        can interleave many tasks and replan on the events each chunk
        surfaces. ``return``s the TaskResult (StopIteration.value)."""
        ex = self.backbone
        batcher = (self._batcher if self._batcher is not None
                   else SlotBatcher(self.dataset, self.Z, self.b,
                                    seed=self.seed))
        lc = TaskLifecycle(ex, task_name, jobs, total_steps, ee=self.ee,
                           max_slots=self.Z, batcher=batcher, seed=self.seed)
        ex.add_task(lc)
        ex.take_wall()
        lc.begin()
        return (yield from self._drive_chunks(lc, 0))

    def resume_task_chunks(self, task_name: str,
                           jobs: Dict[str, TrainConfig], total_steps: int,
                           state, start_chunk: int = 0):
        """``run_task_chunks`` continued from a durable mid-task checkpoint
        (``checkpoint/taskstate.py`` state). The restored lifecycle picks
        up at its exact step — batch-stream cursors, init seed and
        admission counter, monitors, optimizer moments and per-slot
        rank/width all come from the snapshot — so the remaining chunk
        stream is bitwise identical to the uninterrupted run's tail."""
        from repro_torch.checkpoint.taskstate import restore_lifecycle
        ex = self.backbone
        batcher = (self._batcher if self._batcher is not None
                   else SlotBatcher(self.dataset, self.Z, self.b,
                                    seed=self.seed))
        lc = restore_lifecycle(ex, task_name, jobs, total_steps, ee=self.ee,
                               max_slots=self.Z, batcher=batcher, state=state)
        ex.add_task(lc)
        ex.take_wall()
        ex.take_tokens()
        return (yield from self._drive_chunks(lc, start_chunk))

    def _drive_chunks(self, lc: TaskLifecycle, chunk_i: int):
        ex = self.backbone
        guard = 10 + 20 * lc.total_steps * max(len(lc.jobs), 1)
        while not lc.done and guard > 0:
            n = max(min(lc.steps_until_boundary(), self.eval_every), 1)
            ex.run_steps(n)
            guard -= n
            lc.on_steps(n)
            chunk_i += 1
            if self.ckpt_hook is not None and not lc.done:
                self.ckpt_hook(lc, chunk_i)
            yield self._flush(lc, n)
        assert guard > 0, f"task {lc.task_name} stopped progressing"
        yield self._flush(lc, 0)
        ex.remove_task(lc.task_name)
        return lc.result()

    def _flush(self, lc: TaskLifecycle, steps: int) -> ChunkReport:
        return ChunkReport(
            steps_executed=steps, events=lc.drain_events(), phase=lc.phase,
            remaining_steps_bound=lc.remaining_steps_bound(),
            wall_time_s=self.backbone.take_wall(), task=lc.task_name,
            slots_in_use=lc.slots_in_use(), slots_bound=lc.slots_bound(),
            tokens_executed=self.backbone.take_tokens(),
            slot_tokens=self.backbone.slot_token_widths(),
            slot_ranks=self.backbone.slot_rank_vector())
