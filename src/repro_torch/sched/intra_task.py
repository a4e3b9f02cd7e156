"""Online greedy intra-task scheduler (paper §7.1, §A.3).

A verbatim copy of ``repro.sched.intra_task`` (numpy only): the port
imports nothing of the JAX package.

Decides how many adapters to co-locate on an executor and when to
admit/evict, under a fitted linear memory model

    M_hat(B) = k0 + k1 * B * L        (B = total batch, L = seq len)

Profiling (paper §A.3 two-phase): (1) binary-search the largest
single-adapter batch B_max that fits; (2) sweep (N, b) grid points with
N*b <= B_max, measure peak memory, fit the regression
(``fit_memory_model``). The engine (``core/engine.py``) fits the analytic
accounting of ``sched/profiler.py`` at the card's memory size (same
linear structure); the measured peaks are read beside it on the card.

Admission policy: admit pending jobs greedily in decreasing batch-size
order while M_hat stays within the safety margin. Slots are RAGGED
(variable-width: the fused step packs per-slot row counts through the
ragged grouped-LoRA kernels), so mixed batch sizes co-train freely — the
budget is the token-linear memory model, never same-width slot counting.
Cross-task admission (``admit_cross_task``) budgets the same way over
TOKENS (slots * b * seq), letting tasks with different batch sizes and
seq lens share one frozen-backbone replica.

Rank-aware extension (rank-local grouped GEMM): adapters are also RANK-
heterogeneous, and with the rank-local kernels a slot's compute/memory
footprint scales with its TRUE rank, not the padded r_max. A fitted
``k2`` term budgets rank-weighted FLOP-tokens (b * seq * rank per slot);
requests that don't know their rank are charged r_max — the historical
Z*r_max padded accounting, now the pessimistic fallback rather than the
only option.

Layer contract: this module is the single source of truth for "does this
adapter set fit this replica" — ``MemoryModel.fits_ranked`` (k0 + k1*tokens
+ k2*rank_tokens <= capacity*safety_margin) is the invariant every
admission path checks: intra-task backfill (``ExecutorSlots``), cross-task
fusion (``admit_cross_task``), and — linearized into
``ReplicaState.mem_budget`` — the fusion-aware inter-task planner
(``plan_fused`` in inter_task.py). The three layers budgeting the same
quantity is what makes a plan-level fusion decision realizable at
admission time. The serving frontend budgets against the same model.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class MemoryModel:
    k0: float                 # bytes at B=0 (params, cache, fixed overhead)
    k1: float                 # bytes per (token of total batch)
    seq_len: int
    capacity: float           # device HBM bytes
    safety_margin: float = 0.9
    # rank-aware extension: the LoRA working set (S/dS activations, adapter
    # + optimizer state) scales with tokens x TRUE rank, not tokens x r_max.
    # k2 = bytes per rank-weighted FLOP-token (b*seq*rank per slot);
    # r_max = the rank a request WITHOUT true-rank information is charged
    # (the historical padded accounting — every slot billed as if r_max).
    k2: float = 0.0
    r_max: int = 0

    def __post_init__(self):
        # a rank-aware model must know what to bill rank-unknown requests:
        # without r_max they would be charged rank 1 (64x UNDER-billed for
        # a padded r_max=64 request) instead of the pessimistic fallback
        assert self.k2 <= 0 or self.r_max > 0, \
            "rank-aware MemoryModel (k2 > 0) requires r_max"

    def predict(self, total_batch: int) -> float:
        return self.k0 + self.k1 * total_batch * self.seq_len

    def fits(self, total_batch: int) -> bool:
        return self.predict(total_batch) <= self.capacity * self.safety_margin

    def max_batch(self) -> int:
        if self.k1 <= 0:
            return 1 << 20
        return max(int((self.capacity * self.safety_margin - self.k0)
                       / (self.k1 * self.seq_len)), 0)

    # ---- token-denominated interface (ragged slot widths) ------------------
    # M_hat is linear in TOKENS (B * L); when co-located slots disagree on
    # (b, seq), tokens = sum of b_z * seq_z is the sound budget unit — the
    # rows-based interface above assumes the fit-time seq_len throughout.
    def predict_tokens(self, tokens: float) -> float:
        return self.k0 + self.k1 * tokens

    def fits_tokens(self, tokens: float) -> bool:
        return self.predict_tokens(tokens) <= (self.capacity
                                               * self.safety_margin)

    # ---- rank-weighted interface (rank-local compute) ----------------------
    # With the rank-local grouped-GEMM path a slot's LoRA footprint is
    # proportional to b*seq*rank at its TRUE rank; ``rank_tokens`` is the
    # sum of that quantity over slots. k2 == 0 recovers the rank-neutral
    # token model exactly (every existing caller is unchanged).
    def predict_ranked(self, tokens: float, rank_tokens: float) -> float:
        return self.k0 + self.k1 * tokens + self.k2 * rank_tokens

    def fits_ranked(self, tokens: float, rank_tokens: float) -> bool:
        return self.predict_ranked(tokens, rank_tokens) <= (
            self.capacity * self.safety_margin)

    def charged_rank(self, lora_rank: Optional[int]) -> int:
        """The rank a request is billed at: its true rank when known,
        else the padded r_max (rank-masked accounting)."""
        if lora_rank:
            return lora_rank
        return self.r_max if self.r_max else 1


def fit_memory_model(points: Sequence[Tuple[int, float]], seq_len: int,
                     capacity: float, safety_margin: float = 0.9
                     ) -> MemoryModel:
    """OLS fit of peak-memory measurements: points = [(total_batch, bytes)]."""
    B = np.asarray([p[0] * seq_len for p in points], np.float64)
    M = np.asarray([p[1] for p in points], np.float64)
    A = np.stack([np.ones_like(B), B], axis=1)
    coef, *_ = np.linalg.lstsq(A, M, rcond=None)
    return MemoryModel(k0=float(coef[0]), k1=float(coef[1]),
                       seq_len=seq_len, capacity=capacity,
                       safety_margin=safety_margin)


@dataclasses.dataclass
class PendingJob:
    job_id: str
    per_adapter_batch: int
    lora_rank: int = 0        # TRUE rank; 0 = unknown (charged at r_max)


class IntraTaskScheduler:
    """Greedy admission/backfill over one executor's slots."""

    def __init__(self, mem: MemoryModel, max_slots: int):
        self.mem = mem
        self.max_slots = max_slots
        self.resident: Dict[str, int] = {}        # job_id -> b
        self.resident_ranks: Dict[str, int] = {}  # job_id -> true rank

    @property
    def total_batch(self) -> int:
        return sum(self.resident.values())

    def _rank_tokens(self) -> float:
        """Resident rank-weighted FLOP-tokens (b * seq * charged rank)."""
        return sum(b * self.mem.seq_len
                   * self.mem.charged_rank(self.resident_ranks.get(j))
                   for j, b in self.resident.items())

    def can_admit(self, b: int, rank: int = 0) -> bool:
        if len(self.resident) >= self.max_slots:
            return False
        if self.mem.k2 <= 0:
            return self.mem.fits(self.total_batch + b)
        rt = self._rank_tokens() + (b * self.mem.seq_len
                                    * self.mem.charged_rank(rank))
        return self.mem.fits_ranked((self.total_batch + b) * self.mem.seq_len,
                                    rt)

    def _admit(self, job: PendingJob) -> None:
        self.resident[job.job_id] = job.per_adapter_batch
        if job.lora_rank:
            self.resident_ranks[job.job_id] = job.lora_rank

    def admit_initial(self, queue: List[PendingJob]) -> List[PendingJob]:
        """Greedy decreasing-batch-size admission (paper §A.3). Returns the
        admitted jobs, removing them from ``queue`` in place."""
        admitted: List[PendingJob] = []
        for job in sorted(queue, key=lambda j: -j.per_adapter_batch):
            if self.can_admit(job.per_adapter_batch, job.lora_rank):
                self._admit(job)
                admitted.append(job)
        for j in admitted:
            queue.remove(j)
        return admitted

    def evict(self, job_id: str) -> None:
        del self.resident[job_id]
        self.resident_ranks.pop(job_id, None)

    def backfill(self, queue: List[PendingJob]) -> Optional[PendingJob]:
        """Admit the largest pending job the memory-model budget accepts.

        The historical same-batch-size fast path is gone: slots are ragged
        (the fused step packs per-slot row counts through the ragged
        grouped-GEMM path), so homogeneous packing buys nothing — the only
        constraint is the (rank-aware) §A.3 budget, which charges each
        job's TRUE rank when it is known instead of the padded r_max."""
        for j in sorted(queue, key=lambda j: -j.per_adapter_batch):
            if self.can_admit(j.per_adapter_batch, j.lora_rank):
                queue.remove(j)
                self._admit(j)
                return j
        return None


# The executor's per-slot admission/backfill policy is the same object —
# exported under the name the executor layer uses (§A.3 "executor slots").
ExecutorSlots = IntraTaskScheduler


# --------------------------------------------------------------------------
# Cross-task admission (shared-backbone co-location)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ColoRequest:
    """One task's demand on a shared replica: its concurrent-slot upper
    bound, per-adapter batch size, seq len, and TRUE adapter rank.
    ``seq_len=None`` falls back to the memory model's fit-time seq len
    (homogeneous-seq legacy callers); ``lora_rank=None`` means the rank is
    unknown and the task is charged at the model's padded r_max — the
    rank-masked accounting the rank-local path replaces. M_hat budgets
    slots * b * seq TOKENS plus k2 * rank-weighted FLOP-tokens."""
    name: str
    slots: int
    per_adapter_batch: int
    seq_len: Optional[int] = None
    lora_rank: Optional[int] = None

    def tokens(self, default_seq: int = 1) -> int:
        seq = self.seq_len if self.seq_len else default_seq
        return self.slots * self.per_adapter_batch * seq

    def rank_tokens(self, default_seq: int = 1, default_rank: int = 1) -> int:
        rank = self.lora_rank if self.lora_rank else default_rank
        return self.tokens(default_seq) * rank


def admit_cross_task(resident: Sequence[ColoRequest],
                     pending: Sequence[ColoRequest],
                     capacity_slots: int,
                     mem: Optional[MemoryModel] = None) -> List[str]:
    """§A.3 admission generalized across TASK boundaries: greedily admit
    pending tasks in decreasing per-slot FLOP-token width (b * seq * rank;
    ties broken by name for determinism) while the replica's slot capacity
    holds and the fitted memory model M_hat stays inside the safety
    margin. Tasks need NOT share a batch size, seq len, or rank — ragged
    slots fuse heterogeneous widths and the rank-local kernels fuse
    heterogeneous ranks in one step, so the only compatibility the key
    retains is (arch, gpus, loss kind).

    A rank-aware model (``mem.k2 > 0``) budgets rank-weighted FLOP-tokens
    at each task's TRUE rank; requests without rank information — and
    every request under a rank-neutral model — are charged the padded
    ``r_max``, which is exactly the historical Z*r_max accounting.

    ``resident`` are tasks already co-located on the replica (the host
    included); their ``slots`` should be *current future-use bounds*, so
    capacity freed by early exits is reclaimable the moment it frees.
    Returns the admitted task names, in admission order."""
    default_seq = mem.seq_len if mem is not None else 1
    default_rank = mem.charged_rank(None) if mem is not None else 1
    ranked = mem is not None and mem.k2 > 0
    used_slots = sum(r.slots for r in resident)
    used_tokens = sum(r.tokens(default_seq) for r in resident)
    used_rtok = sum(r.rank_tokens(default_seq, default_rank)
                    for r in resident)
    admitted: List[str] = []

    def width(r: ColoRequest) -> int:
        w = r.per_adapter_batch * (r.seq_len if r.seq_len else default_seq)
        if ranked:
            w *= r.lora_rank if r.lora_rank else default_rank
        return w

    for r in sorted(pending, key=lambda r: (-width(r), r.name)):
        if used_slots + r.slots > capacity_slots:
            continue
        tokens = used_tokens + r.tokens(default_seq)
        rtok = used_rtok + r.rank_tokens(default_seq, default_rank)
        if mem is not None and not mem.fits_ranked(tokens, rtok):
            continue
        admitted.append(r.name)
        used_slots += r.slots
        used_tokens = tokens
        used_rtok = rtok
    return admitted
