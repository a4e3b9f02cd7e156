"""Online greedy intra-task scheduler (paper §7.1, §A.3).

Copied from ``repro.sched.intra_task`` (the port imports nothing of the
JAX package): the linear memory model ``M_hat = k0 + k1 * tokens + k2 *
rank_tokens``, which must stay within ``capacity * safety_margin`` — the
serving frontend and the executor's admission both budget against it —
and the greedy admission/backfill policy over one executor's slots
(``IntraTaskScheduler``, exported to the executor as ``ExecutorSlots``).
Admit pending jobs greedily in decreasing batch-size order while M_hat
stays within the safety margin; slots are ragged, so mixed batch sizes
co-train freely. The memory-model fit, profiling and cross-task admission
come with the service slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


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
