"""The §A.3+k2 linear memory model the serving frontend admits against.

A copy of ``MemoryModel`` from ``repro.sched.intra_task`` (the port imports
nothing of the JAX package): ``M_hat = k0 + k1 * tokens + k2 *
rank_tokens`` must stay within ``capacity * safety_margin``. The
scheduler's admission and profiling functions come with a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


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
