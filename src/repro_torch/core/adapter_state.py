"""Slot-stacked adapter runtime state + host-side slot management.

Fixed ``Z`` device slots hold adapters with static shapes (r_max-padded), so
the early-exit controller can admit/evict/rotate jobs with in-place tensor
updates. Rotated-out jobs are snapshotted to host (params + optimizer
moments + step count) and restored bit-exactly when they continue training
(paper §5.2: survivors "carry over their optimizer states and loss
histories").

Port of ``repro.core.adapter_state`` on device tensors. Where the JAX
package returns new arrays, ``SlotManager`` writes the slot in place. The
per-slot rank, width and seq len have host mirrors (``slot_rank``,
``slot_b``, ``slot_seq``), so the per-step dispatch never reads the card.

Layer contract — SlotSnapshot bit-exactness: ``snapshot()`` followed by
``restore()`` reproduces the job's device state exactly (adapter params,
AdamW moments, step count, slot width/rank), on ANY slot of ANY same-shape
replica. Together with task-local lifecycle state (lane-indexed batch
streams, monitors, init generators) this is the primitive that makes
slot-level preemption and cross-replica migration invisible to the loss
trajectory.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import lora as LORA
from repro_torch.models.common import resolve_device
from repro_torch.optim import adamw


@dataclasses.dataclass
class SlotSnapshot:
    """Host copy of one job's device state (for warmup rotation).

    ``lora``/``mu``/``nu`` are ``[L, ...]`` single-adapter trees of CPU
    tensors. ``per_adapter_batch``/``seq_len`` record the job's slot WIDTH
    — slots are ragged (variable-width) since co-located tasks may train
    with different batch sizes — so a restore re-establishes the exact
    same token footprint the job had before rotation."""
    job_id: str
    lora: Dict
    mu: Dict
    nu: Dict
    count: int
    rank: int
    per_adapter_batch: int = 0
    seq_len: int = 0


def _x_slot(tree: Dict, slot: int) -> Dict:
    """Host copy of one slot of a ``{target: {leaf: [L, Z, ...]}}`` tree."""
    return {t: {m: x[:, slot].to("cpu", copy=True) for m, x in ab.items()}
            for t, ab in tree.items()}


def _i_slot(tree: Dict, slot: int, sub: Dict) -> None:
    """Write a single-slot tree into slot ``slot`` in place."""
    with torch.no_grad():
        for t, ab in tree.items():
            for m, x in ab.items():
                x[:, slot].copy_(sub[t][m])


class SlotManager:
    """Owns the device tensors for one executor's Z adapter slots.

    Slots are tagged with the *task* that owns them (``slot_tasks``) so one
    frozen-backbone replica can host adapter slots belonging to different
    tasks concurrently (cross-task co-location).

    Slot WIDTH is a per-slot property (``slot_b``/``slot_seq``): co-located
    tasks may train with different per-adapter batch sizes and seq lens
    (ragged slots); ``slot_tokens`` is what admission budgets against.
    Tensors live on the card unless ``device`` says otherwise."""

    def __init__(self, cfg: ModelConfig, Z: int, target_shapes: Dict,
                 device=None):
        self.cfg = cfg
        self.Z = Z
        self.target_shapes = target_shapes
        self.device = dev = resolve_device(device)
        self.ranks = torch.zeros((Z,), dtype=torch.int32, device=dev)
        self.active = torch.zeros((Z,), dtype=torch.int32, device=dev)
        self.hp = adamw.SlotHParams.broadcast(Z, device=dev)
        L, r = cfg.num_layers, cfg.lora.r_max
        # every slot starts empty: rank 0, so A and B are all zero
        self.lora = {
            t: {"A": torch.zeros((L, Z, din, r), dtype=torch.float32,
                                 device=dev),
                "B": torch.zeros((L, Z, r, dout), dtype=torch.float32,
                                 device=dev)}
            for t, (din, dout) in target_shapes.items()
            if t in cfg.lora.targets}
        self.opt_state = adamw.init_state(self.lora, Z)
        self.slot_jobs: List[Optional[str]] = [None] * Z
        self.slot_tasks: List[Optional[str]] = [None] * Z
        self.slot_b: List[int] = [0] * Z        # per-slot batch width
        self.slot_seq: List[int] = [0] * Z      # per-slot seq len
        # host mirror of ``ranks``: the per-step rank-local dispatch and
        # the §A.3 rank accounting must not sync a device tensor
        self.slot_rank: List[int] = [0] * Z

    def _set_hp(self, slot: int, tc: TrainConfig) -> None:
        self.hp = self.hp.replace_slot(
            slot, lr=tc.learning_rate, wd=tc.weight_decay,
            beta1=tc.beta1, beta2=tc.beta2, grad_clip=tc.grad_clip)

    # ---- admission ---------------------------------------------------------
    def admit(self, slot: int, job_id: str, tc: TrainConfig,
              gen: torch.Generator, task: Optional[str] = None,
              b: int = 0, seq: int = 0) -> None:
        """Fresh job into a slot: new init drawn from ``gen`` (a generator
        on this manager's device), zeroed moments, job's hparams, and the
        job's own (b, seq) width."""
        assert self.slot_jobs[slot] is None, f"slot {slot} occupied"
        rank = min(tc.lora_rank, self.cfg.lora.r_max)
        one = LORA.init_lora_tree(gen, self.cfg, 1,
                                  torch.tensor([rank], dtype=torch.int32),
                                  self.target_shapes)
        _i_slot(self.lora, slot, {t: {m: x[:, 0] for m, x in ab.items()}
                                  for t, ab in one.items()})
        adamw.reset_slot(self.opt_state, slot)
        self.ranks[slot] = rank
        self.active[slot] = 1
        self._set_hp(slot, tc)
        self.slot_jobs[slot] = job_id
        self.slot_tasks[slot] = task
        self.slot_b[slot] = b or tc.per_adapter_batch
        self.slot_seq[slot] = seq
        self.slot_rank[slot] = rank

    def restore(self, slot: int, snap: SlotSnapshot, tc: TrainConfig,
                task: Optional[str] = None) -> None:
        """Rotate a snapshotted job back in (bit-exact continuation,
        including its slot width)."""
        assert self.slot_jobs[slot] is None, f"slot {slot} occupied"
        _i_slot(self.lora, slot, snap.lora)
        _i_slot(self.opt_state.mu, slot, snap.mu)
        _i_slot(self.opt_state.nu, slot, snap.nu)
        self.opt_state.count[slot] = snap.count
        self.ranks[slot] = snap.rank
        self.active[slot] = 1
        self._set_hp(slot, tc)
        self.slot_jobs[slot] = snap.job_id
        self.slot_tasks[slot] = task
        self.slot_b[slot] = snap.per_adapter_batch or tc.per_adapter_batch
        self.slot_seq[slot] = snap.seq_len
        self.slot_rank[slot] = snap.rank

    # ---- eviction ----------------------------------------------------------
    def snapshot(self, slot: int) -> SlotSnapshot:
        job_id = self.slot_jobs[slot]
        assert job_id is not None
        return SlotSnapshot(
            job_id=job_id,
            lora=_x_slot(self.lora, slot),
            mu=_x_slot(self.opt_state.mu, slot),
            nu=_x_slot(self.opt_state.nu, slot),
            count=int(self.opt_state.count[slot]),
            rank=self.slot_rank[slot],
            per_adapter_batch=self.slot_b[slot],
            seq_len=self.slot_seq[slot],
        )

    def evict(self, slot: int) -> None:
        """Drop a job: zero params + moments, deactivate (paper §5.2:
        'evicted adapters' parameters and optimizer states are discarded')."""
        with torch.no_grad():
            LORA.zero_slot(self.lora, slot)
        adamw.reset_slot(self.opt_state, slot)
        self.active[slot] = 0
        self.ranks[slot] = 0
        self.slot_jobs[slot] = None
        self.slot_tasks[slot] = None
        self.slot_b[slot] = 0
        self.slot_seq[slot] = 0
        self.slot_rank[slot] = 0

    # ---- queries -----------------------------------------------------------
    def free_slots(self) -> List[int]:
        return [i for i, j in enumerate(self.slot_jobs) if j is None]

    def slot_tokens(self, slot: int) -> int:
        """Token footprint of one slot per fused step (b * seq)."""
        return self.slot_b[slot] * max(self.slot_seq[slot], 1)

    def occupied_tokens(self) -> int:
        """Total tokens per fused step across occupied slots — the ragged
        quantity the §A.3 memory model budgets (M_hat is token-linear)."""
        return sum(self.slot_tokens(i) for i, j in
                   enumerate(self.slot_jobs) if j is not None)

    def mixed_rank(self, r_max: int) -> bool:
        """True iff some occupied slot's true rank is below r_max — the
        executor's per-step dispatch predicate for the rank-local LoRA
        path (a homogeneous full-rank mix has no dead rank tile to
        skip)."""
        return any(j is not None and self.slot_rank[i] < r_max
                   for i, j in enumerate(self.slot_jobs))

    def occupied_rank_tokens(self) -> int:
        """Total rank-weighted FLOP-tokens per fused step (sum of
        b_z * seq_z * rank_z over occupied slots) — what the rank-aware
        §A.3 budget charges instead of tokens * r_max."""
        return sum(self.slot_tokens(i) * self.slot_rank[i]
                   for i, j in enumerate(self.slot_jobs) if j is not None)

    def occupied(self) -> Dict[str, int]:
        return {j: i for i, j in enumerate(self.slot_jobs) if j is not None}

    def occupied_of(self, task: Optional[str]) -> Dict[str, int]:
        """{job_id: slot} for the slots tagged with ``task``."""
        return {j: i for i, j in enumerate(self.slot_jobs)
                if j is not None and self.slot_tasks[i] == task}

    def adapter_of(self, job_id: str) -> Dict:
        return _x_slot(self.lora, self.occupied()[job_id])

    def adapter_at(self, slot: int) -> Dict:
        """Host copy of one slot's adapter params (task-tag agnostic — the
        shared executor addresses slots by index, never by job id)."""
        assert self.slot_jobs[slot] is not None, f"slot {slot} empty"
        return _x_slot(self.lora, slot)

    def adapters_of(self, task: Optional[str]) -> Dict[str, Dict]:
        """{job_id: [L, ...] adapter sub-tree} for one task's (possibly
        non-contiguous) slots on a shared executor."""
        occ = self.occupied_of(task)
        return {j: _x_slot(self.lora, occ[j]) for j in sorted(occ)}
