"""Per-slot losses for multi-adapter training.

The structural invariant that makes ALTO's slot training sound: the total
backward loss is a SUM of per-slot means (masked by ``active``), and slot
z's loss depends only on adapter z (the base is frozen), so each adapter's
gradient is exactly what it would be if trained alone — co-location changes
throughput, not optimization.

The JAX package's DPO loss (with its ``PairSlotBatcher``) is not ported
yet.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M

LOSS_KINDS = ("sft",)


def check_loss_kind(loss_kind: str) -> None:
    if loss_kind == "dpo":
        raise NotImplementedError("loss_kind 'dpo' is not ported yet")
    if loss_kind not in LOSS_KINDS:
        raise ValueError(f"unknown loss kind {loss_kind!r}")


def sft_loss(cfg: ModelConfig, params: Dict, lora: Dict, batch: Dict,
             active: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (total scalar for backward, per-slot mean NLL [Z] fp32)."""
    h, _, _ = M.forward(cfg, params, lora, batch["tokens"],
                        positions=batch.get("positions"))
    nll_sum, cnt = M.per_slot_xent(cfg, params, h, batch["labels"])
    per_slot = nll_sum / torch.clamp_min(cnt, 1.0)
    total = torch.sum(per_slot * active.float())
    return total, per_slot
