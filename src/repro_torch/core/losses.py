"""Per-slot losses for multi-adapter training.

The structural invariant that makes ALTO's slot training sound: the total
backward loss is a SUM of per-slot means (masked by ``active``), and slot
z's loss depends only on adapter z (the base is frozen), so each adapter's
gradient is exactly what it would be if trained alone — co-location changes
throughput, not optimization.

``dpo_loss`` keeps that shape for preference pairs: per slot, the
``-log sigmoid`` of the policy's margin over the frozen base model.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M

LOSS_KINDS = ("sft", "dpo")


def check_loss_kind(loss_kind: str) -> None:
    if loss_kind not in LOSS_KINDS:
        raise ValueError(f"unknown loss kind {loss_kind!r}")


def sft_loss(cfg: ModelConfig, params: Dict, lora: Dict, batch: Dict,
             active: torch.Tensor, remat: bool = True
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (total scalar for backward, per-slot mean NLL [Z] fp32).
    ``remat``: checkpoint every layer of a forward that records gradients.

    MoE adds ``router_aux_weight`` times the load-balance term to the
    total, unmasked by ``active``, as the JAX package does: it is a mean
    over token groups that may span slots. Sharded, each rank's forward
    returns its share of the term (``models/moe.py``: its tokens' router
    mass against the groups' top-1 shares counted over every data rank, on
    model rank 0 only), so the shares add up to the term once over the
    mesh and each rank's adapters take its gradient once."""
    h, aux, _ = M.forward(cfg, params, lora, batch["tokens"],
                          positions=batch.get("positions"),
                          modal_embeds=batch.get("modal_embeds"),
                          remat=remat)
    nll_sum, cnt = M.per_slot_xent(cfg, params, h, batch["labels"])
    per_slot = nll_sum / torch.clamp_min(cnt, 1.0)
    total = torch.sum(per_slot * active.float())
    if cfg.is_moe:
        total = total + cfg.moe.router_aux_weight * aux
    return total, per_slot


def _seq_logp(cfg: ModelConfig, params: Dict, lora: Dict,
              tokens: torch.Tensor, labels: torch.Tensor,
              remat: bool) -> torch.Tensor:
    """Per-slot sum of the labels' log-probabilities [Z] under ``lora``
    (the empty tree: the frozen base model)."""
    h, _, _ = M.forward(cfg, params, lora, tokens, remat=remat)
    nll_sum, _ = M.per_slot_xent(cfg, params, h, labels)
    return -nll_sum


def dpo_loss(cfg: ModelConfig, params: Dict, lora: Dict, batch: Dict,
             active: torch.Tensor, beta: float = 0.1, remat: bool = True
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Direct Preference Optimization over (chosen, rejected) pairs.

    batch: tokens_chosen/labels_chosen/tokens_rejected/labels_rejected,
    each [Z, b, S]. The REFERENCE policy is the frozen base model — the
    LoRA-free forward (the empty adapter tree) — so no reference copy is
    ever materialized. The reference forwards take no gradient and run
    under ``torch.no_grad()``: the same values, no graph kept, and no LoRA
    launch. As in the JAX package, the loss takes no MoE load-balance term.
    Sharded (``shardctx.spmd()``), each of the four forwards runs on this
    rank's slots (on a pod mesh its rows of them) under the plan, the
    per-slot sums are all-reduced over "model" and "pod" by
    ``per_slot_xent`` before the log-sigmoid, and the total covers this
    rank's slots (the step gathers the per-slot losses over "data").

    Returns (total scalar, per-slot mean -log sigmoid margin [Z])."""
    def seq_logp(lora_tree, which):
        return _seq_logp(cfg, params, lora_tree, batch[f"tokens_{which}"],
                         batch[f"labels_{which}"], remat)

    lp_c, lp_r = seq_logp(lora, "chosen"), seq_logp(lora, "rejected")
    with torch.no_grad():   # reference = base model (empty adapter set)
        ref_c, ref_r = seq_logp({}, "chosen"), seq_logp({}, "rejected")
    margin = beta * ((lp_c - ref_c) - (lp_r - ref_r))
    per_slot = -torch.log(torch.clamp(
        (1.0 / (1.0 + torch.exp(-margin))).float(), 1e-12, 1.0))
    total = torch.sum(per_slot * active.float())
    return total, per_slot


def dpo_reward_accuracy(margin_per_slot: torch.Tensor) -> torch.Tensor:
    return (margin_per_slot > 0).float()


LOSSES = {"sft": sft_loss, "dpo": dpo_loss}
