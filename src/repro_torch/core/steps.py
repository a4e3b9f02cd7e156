"""Step builders: train / eval / prefill / serve / lane prefill /
join+decode.

Each ``make_*`` returns a plain function (PyTorch runs eagerly; the JAX
package ``jit``-compiles the same functions). The base ``params`` are
frozen: gradients flow only through the slot-stacked LoRA tree. Serving
takes no gradients, and its callers run the serving steps under
``torch.inference_mode()``; the train step's LoRA and optimizer tensors
must not be inference tensors (autograd cannot save those).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import losses as LS
from repro_torch.core import lora as LORA
from repro_torch.models import model as M
from repro_torch.models import shardctx
from repro_torch.optim import adamw


@contextlib.contextmanager
def _bind(batch: Dict):
    """Pop ``slot_rows``/``slot_ranks`` off ``batch`` (a copy) and bind
    them around the loss; yields the remaining batch."""
    batch = dict(batch)
    slot_rows = batch.pop("slot_rows", None)
    slot_ranks = batch.pop("slot_ranks", None)
    with LORA.ragged_rows(slot_rows), LORA.slot_ranks(slot_ranks):
        yield batch


def lora_grads(cfg: ModelConfig, params: Dict, lora: Dict, batch: Dict,
               active: torch.Tensor, *, loss_kind: str = "sft",
               remat: bool = True) -> Tuple[torch.Tensor, Dict]:
    """(per-slot loss [Z], gradient tree) of the summed active per-slot
    loss with respect to the LoRA leaves only (the backbone is frozen).
    ``batch`` may carry ``slot_rows``/``slot_ranks`` as ``make_train_step``
    describes; ``remat`` checkpoints every layer of the forward. Sharded
    (``shardctx.spmd()``), each gradient is all-reduced over "model" only:
    the slots, and so the adapters, of another data rank are not here; on a
    pod mesh then over "pod" (each pod rank's is its own rows' share)."""
    LS.check_loss_kind(loss_kind)
    keys = [(t, m) for t in sorted(lora) for m in sorted(lora[t])]
    leaves = {t: {m: x.detach().requires_grad_(True)
                  for m, x in ab.items()} for t, ab in lora.items()}
    # per-layer views taken once: indexing a stacked [L, ...] leaf once per
    # layer would hand autograd L full-size gradients per leaf to sum (L^2
    # traffic); unbind's backward stacks the L layer gradients once
    layered = {t: {m: x.unbind(0) for m, x in ab.items()}
               for t, ab in leaves.items()}
    with _bind(batch) as b:
        total, per_slot = LS.LOSSES[loss_kind](cfg, params, layered, b,
                                               active, remat=remat)
        flat = torch.autograd.grad(total, [leaves[t][m] for t, m in keys])
    grads: Dict[str, Dict[str, torch.Tensor]] = {t: {} for t in lora}
    for (t, m), g in zip(keys, flat):
        grads[t][m] = g
    sp = shardctx.spmd()
    if sp is not None:          # partial sums over "model"; none over "data"
        grads = sp.reduce_grads(grads)
    return per_slot.detach(), grads


def make_train_step(cfg: ModelConfig, *, loss_kind: str = "sft",
                    remat: bool = True) -> Callable:
    """train_step(params, lora, opt_state, hp, active, ranks, batch)
    -> (lora', opt_state', metrics{per_slot_loss[Z], grad_norm[Z]}).

    ``batch`` may carry ``slot_rows`` ([Z] int32, valid token rows per
    slot in flattened b*seq units): ragged slot widths — LoRA deltas are
    then computed over only each slot's own rows (zero delta and zero
    gradient on padding rows). It may also carry ``slot_ranks`` ([Z]
    int32, per-slot TRUE adapter ranks): LoRA deltas then take the
    rank-local kernels, which confine each slot to its first ranks[z]
    rank rows/columns (dead rank tiles skip their work, the padded rank
    region gets exactly zero gradient, and the post-step rank re-mask is
    redundant). ``lora'`` and ``opt_state'`` are the given tensors,
    updated in place (``adamw.apply_updates``).

    ``loss_kind`` is "sft" or "dpo" (``core/losses.py``; a DPO batch
    carries ``tokens_chosen``/``labels_chosen``/``tokens_rejected``/
    ``labels_rejected``). ``remat`` (the default) rematerializes the
    forward, one checkpoint per layer (``models.model.forward``);
    ``remat=False`` keeps every layer's activations for the backward, as
    the reference's ``steps.py:26-49``.

    Sharded on a real multi-rank mesh (``launch/steps_dist.py``), the
    step updates this data rank's slots, with the clipping norms taken
    after the gradients' all-reduce over "model" (and "pod"), and the
    metrics are gathered over "data" to all Z slots. The pod ranks take the
    same update of the same adapters: they stay bitwise equal."""
    LS.check_loss_kind(loss_kind)

    def train_step(params, lora, opt_state, hp: adamw.SlotHParams,
                   active: torch.Tensor, ranks: torch.Tensor, batch: Dict):
        per_slot, grads = lora_grads(cfg, params, lora, batch, active,
                                     loss_kind=loss_kind, remat=remat)
        norms = adamw.per_slot_global_norm(grads)
        new_lora, new_opt = adamw.apply_updates(
            lora, grads, opt_state, hp, active,
            rank_masker=lambda t: LORA.mask_lora_tree(t, ranks,
                                                      cfg.lora.r_max))
        sp = shardctx.spmd()
        if sp is not None:
            per_slot, norms = sp.gather_metrics(per_slot, norms)
        return new_lora, new_opt, {"per_slot_loss": per_slot,
                                   "grad_norm": norms}

    return train_step


def make_eval_step(cfg: ModelConfig, *, loss_kind: str = "sft") -> Callable:
    """eval_step(params, lora, active, batch) -> per-slot val loss [Z].

    ``batch`` may carry ``slot_ranks`` like the train step (eval rides the
    same rank-local LoRA path as training on mixed-rank replicas). Runs
    under ``torch.no_grad()``. Sharded on a real multi-rank mesh
    (``launch/steps_dist.py``), it runs the train step's forward on this
    data rank's slots and returns all Z losses, gathered over "data"."""
    LS.check_loss_kind(loss_kind)

    def eval_step(params, lora, active, batch):
        with torch.no_grad(), _bind(batch) as b:
            _, per_slot = LS.LOSSES[loss_kind](cfg, params, lora, b, active)
            sp = shardctx.spmd()
            if sp is not None:
                per_slot, = sp.gather_metrics(per_slot)
        return per_slot

    return eval_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """prefill_step(params, lora, cache, batch) -> (last-token logits,
    cache).

    Sharded on a real multi-rank mesh (``launch/steps_dist.py``), the
    logits are those of this rank's slots and lanes ([Z/d, b/p, V]), over
    the
    whole vocabulary on every model rank: the last token's hidden state
    comes from the model rank whose sequence block holds it
    (``SpmdPlan.last_row``) and a vocabulary-parallel unembedding's logits
    are gathered over "model"; the cache is this rank's shard
    (``partitioning.serve_cache_specs``), what its heads write of its slots
    written in place."""

    def prefill_step(params, lora, cache, batch):
        h, _, cache = M.forward(cfg, params, lora, batch["tokens"],
                                positions=batch.get("positions"),
                                modal_embeds=batch.get("modal_embeds"),
                                cache=cache)
        sp = shardctx.spmd()
        last = h[:, :, -1] if sp is None else sp.last_row(h)
        return M._unembed(cfg, params, last), cache

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """serve_step(params, lora, cache, tokens[Z,b], active=None)
    -> (logits, cache). ``active`` ([Z, b] bool, per-lane caches) freezes
    idle lanes bitwise while live lanes decode.

    Sharded on a real multi-rank mesh, ``tokens`` are this rank's block
    (its data rank's slots, its pod rank's lanes of them) or a DTensor of
    all of them, the cache's positions and ``active`` arrive whole, and the
    step returns this rank's lanes' logits ([Z/d, b/p, V], the whole
    vocabulary) and the cache's local shards with the positions updated
    whole (``models.model.decode_step``)."""

    def serve_step(params, lora, cache, tokens, active=None):
        return M.decode_step(cfg, params, lora, cache, tokens, active=active)

    return serve_step


def make_lane_prefill_step(cfg: ModelConfig) -> Callable:
    """lane_prefill(params, lora, cache, tokens[Z,b,P], lane_mask[Z,b],
    plens[Z,b]) -> (last-token logits, cache) — block prefill of a subset
    of lanes of a live per-lane cache; every other lane bitwise
    untouched."""

    def lane_prefill(params, lora, cache, tokens, lane_mask, plens):
        return M.prefill_lanes(cfg, params, lora, cache, tokens, lane_mask,
                               plens)

    return lane_prefill


def make_join_decode_step(cfg: ModelConfig) -> Callable:
    """join_decode(params, lora, cache, tokens[Z,b,P], lane_mask[Z,b],
    plens[Z,b], cur[Z,b], active[Z,b]) -> (prefill_greedy, logits,
    decode_greedy, cache) — block-prefill the masked lanes AND run one
    fused decode step over (active | joined) lanes. Each joiner's first
    token is its greedy prefill argmax, chosen on the device and fed
    straight into the decode (no host round-trip). Greedy joiners only."""

    def join_decode(params, lora, cache, tokens, lane_mask, plens, cur,
                    active):
        p_logits, cache = M.prefill_lanes(cfg, params, lora, cache, tokens,
                                          lane_mask, plens)
        p_greedy = torch.argmax(p_logits, dim=-1)
        cur = torch.where(lane_mask, p_greedy.to(cur.dtype), cur)
        live = torch.logical_or(active, lane_mask)
        logits, cache = M.decode_step(cfg, params, lora, cache, cur,
                                      active=live)
        return p_greedy, logits, torch.argmax(logits, dim=-1), cache

    return join_decode
