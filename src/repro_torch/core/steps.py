"""Serving steps: prefill / serve / lane prefill / join+decode.

Each ``make_*`` returns a plain function (PyTorch runs eagerly; the JAX
package ``jit``-compiles the same functions). The base ``params`` are
frozen and serving takes no gradients: callers run the steps under
``torch.inference_mode()``. The training and eval steps come with the
training slice.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """prefill_step(params, lora, cache, batch) -> (last-token logits,
    cache)."""

    def prefill_step(params, lora, cache, batch):
        h, _, cache = M.forward(cfg, params, lora, batch["tokens"],
                                positions=batch.get("positions"),
                                cache=cache)
        return M._unembed(cfg, params, h[:, :, -1]), cache

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """serve_step(params, lora, cache, tokens[Z,b], active=None)
    -> (logits, cache). ``active`` ([Z, b] bool, per-lane caches) freezes
    idle lanes bitwise while live lanes decode."""

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
