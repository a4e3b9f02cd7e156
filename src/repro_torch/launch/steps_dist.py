"""Distributed step builders: core steps + activation sharding policy (the
port of ``repro.launch.steps_dist``).

The sharding policy (``launch/partitioning.py``) is installed through
``models/shardctx`` for the duration of each call, so the same model code
runs with no policy in tests and annotated under the launcher. The wrapped
step takes DTensors or plain tensors: a DTensor argument is replaced by its
local shard (the kernels take plain tensors; the step's in-place updates
land in the local shards).

On a one-rank mesh the shards are whole and nothing moves. On a real
multi-rank ("data", "model") or ("pod", "data", "model") mesh every step
runs sharded: the policy's ``SpmdPlan`` reads the parameters' placements
and the global shape of the call's tokens at each call and issues the
collectives (``launch/collectives.py``); "pod" splits each slot's b rows,
and the adapters, their AdamW state and the base weights are replicated
over it. The sharded steps run what the reference's GSPMD steps run, but
for what ``ROADMAP.md`` records: ``partitioning.check_sharded`` refuses,
with ``NotImplementedError``, axes in another order and a family outside
``SHARDED_FAMILIES``, and ``SpmdPlan.bind`` ragged slot rows on a pod
axis (the reference cannot lay them out). Every step runs every family
(dense, MoE, ssm, hybrid, vlm, audio); the train and eval steps with either
loss (SFT or DPO); the eval step is the train step's forward with no
backward, on the same schedule, and every rank returns all Z per-slot
losses, gathered over "data". Ragged slot rows ([Z] ``slot_rows``, whole
or laid out as the batch's slots) are cut to the data rank's slots.
Attention whose heads do not split over "model" runs whole on every model
rank (``partitioning.whole_heads``), and so does a scan branch whose heads
do not (``partitioning.whole_scan``). The
prefill and serve steps take the cache as ``serve_cache_specs`` lays it out
(slots over "data"; K/V by KV heads over "model", or whole where the heads
do not split; RWKV's and Mamba's scan states by heads, Mamba's conv buffer
by its inner block, or the three whole where the scan heads do not split;
RWKV's token-shift rows and the positions whole; lanes
over "pod") and a serve step's ``active`` whole, its [Z, b] tokens a
DTensor or this rank's block of them; a cache laid out any other way raises
``ValueError`` (``partitioning.check_serve_cache``). Each returns its (data,
pod) rank's slots' lanes' logits over the whole vocabulary and the cache's
local shards. One schedule serves every opt level: the levels change only the
recorded decisions and hints, and the numbers stay equal.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.core import steps as S
from repro_torch.launch import partitioning as PT
from repro_torch.models import shardctx


# each step builder's name and the activation policy's step kind for it
STEP_KINDS = {"train": "train", "eval": "prefill", "prefill": "prefill",
              "serve": "decode"}
# the argument of each step whose shape a sharded call binds, (name,
# position): train(params, lora, opt, hp, active, ranks, batch),
# eval(params, lora, active, batch), prefill(params, lora, cache, batch),
# serve(params, lora, cache, tokens, active=None)
BOUND_ARG = {"train": ("batch", 6), "eval": ("batch", 3),
             "prefill": ("batch", 3), "serve": ("tokens", 3)}


def _wrap(cfg: ModelConfig, mesh, fn: Callable, step: str,
          seq_shard: bool = True, opt_level: int = 0) -> Callable:
    """``fn``, the ``step`` builder's step, under the policy of ``mesh``;
    on a real multi-rank mesh each call binds the plan to its own
    arguments (``BOUND_ARG``), a prefill or serve step's cache is checked
    against its layout, a batch's ragged slot rows are cut to the data
    rank's slots, and the plan runs attention and the scan branch whole
    where ``cfg``'s heads do not split."""
    policy = PT.activation_policy(mesh, seq_shard=seq_shard,
                                  opt_level=opt_level,
                                  step_kind=STEP_KINDS[step])
    plan = policy.spmd
    if plan is not None:
        plan.attn_whole = PT.whole_heads(cfg, plan.m)
        plan.scan_whole = PT.whole_scan(cfg, plan.m)
    name, at = BOUND_ARG[step]

    def wrapped(*args, **kw):
        if plan is not None:
            if step in ("prefill", "serve"):
                PT.check_serve_cache(cfg, mesh, kw["cache"] if "cache" in kw
                                     else args[2])
            x = kw[name] if name in kw else args[at]
            if name == "tokens":
                plan.bind(args[0], x)
            else:
                plan.bind(args[0], x.get("tokens", x.get("tokens_chosen")),
                          x)
        args, kw = PT.local(list(args)), PT.local(kw)
        if plan is not None and name == "batch":
            if name in kw:
                kw[name] = plan.slot_vectors(kw[name])
            else:
                args[at] = plan.slot_vectors(args[at])
        try:
            with shardctx.sharding_policy(policy):
                return fn(*args, **kw)
        finally:
            if plan is not None:
                plan.end()

    wrapped.policy = policy
    return wrapped


def _checked(cfg: ModelConfig, mesh, step: str) -> None:
    if PT._real_multi_rank(mesh):
        PT.check_sharded(cfg, mesh, step)


def make_train_step(cfg: ModelConfig, mesh, *, loss_kind="sft",
                    remat: bool = True, seq_shard: bool = True,
                    opt_level: int = 0) -> Callable:
    _checked(cfg, mesh, "train")
    return _wrap(cfg, mesh, S.make_train_step(cfg, loss_kind=loss_kind,
                                              remat=remat),
                 "train", seq_shard, opt_level)


def make_eval_step(cfg: ModelConfig, mesh, *, opt_level: int = 0,
                   **kw) -> Callable:
    _checked(cfg, mesh, "eval")
    return _wrap(cfg, mesh, S.make_eval_step(cfg, **kw), "eval",
                 opt_level=opt_level)


def make_prefill_step(cfg: ModelConfig, mesh, *,
                      opt_level: int = 0) -> Callable:
    _checked(cfg, mesh, "prefill")
    return _wrap(cfg, mesh, S.make_prefill_step(cfg), "prefill",
                 opt_level=opt_level)


def make_serve_step(cfg: ModelConfig, mesh, *,
                    opt_level: int = 0) -> Callable:
    _checked(cfg, mesh, "serve")
    return _wrap(cfg, mesh, S.make_serve_step(cfg), "serve",
                 opt_level=opt_level)
