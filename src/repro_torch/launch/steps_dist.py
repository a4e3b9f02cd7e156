"""Distributed step builders: core steps + activation sharding policy (the
port of ``repro.launch.steps_dist``).

The sharding policy (``launch/partitioning.py``) is installed through
``models/shardctx`` for the duration of each call, so the same model code
runs with no policy in tests and annotated under the launcher. The wrapped
step takes DTensors or plain tensors: a DTensor argument is replaced by its
local shard (the kernels take plain tensors; the step's in-place updates
land in the local shards).

On a one-rank mesh the shards are whole and nothing moves. On a real
multi-rank ("data", "model") mesh the train and eval steps run sharded: the
policy's ``SpmdPlan`` reads the parameters' placements and the batch's
global shape at each call and issues the collectives
(``launch/collectives.py``); ``partitioning.check_sharded`` refuses, with
``NotImplementedError``, what the sharded steps do not run (the DPO loss,
the pod axis, scan heads that do not split over "model"), and the prefill
and serve steps raise on such a mesh (they need the caches sharded). The
eval step is the train step's forward with no backward: every family the
train step runs (dense, MoE, ssm, hybrid, vlm, audio), the same schedule,
and every rank returns all Z per-slot losses, gathered over "data".
Attention whose heads do not split over "model" runs whole on every model
rank (``partitioning.whole_heads``). One schedule serves every opt level:
the levels change only the recorded decisions and hints, and the numbers
stay equal.
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


def _wrap(cfg: ModelConfig, mesh, fn: Callable, step: str,
          seq_shard: bool = True, opt_level: int = 0) -> Callable:
    """``fn``, the ``step`` builder's step, under the policy of ``mesh``;
    on a real multi-rank mesh a call refuses the steps that do not run
    sharded (``partitioning.SHARDED_STEPS``), and the plan runs attention
    whole where ``cfg``'s heads do not split."""
    policy = PT.activation_policy(mesh, seq_shard=seq_shard,
                                  opt_level=opt_level,
                                  step_kind=STEP_KINDS[step])
    plan = policy.spmd
    if plan is not None:
        plan.attn_whole = PT.whole_heads(cfg, plan.m)

    def wrapped(*args, **kw):
        if plan is not None:
            if step not in PT.SHARDED_STEPS:
                raise NotImplementedError(
                    f"sharded execution of the {step} step (make_{step}_"
                    f"step) is not ported: it needs the K/V and recurrent "
                    f"caches sharded ({PT.SHARDED_QUEUE})")
            # (params, lora, opt, hp, active, ranks, batch)
            plan.bind(args[0], kw.get("batch", args[-1]))
        args, kw = PT.local(list(args)), PT.local(kw)
        try:
            with shardctx.sharding_policy(policy):
                return fn(*args, **kw)
        finally:
            if plan is not None:
                plan.end()

    wrapped.policy = policy
    return wrapped


def make_train_step(cfg: ModelConfig, mesh, *, loss_kind="sft",
                    remat: bool = True, seq_shard: bool = True,
                    opt_level: int = 0) -> Callable:
    if PT._real_multi_rank(mesh):
        PT.check_sharded(cfg, mesh, loss_kind)
    return _wrap(cfg, mesh, S.make_train_step(cfg, loss_kind=loss_kind,
                                              remat=remat),
                 "train", seq_shard, opt_level)


def make_eval_step(cfg: ModelConfig, mesh, *, opt_level: int = 0,
                   **kw) -> Callable:
    if PT._real_multi_rank(mesh):
        PT.check_sharded(cfg, mesh, kw.get("loss_kind", "sft"))
    return _wrap(cfg, mesh, S.make_eval_step(cfg, **kw), "eval",
                 opt_level=opt_level)


def make_prefill_step(cfg: ModelConfig, mesh, *,
                      opt_level: int = 0) -> Callable:
    return _wrap(cfg, mesh, S.make_prefill_step(cfg), "prefill",
                 opt_level=opt_level)


def make_serve_step(cfg: ModelConfig, mesh, *,
                    opt_level: int = 0) -> Callable:
    return _wrap(cfg, mesh, S.make_serve_step(cfg), "serve",
                 opt_level=opt_level)
