"""Distributed step builders: core steps + activation sharding policy (the
port of ``repro.launch.steps_dist``).

The sharding policy (``launch/partitioning.py``) is installed through
``models/shardctx`` for the duration of each call, so the same model code
runs with no policy in tests and annotated under the launcher. The wrapped
step takes DTensors or plain tensors: a DTensor argument is replaced by its
local shard (the kernels take plain tensors; the step's in-place updates
land in the local shards).

On a one-rank mesh the shards are whole and nothing moves. On a real
multi-rank ("data", "model") mesh the train step runs sharded: the policy's
``SpmdPlan`` reads the parameters' placements and the batch's global shape
at each call and issues the collectives (``launch/collectives.py``);
``partitioning.check_sharded`` refuses, with ``NotImplementedError``, what
the sharded step does not run (the vlm and audio families, the DPO loss,
the pod axis, scan heads that do not split over "model"), and the eval,
prefill and serve steps raise on such a mesh. Attention whose heads do not
split over "model" runs whole on every model rank
(``partitioning.whole_heads``). One schedule serves every
opt level: the levels change only the recorded decisions and hints, and
the numbers stay equal.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.core import steps as S
from repro_torch.launch import partitioning as PT
from repro_torch.models import shardctx


def _wrap(mesh, fn: Callable, seq_shard: bool = True, opt_level: int = 0,
          step_kind: str = "train") -> Callable:
    policy = PT.activation_policy(mesh, seq_shard=seq_shard,
                                  opt_level=opt_level, step_kind=step_kind)
    plan = policy.spmd

    def wrapped(*args, **kw):
        if plan is not None:       # (params, lora, opt, hp, active, ranks,
            plan.bind(args[0], kw.get("batch", args[-1]))   # batch)
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
    step = _wrap(mesh, S.make_train_step(cfg, loss_kind=loss_kind,
                                         remat=remat), seq_shard, opt_level,
                 "train")
    plan = step.policy.spmd
    if plan is not None:
        plan.attn_whole = PT.whole_heads(cfg, plan.m)
    return step


def make_eval_step(cfg: ModelConfig, mesh, *, opt_level: int = 0,
                   **kw) -> Callable:
    return _wrap(mesh, S.make_eval_step(cfg, **kw), True, opt_level,
                 "prefill")


def make_prefill_step(cfg: ModelConfig, mesh, *,
                      opt_level: int = 0) -> Callable:
    return _wrap(mesh, S.make_prefill_step(cfg), True, opt_level, "prefill")


def make_serve_step(cfg: ModelConfig, mesh, *,
                    opt_level: int = 0) -> Callable:
    return _wrap(mesh, S.make_serve_step(cfg), True, opt_level, "decode")
