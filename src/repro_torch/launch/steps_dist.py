"""Distributed step builders: core steps + activation sharding policy (the
port of ``repro.launch.steps_dist``).

The sharding policy (``launch/partitioning.py``) is installed through
``models/shardctx`` for the duration of each call, so the same model code
runs with no policy in tests and annotated under the launcher. The wrapped
step takes DTensors or plain tensors: a DTensor argument is replaced by its
local shard (the kernels take plain tensors; on a one-rank mesh the shard
is the whole tensor, so the step's in-place updates land in the DTensor).
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

    def wrapped(*args, **kw):
        args, kw = PT.local(list(args)), PT.local(kw)
        with shardctx.sharding_policy(policy):
            return fn(*args, **kw)

    wrapped.policy = policy
    return wrapped


def make_train_step(cfg: ModelConfig, mesh, *, loss_kind="sft",
                    remat: bool = True, seq_shard: bool = True,
                    opt_level: int = 0) -> Callable:
    return _wrap(mesh, S.make_train_step(cfg, loss_kind=loss_kind,
                                         remat=remat), seq_shard, opt_level,
                 "train")


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
