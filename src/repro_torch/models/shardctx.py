"""Sharding-hint context (the port of ``repro.models.shardctx``).

Model code is written once; distribution is injected by the launcher
through this context. ``constrain(x, kind)`` returns ``x`` when no policy
is installed (single-device runs and tests) and ``policy(x, kind)``
otherwise: the launcher's policy (``launch/partitioning.py``) resolves the
sharding the reference's ``jax.lax.with_sharding_constraint`` would apply,
records it, and on a one-rank mesh returns the same tensor (no tensor
moves). On a real multi-rank mesh the policy carries the step's
``SpmdPlan`` (``spmd()``), through which the model issues the collectives
of tensor and sequence parallelism on its local shards. Policies are
divisibility-aware: a constraint whose sharded dim does not divide by the
mesh axis size degrades to replicated on that dim.

The state is thread-local, as the reference's. A layer recomputed in the
backward pass (remat) may run in autograd's own thread, so the model takes
the installed state with ``current()`` and re-installs it around the
recompute (``installed``): the recompute sees the forward's hints.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

import torch

_state = threading.local()


def _policy() -> Optional[Callable]:
    return getattr(_state, "policy", None)


def get_hint(name: str, default=None):
    """Policy-supplied tracing hints (e.g. 'model_size', 'opt_level')."""
    hints = getattr(_state, "hints", None)
    if hints is None:
        return default
    return hints.get(name, default)


def constrain(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Annotate activation ``x`` with the sharding for logical role
    ``kind``.

    kinds used by the model code:
      residual      [Z, b, S, d]  residual stream between blocks
      attn_qkv      [Z, b, S, H, hd] per-head projections
      ffn_hidden    [Z, b, S, ff]
      logits        [Z, b, S, V]
      moe_expert    [E, G, C, d]  expert-major dispatched tokens
      weight:<name> a frozen base weight (gathered over the adapter axis)
      dims:a,b,...  explicit per-dim mesh axes
    """
    p = _policy()
    if p is None:
        return x
    return p(x, kind)


@contextlib.contextmanager
def sharding_policy(policy: Callable, hints: Optional[dict] = None):
    """Install ``policy(x, kind) -> x`` for the duration of the context."""
    prev = _policy()
    prev_hints = getattr(_state, "hints", None)
    _state.policy = policy
    _state.hints = hints or getattr(policy, "hints", None)
    try:
        yield
    finally:
        _state.policy = prev
        _state.hints = prev_hints


def spmd():
    """The installed policy's ``SpmdPlan`` (``launch/partitioning.py``):
    None unless the step runs sharded on a real multi-rank mesh."""
    return getattr(_policy(), "spmd", None)


def current():
    """The installed (policy, hints): None, None without a policy."""
    return _policy(), getattr(_state, "hints", None)


@contextlib.contextmanager
def installed(state):
    """Re-install a ``current()`` state for the duration of the context
    (nothing to install when its policy is None)."""
    policy, hints = state
    if policy is None:
        yield
        return
    with sharding_policy(policy, hints):
        yield
