"""Differentiable grouped LoRA over the CUDA kernels: dense, ragged and
rank-local.

``grouped_lora(x, A, B, scale, y_base=None)`` == scale*(x@A)@B (+ y_base),
every slot at full rank; ``ragged_grouped_lora(x, A, B, scale, rows,
y_base=None)`` the same with slot z confined to its first rows[z] token
rows (dead rows: zero delta, y_base passed through, zero gradients);
``ranklocal_grouped_lora(x, A, B, scale, ranks, rows=None, y_base=None)``
the same with slot z also confined to its first ranks[z] rank columns of
A / rows of B.

Each is a ``torch.autograd.Function``, the counterpart of the JAX package's
custom VJPs (``src/repro/kernels/grouped_lora/ops.py:112-170`` dense,
``:174-270`` ragged, ``:303-347`` rank-local): the forward runs ``xa``
then ``sb_add`` and caches S in x's dtype (paper §6.1, "the forward caches
intermediate S"); the backward rounds dy to x's dtype and runs ``ds``,
then ``dx``, ``da`` and ``db``. ``scale``, ``ranks`` and ``rows`` get no
gradient; ``y_base`` gets dy. On CPU tensors each wrapper takes its plain
version, so the Functions compute the same functions there.

``dx`` runs only when x needs a gradient: in a training step that is every
LoRA projection except those reading the embedding output directly (the
first layer's q/k/v), whose input hangs off no differentiable leaf.

The JAX wrapper's padding to TPU tiles is gone (the kernels mask their own
edges), and so is its ``_concrete_min`` dispatch of concrete full-rank
``ranks`` to the dense kernels: here the ranks would be a tensor on the
card, and reading them back to the host in every call would cost one sync
per projection (224 per step), while the jitted JAX steps, whose ranks are
traced, never take it. The choice between the three Functions is made once
per step on the host, by the executor (``SlotManager.mixed_rank`` binds
ranks, ``_assemble`` rows), as in the JAX package: bound ranks take the
rank-local Function, bound rows alone the ragged one, no binding the dense
one. The three give bitwise one
result where they meet (full rank; rows = T), so the choice never moves a
loss. Each takes ``plan=None`` (``autotune.TilePlan``), as the reference's
``ops.py:155,252,364`` do, for its forward and backward launches: a tile
plan moves no bit either.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.grouped_lora import grouped_lora as GL
from repro_torch.kernels.grouped_lora.autotune import TilePlan
from repro_torch.kernels.grouped_lora import ragged as RG
from repro_torch.kernels.grouped_lora import ranklocal as RL


def _scale_tensor(scale: torch.Tensor | float, x: torch.Tensor
                  ) -> torch.Tensor:
    """The [Z] fp32 scale the kernels read (the model passes a float)."""
    if isinstance(scale, torch.Tensor):
        return scale
    return torch.full((x.shape[0],), float(scale), dtype=torch.float32,
                      device=x.device)


class _GroupedLoRA(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, A, B, scale, y_base, plan):
        s = GL.xa(x, A, plan=plan)
        y = GL.sb_add(s, B, scale, y_base, plan=plan)
        ctx.save_for_backward(x, A, B, scale, s)
        ctx.has_base, ctx.plan = y_base is not None, plan
        return y

    @staticmethod
    def backward(ctx, dy):
        x, A, B, scale, s = ctx.saved_tensors
        need_x, need_a, need_b = ctx.needs_input_grad[:3]
        dy = dy.to(x.dtype).contiguous()
        plan = ctx.plan
        dx = da = db = None
        if need_x or need_a:
            ds = GL.ds(dy, B, scale, plan=plan)
            if need_x:
                dx = GL.dx(ds, A, plan=plan)
            if need_a:
                da = GL.da(x, ds, plan=plan)
        if need_b:
            db = GL.db(s, dy, scale, plan=plan)
        return dx, da, db, None, (dy if ctx.has_base else None), None


def grouped_lora(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                 scale: torch.Tensor | float,
                 y_base: Optional[torch.Tensor] = None, *,
                 plan: Optional[TilePlan] = None) -> torch.Tensor:
    """x: [Z,T,din]; A: [Z,din,r] and B: [Z,r,dout] fp32 masters (rounded
    to x's dtype inside the kernels); scale: float or [Z] fp32; ``plan``: a
    tile plan (``autotune``; None = the default) for the forward and
    backward launches. Returns [Z,T,dout] in x's dtype, differentiable in
    x, A, B and y_base."""
    return _GroupedLoRA.apply(x.contiguous(), A.contiguous(), B.contiguous(),
                              _scale_tensor(scale, x), y_base, plan)


class _RaggedLoRA(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, A, B, scale, rows, y_base, plan):
        s = RG.xa(x, A, rows, plan=plan)
        y = RG.sb_add(s, B, scale, rows, y_base, plan=plan)
        ctx.save_for_backward(x, A, B, scale, rows, s)
        ctx.has_base, ctx.plan = y_base is not None, plan
        return y

    @staticmethod
    def backward(ctx, dy):
        x, A, B, scale, rows, s = ctx.saved_tensors
        need_x, need_a, need_b = ctx.needs_input_grad[:3]
        dy = dy.to(x.dtype).contiguous()
        plan = ctx.plan
        dx = da = db = None
        if need_x or need_a:
            ds = RG.ds(dy, B, scale, rows, plan=plan)
            if need_x:
                dx = RG.dx(ds, A, rows, plan=plan)
            if need_a:
                da = RG.da(x, ds, rows, plan=plan)
        if need_b:
            db = RG.db(s, dy, scale, rows, plan=plan)
        return (dx, da, db, None, None, (dy if ctx.has_base else None),
                None)


def ragged_grouped_lora(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                        scale: torch.Tensor | float, rows: torch.Tensor,
                        y_base: Optional[torch.Tensor] = None, *,
                        plan: Optional[TilePlan] = None) -> torch.Tensor:
    """x: [Z,T,din]; A: [Z,din,r] and B: [Z,r,dout] fp32 masters (rounded
    to x's dtype inside the kernels); scale: float or [Z] fp32; rows: [Z]
    int32; ``plan`` as ``grouped_lora``'s. Returns [Z,T,dout] in x's
    dtype, differentiable in x, A, B and y_base; rows >= rows[z] of slot z
    get a zero delta and zero gradients."""
    return _RaggedLoRA.apply(x.contiguous(), A.contiguous(), B.contiguous(),
                             _scale_tensor(scale, x), rows, y_base, plan)


class _RankLocalLoRA(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, A, B, scale, ranks, rows, y_base, plan):
        s = RL.xa(x, A, rows, ranks, plan=plan)
        y = RL.sb_add(s, B, scale, rows, ranks, y_base, plan=plan)
        ctx.save_for_backward(x, A, B, scale, ranks, rows, s)
        ctx.has_base, ctx.plan = y_base is not None, plan
        return y

    @staticmethod
    def backward(ctx, dy):
        x, A, B, scale, ranks, rows, s = ctx.saved_tensors
        need_x, need_a, need_b = ctx.needs_input_grad[:3]
        dy = dy.to(x.dtype).contiguous()
        plan = ctx.plan
        dx = da = db = None
        if need_x or need_a:
            ds = RL.ds(dy, B, scale, rows, ranks, plan=plan)
            if need_x:
                dx = RL.dx(ds, A, rows, ranks, plan=plan)
            if need_a:
                da = RL.da(x, ds, rows, ranks, plan=plan)
        if need_b:
            db = RL.db(s, dy, scale, rows, ranks, plan=plan)
        return (dx, da, db, None, None, None,
                (dy if ctx.has_base else None), None)


def ranklocal_grouped_lora(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                           scale: torch.Tensor | float, ranks: torch.Tensor,
                           rows: Optional[torch.Tensor] = None,
                           y_base: Optional[torch.Tensor] = None, *,
                           plan: Optional[TilePlan] = None
                           ) -> torch.Tensor:
    """x: [Z,T,din]; A: [Z,din,r] and B: [Z,r,dout] fp32 masters (rounded
    to x's dtype inside the kernels); scale: float or [Z] fp32;
    ranks/rows: [Z] int32; ``plan`` as ``grouped_lora``'s. Returns
    [Z,T,dout] in x's dtype, differentiable in x, A, B and y_base."""
    return _RankLocalLoRA.apply(x.contiguous(), A.contiguous(),
                                B.contiguous(), _scale_tensor(scale, x),
                                ranks, rows, y_base, plan)
