"""Differentiable linear scan: the counterpart of the JAX package's
``src/repro/kernels/linear_scan/ops.py:21-46`` custom VJP.

The forward is the linear-scan kernel (``linear_scan.py``; its plain
version for CPU tensors). The backward is autograd through the plain core
``ref.linear_scan_ref`` on the saved inputs, exactly the JAX package's
split (its backward is ``jax.vjp`` of the jnp core; it has no backward
kernel): not a fallback, but the same function's gradient. The plain core
checkpoints each chunk while gradients are recorded, so the backward holds
one chunk's ``[B, C, C, K]`` pair tensors at a time.

A cotangent may be None: training uses y and discards the final state.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.linear_scan import linear_scan as LS
from repro_torch.kernels.linear_scan import ref


class _LinearScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, logw, bonus, s0, decay_on_query, chunk):
        ctx.save_for_backward(q, k, v, logw, bonus, s0)
        ctx.decay_on_query, ctx.chunk = decay_on_query, chunk
        ctx.set_materialize_grads(False)
        return LS.linear_scan(q, k, v, logw, bonus=bonus,
                              decay_on_query=decay_on_query,
                              initial_state=s0, chunk=chunk)

    @staticmethod
    def backward(ctx, dy, dstate):
        saved = ctx.saved_tensors
        need = [n and t is not None
                for t, n in zip(saved, ctx.needs_input_grad[:6])]
        grads = [None] * 6
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(n)
                   for t, n in zip(saved, need)]
            outs = ref.linear_scan_ref(
                *ins[:4], bonus=ins[4], decay_on_query=ctx.decay_on_query,
                initial_state=ins[5], chunk=ctx.chunk)
            pairs = [(o, c) for o, c in zip(outs, (dy, dstate))
                     if c is not None]
            wrt = [i for i, n in enumerate(need) if n]
            if pairs and wrt:
                got = torch.autograd.grad(
                    [o for o, _ in pairs], [ins[i] for i in wrt],
                    [c for _, c in pairs], allow_unused=True)
                for i, g in zip(wrt, got):
                    grads[i] = g
        return (*grads, None, None)


def linear_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                logw: torch.Tensor, *,
                bonus: Optional[torch.Tensor] = None,
                decay_on_query: bool = False,
                initial_state: Optional[torch.Tensor] = None,
                chunk: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arguments and results (``linear_scan.linear_scan``),
    differentiable in q, k, v, logw, the bonus and the initial state."""
    return _LinearScan.apply(q, k, v, logw, bonus, initial_state,
                             bool(decay_on_query), int(chunk))
