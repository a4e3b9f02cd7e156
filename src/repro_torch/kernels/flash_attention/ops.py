"""Differentiable flash attention: the counterpart of the JAX package's
``src/repro/kernels/flash_attention/ops.py:16-33`` custom VJP.

The forward is the flash kernel (``flash_attention.py``; its plain version
for CPU tensors). The backward is autograd through the plain oracle
``ref.flash_attention_ref`` on the saved q, k, v, exactly the JAX package's
split (its backward is ``jax.vjp`` of the same oracle): not a fallback, but
the same function's gradient. It recomputes the [B, Sq, Sk] fp32 scores;
a flash backward kernel is later work.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.kernels.flash_attention import ref


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return FA.flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, do):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_(n)
                       for t, n in zip(saved, need))
            out = ref.flash_attention_ref(q, k, v, causal=ctx.causal,
                                          window=ctx.window)
            wrt = [t for t, n in zip((q, k, v), need) if n]
            grads = iter(torch.autograd.grad(out, wrt, do))
        return (*(next(grads) if n else None for n in need), None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B,Sq,hd]; k, v: [B,Sk,hd] -> [B,Sq,hd], differentiable in q, k
    and v."""
    return _FlashAttention.apply(q, k, v, bool(causal), int(window))
