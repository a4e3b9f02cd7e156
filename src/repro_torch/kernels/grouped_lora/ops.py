"""Rank-local grouped LoRA forward over the two CUDA kernels.

``ranklocal_grouped_lora(x, A, B, scale, ranks, rows=None, y_base=None)``
== scale*(x@A)@B (+ y_base) with slot z confined to its first ranks[z]
rank columns of A / rows of B (and its first rows[z] token rows).

Forward only: serving runs under ``torch.inference_mode()``; the
``torch.autograd.Function`` with the dS/dX/dA/dB kernels comes with the
training slice. The JAX wrapper's padding to TPU tiles is gone (the
kernels mask their own edges), and so is its ``_concrete_min`` dispatch
of full-rank calls to the dense kernels: PyTorch always knows the ranks,
so mirroring it would send an all-full-rank pool to dense kernels this
slice does not port, while the JAX serving step (ranks traced under jit)
always takes the rank-local path — as this function does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.grouped_lora import ranklocal as RL


def ranklocal_grouped_lora(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                           scale: torch.Tensor | float, ranks: torch.Tensor,
                           rows: Optional[torch.Tensor] = None,
                           y_base: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """x: [Z,T,din]; A: [Z,din,r] and B: [Z,r,dout] fp32 masters (rounded
    to x's dtype inside the kernels); scale: float or [Z] fp32;
    ranks/rows: [Z] int32. Returns [Z,T,dout] in x's dtype."""
    s = RL.xa(x, A, rows, ranks)
    return RL.sb_add(s, B, scale, rows, ranks, y_base)
