"""Plain PyTorch version of the chunked linear-scan kernel: the port of
``src/repro/kernels/linear_scan/ref.py:linear_scan_ref`` (the JAX package's
pure-jnp core of ``models/linear_scan.py`` run per row), written over the
kernel's flat ``[B, S, K/V]`` layout (B = Z*b*H fused rows) so that every
row runs at once. It computes the same function as the JAX core, step for
step: per chunk, the within-chunk cumulative log-decay L (<= 0), the state
term ``(q . exp(Lq)) @ S_prev``, the exact log-space pair term
``P[t,i] = sum_k q[t,k] k[i,k] exp(Lq[t,k] - L[i,k])`` over visible pairs
(exponent -1e30 elsewhere), the bonus on the diagonal, ``y = y_state + P v``
and the state update ``S = exp(L_end) . S + (k . exp(L_end - L))^T v``.
All math fp32; y in q's dtype, the state fp32.

While gradients are recorded, each chunk's step is checkpointed
(``torch.utils.checkpoint``): the backward recomputes one chunk's
``[B, C, C, K]`` pair tensors at a time instead of keeping every chunk's,
as the JAX core does under its ``opt_level >= 2`` hint
(``src/repro/models/linear_scan.py:52``, ``:129-130``); the numbers are the
same.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30


def _chunk_step(state: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, lw: torch.Tensor,
                bonus: Optional[torch.Tensor], decay_on_query: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk of every row. state [B,K,V]; q, k, lw [B,C,K]; v [B,C,V];
    bonus [B,K] or None; all fp32. Returns (new state, y [B,C,V])."""
    C = q.shape[1]
    L = torch.cumsum(lw, dim=1)                  # [B,C,K], <= 0
    Lq = L if decay_on_query else F.pad(L, (0, 0, 1, 0))[:, :-1]
    y_state = torch.bmm(q * torch.exp(Lq), state)
    t = torch.arange(C, device=q.device)
    visible = (t[:, None] >= t[None, :]) if decay_on_query else (
        t[:, None] > t[None, :])
    dd = Lq[:, :, None, :] - L[:, None, :, :]    # [B,C,C,K]
    dd = torch.where(visible[..., None], dd, NEG_INF)
    P = (q[:, :, None, :] * k[:, None, :, :] * torch.exp(dd)).sum(-1)
    if bonus is not None:
        diag = (q * bonus[:, None, :] * k).sum(-1)   # [B,C]
        P = P + diag[:, :, None] * torch.eye(C, device=q.device)
    y = y_state + torch.bmm(P, v)
    L_end = L[:, -1:, :]                          # [B,1,K]
    k_scaled = k * torch.exp(L_end - L)
    new_state = (state * torch.exp(L_end[:, 0])[:, :, None]
                 + torch.bmm(k_scaled.transpose(1, 2), v))
    return new_state, y


def linear_scan_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    logw: torch.Tensor, *,
                    bonus: Optional[torch.Tensor] = None,
                    decay_on_query: bool = False,
                    initial_state: Optional[torch.Tensor] = None,
                    chunk: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, logw: [B,S,K]; v: [B,S,V]; bonus: [B,K] or None;
    initial_state: [B,K,V] or None. Returns (y [B,S,V] in q's dtype,
    state [B,K,V] fp32). The chunk is ``min(chunk, S)``, lowered until it
    divides S."""
    B, S, K = q.shape
    V = v.shape[-1]
    C = min(chunk, S)
    while S % C:
        C -= 1
    qf, kf, vf, lw = (x.float() for x in (q, k, v, logw))
    state = (torch.zeros((B, K, V), dtype=torch.float32, device=q.device)
             if initial_state is None else initial_state.float())
    bon = bonus.float() if bonus is not None else None
    grads = torch.is_grad_enabled() and any(
        x is not None and x.requires_grad
        for x in (q, k, v, logw, bonus, initial_state))
    ys = []
    for c in range(0, S, C):
        args = (state, qf[:, c:c + C], kf[:, c:c + C], vf[:, c:c + C],
                lw[:, c:c + C], bon, decay_on_query)
        if grads:
            state, y = checkpoint(_chunk_step, *args, use_reentrant=False)
        else:
            state, y = _chunk_step(*args)
        ys.append(y)
    return torch.cat(ys, dim=1).to(q.dtype), state
