"""Naive-attention oracle for the flash-attention kernel: the port of
``src/repro/kernels/flash_attention/ref.py``.

Layout: fused batch-heads B = Z*b*H; q: [B, Sq, hd]; k, v: [B, Sk, hd].
Causal alignment: query i attends to keys j with j <= i + (Sk - Sq) (the
suffix alignment; Sq == Sk is plain causal); ``window > 0`` also needs
j > i + (Sk - Sq) - window. fp32 scores and softmax; a fully masked row's
NaN probabilities are zeroed (``isfinite``), so its output is 0.
"""
from __future__ import annotations

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    B, Sq, hd = q.shape
    Sk = k.shape[1]
    scale = hd ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    vis = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        vis &= kpos <= qpos
    if window > 0:
        vis &= kpos > qpos - window
    s = torch.where(vis, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isfinite(p), p, 0.0)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
