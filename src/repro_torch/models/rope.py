"""Rotary position embeddings: standard RoPE and Qwen2-VL M-RoPE.

M-RoPE [arXiv:2409.12191]: the head_dim/2 rotary frequencies are split into
three sections (temporal, height, width); each section consumes the matching
component of a 3-part position id. Text tokens carry (t,t,t) so M-RoPE
degrades exactly to RoPE on text.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import RoPEConfig


def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str = "cpu") -> torch.Tensor:
    """Inverse frequencies, shape [head_dim // 2] (fp32)."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def rope_angles(positions: torch.Tensor, head_dim: int,
                cfg: RoPEConfig) -> torch.Tensor:
    """Rotation angles.

    positions: [..., S] int for RoPE, or [3, ..., S] for M-RoPE.
    returns angles [..., S, head_dim // 2] fp32.
    """
    inv = rope_freqs(head_dim, cfg.theta, positions.device)
    if not cfg.is_mrope:
        return positions[..., None].float() * inv
    sections = cfg.mrope_sections
    assert positions.shape[0] == 3, "M-RoPE expects [3, ..., S] positions"
    assert sum(sections) == head_dim // 2, (sections, head_dim)
    parts = []
    off = 0
    for comp in range(3):
        sec = sections[comp]
        parts.append(positions[comp][..., None].float() * inv[off:off + sec])
        off += sec
    return torch.cat(parts, dim=-1)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate halves. x: [..., S, H, hd]; angles: [..., S, hd//2]."""
    dt = x.dtype
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    c = torch.cos(angles)[..., None, :]   # broadcast over heads
    s = torch.sin(angles)[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(dt)


def text_positions(batch_shape: Tuple[int, ...], seq_len: int,
                   cfg: RoPEConfig, offset=0,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    """Default positions: ``arange(seq_len) + offset`` broadcast to
    ``(*batch_shape, seq_len)``; the (t,t,t) stack ``(3, *batch_shape,
    seq_len)`` for M-RoPE."""
    pos = torch.arange(seq_len, dtype=torch.int32, device=device) + offset
    pos = pos.expand(*batch_shape, seq_len)
    if cfg.is_mrope:
        pos = pos[None].expand(3, *batch_shape, seq_len)
    return pos
