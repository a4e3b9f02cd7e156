"""Rotary position embeddings (standard RoPE; the dense family's only kind).

M-RoPE (Qwen2-VL) belongs to the VLM family, which is not ported yet.
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
    """Rotation angles: positions [..., S] int -> [..., S, head_dim // 2]
    fp32."""
    if cfg.is_mrope:
        raise NotImplementedError("M-RoPE (VLM family) is not ported yet")
    inv = rope_freqs(head_dim, cfg.theta, positions.device)
    return positions[..., None].float() * inv


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
    ``(*batch_shape, seq_len)``."""
    if cfg.is_mrope:
        raise NotImplementedError("M-RoPE (VLM family) is not ported yet")
    pos = torch.arange(seq_len, dtype=torch.int32, device=device) + offset
    return pos.expand(*batch_shape, seq_len)
