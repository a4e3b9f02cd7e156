"""Dense transformer block with multi-adapter LoRA hooks.

The block operates on slot-major activations ``x: [Z, b, S, d]`` (Z =
adapter slots). Base weights are slot-shared and frozen; LoRA pairs are
slot-stacked. The other families (MoE, RWKV, hybrid) are not ported yet.

KV caches are written IN PLACE, and only for the lanes allowed to write
(``ctx["write_mask"]``, [Z, b] bool; None = every lane): the JAX package
instead builds a whole new cache with a ``jnp.where`` select and restores
idle lanes afterwards, which at full width copies the whole cache every
step. Lanes outside the mask keep their cache bitwise untouched.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lora import proj
from repro_torch.models.attention import attention
from repro_torch.models.common import he_init, rms_norm, swiglu
from repro_torch.models.rope import apply_rope


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.is_moe:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense only)")


# ---------------------------------------------------------------------------
# Target shapes (for LoRA init)
# ---------------------------------------------------------------------------

def attn_target_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, int]]:
    d = cfg.d_model
    return {
        "q_proj": (d, cfg.q_dim), "k_proj": (d, cfg.kv_dim),
        "v_proj": (d, cfg.kv_dim), "o_proj": (cfg.q_dim, d),
    }


def mlp_target_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, int]]:
    d = cfg.d_model
    return {"gate_proj": (d, cfg.d_ff), "up_proj": (d, cfg.d_ff),
            "down_proj": (cfg.d_ff, d)}


def target_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, int]]:
    _require_dense(cfg)
    return {**attn_target_shapes(cfg), **mlp_target_shapes(cfg)}


# ---------------------------------------------------------------------------
# Init (one layer; model.py stacks over L)
# ---------------------------------------------------------------------------

def init_layer_params(gen: torch.Generator, cfg: ModelConfig,
                      dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    _require_dense(cfg)
    d, dev = cfg.d_model, gen.device
    return {
        "attn_norm": torch.ones((d,), dtype=torch.float32, device=dev),
        "mlp_norm": torch.ones((d,), dtype=torch.float32, device=dev),
        "q_proj": he_init(gen, (d, cfg.q_dim), d, dtype),
        "k_proj": he_init(gen, (d, cfg.kv_dim), d, dtype),
        "v_proj": he_init(gen, (d, cfg.kv_dim), d, dtype),
        "o_proj": he_init(gen, (cfg.q_dim, d), cfg.q_dim, dtype),
        "gate_proj": he_init(gen, (d, cfg.d_ff), d, dtype),
        "up_proj": he_init(gen, (d, cfg.d_ff), d, dtype),
        "down_proj": he_init(gen, (cfg.d_ff, d), cfg.d_ff, dtype),
    }


# ---------------------------------------------------------------------------
# In-place cache writes
# ---------------------------------------------------------------------------

def _write_lanes(c: torch.Tensor, new: torch.Tensor, index: torch.Tensor,
                 mask: Optional[torch.Tensor]) -> None:
    """Per-lane decode write: lane (z, b) stores its one new row at its
    own ``index[z, b]`` — only where ``mask`` allows and the index is in
    range. A lane that may not write stores back the row it already holds,
    so the write is one scatter with no host sync. c: [Z,b,Sc,KV,hd];
    new: [Z,b,KV,hd]; index/mask: [Z,b]."""
    Z, b, Sc = c.shape[:3]
    ok = index < Sc
    if mask is not None:
        ok = ok & mask
    zi = torch.arange(Z, device=c.device)[:, None]
    bi = torch.arange(b, device=c.device)[None, :]
    idx = index.long().clamp(0, Sc - 1)
    row = torch.where(ok[..., None, None], new.to(c.dtype), c[zi, bi, idx])
    c[zi, bi, idx] = row


def _write_span(c: torch.Tensor, new: torch.Tensor, start,
                mask: Optional[torch.Tensor]) -> None:
    """Write ``new`` ([Z,b,S,KV,hd]) at cache positions start..start+S-1
    of every lane in ``mask`` (None = all). ``start`` is a Python int
    (prefill) or a 0-d tensor (global-position decode)."""
    S = new.shape[2]
    new = new.to(c.dtype)
    if isinstance(start, int):
        view = c[:, :, start:start + S]
        if mask is not None:
            new = torch.where(mask[:, :, None, None, None], new, view)
        view.copy_(new)
        return
    if mask is not None:
        raise ValueError("a lane mask needs a per-lane cache")
    pos = torch.arange(S, device=c.device) + start.long()
    c.index_copy_(2, pos, new)


# ---------------------------------------------------------------------------
# Sublayers
# ---------------------------------------------------------------------------

def _lp(lora: Dict, t: str, layer: int):
    return (lora[t]["A"][layer], lora[t]["B"][layer]) if t in lora else None


def cfg_q_chunk(cfg: ModelConfig, S: int) -> int:
    if S <= 512:
        return S
    for c in (512, 256, 128):
        if S % c == 0:
            return c
    return S


def attn_sublayer(x: torch.Tensor, p: Dict, lora: Dict, layer: int,
                  cfg: ModelConfig, angles: torch.Tensor,
                  q_pos: torch.Tensor, *,
                  cache: Optional[Dict] = None,
                  k_pos: Optional[torch.Tensor] = None,
                  kv_valid_len: Optional[torch.Tensor] = None,
                  write_index=None,
                  write_mask: Optional[torch.Tensor] = None,
                  window: int = 0, scale=2.0) -> torch.Tensor:
    """x: [Z,b,S,d] (normed) -> attention output [Z,b,S,d]; the layer's
    K/V are written into ``cache`` in place when ``write_index`` is set."""
    Z, b, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim

    q = proj(x, p["q_proj"], _lp(lora, "q_proj", layer), scale)
    k = proj(x, p["k_proj"], _lp(lora, "k_proj", layer), scale)
    v = proj(x, p["v_proj"], _lp(lora, "v_proj", layer), scale)
    q = apply_rope(q.reshape(Z, b, S, H, hd), angles)
    k = apply_rope(k.reshape(Z, b, S, KV, hd), angles)
    v = v.reshape(Z, b, S, KV, hd)

    if cache is not None and write_index is not None:
        ck, cv = cache["k"], cache["v"]
        if isinstance(write_index, torch.Tensor) and write_index.dim() == 2:
            # per-lane decode: each (Z, b) stream writes at its own index
            if S != 1:
                raise ValueError("per-lane cache writes are decode-only")
            _write_lanes(ck, k[:, :, 0], write_index, write_mask)
            _write_lanes(cv, v[:, :, 0], write_index, write_mask)
        else:
            _write_span(ck, k, write_index, write_mask)
            _write_span(cv, v, write_index, write_mask)
        k_all, v_all = ck, cv
        kp = k_pos if k_pos is not None else torch.arange(
            ck.shape[2], dtype=torch.int32, device=x.device)
    else:
        k_all, v_all = k, v
        kp = k_pos if k_pos is not None else q_pos

    out = attention(q, k_all, v_all, q_pos, kp, window=window,
                    q_chunk=cfg_q_chunk(cfg, S), kv_valid_len=kv_valid_len)
    out = out.reshape(Z, b, S, H * hd)
    return proj(out, p["o_proj"], _lp(lora, "o_proj", layer), scale)


def mlp_sublayer(x: torch.Tensor, p: Dict, lora: Dict, layer: int,
                 scale=2.0) -> torch.Tensor:
    h = swiglu(proj(x, p["gate_proj"], _lp(lora, "gate_proj", layer), scale),
               proj(x, p["up_proj"], _lp(lora, "up_proj", layer), scale))
    return proj(h, p["down_proj"], _lp(lora, "down_proj", layer), scale)


def transformer_block(cfg: ModelConfig, x: torch.Tensor, p: Dict,
                      lora: Dict, layer: int, ctx: Dict[str, Any]
                      ) -> torch.Tensor:
    """One dense layer. ``p`` holds the layer's base weights, ``lora`` the
    stacked tree (indexed at ``layer``), ``ctx`` the rope angles,
    positions, window and this layer's cache (``ctx["cache"]``)."""
    scale = cfg.lora.scale_for_rank(0)
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    x = x + attn_sublayer(
        h, p, lora, layer, cfg, ctx["angles"], ctx["q_pos"],
        cache=ctx.get("cache"), k_pos=ctx.get("k_pos"),
        kv_valid_len=ctx.get("kv_valid_len"),
        write_index=ctx.get("write_index"),
        write_mask=ctx.get("write_mask"), window=ctx.get("window", 0),
        scale=scale)
    h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    return x + mlp_sublayer(h, p, lora, layer, scale)
