"""Per-family blocks with multi-adapter LoRA hooks: the transformer block
(dense; MoE, with the routed experts in place of the MLP; and Hymba's
``hybrid``: attention and a Mamba branch side by side) and the RWKV-6 block
(``ssm``); ``apply_block`` picks one by family and returns the new
activations and the layer's MoE load-balance term (None for the other
families).

Every block operates on slot-major activations ``x: [Z, b, S, d]`` (Z =
adapter slots). Base weights are slot-shared and frozen; LoRA pairs are
slot-stacked. The ``vlm`` and ``audio`` families take the dense branch, as
in the JAX package: their modality stubs feed embeddings and positions to
the forward, not to the blocks.

Caches — the attention K/V, the RWKV and Mamba recurrent states — are
written IN PLACE, and only for the lanes allowed to write
(``ctx["write_mask"]``, [Z, b] bool; None = every lane): the JAX package
instead builds a whole new cache with a ``jnp.where`` select and restores
idle lanes afterwards, which at full width copies the whole cache every
step. Lanes outside the mask keep their cache bitwise untouched.

The sharding hints of ``models/shardctx`` sit where the reference's do
(``blocks.py:111-122,173,217-251``): the weight names of every projection,
the opt-level >= 2 sequence-sharded q/k/v, ``attn_qkv``, ``ffn_hidden`` and
the residual constraints before and after each add. With no policy
installed they return their inputs.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lora import proj
from repro_torch.models.attention import attention
from repro_torch.models.common import he_init, lora_at, rms_norm, swiglu
from repro_torch.models import moe as MOE
from repro_torch.models.mamba import (init_mamba_params, mamba_block,
                                      mamba_target_shapes)
from repro_torch.models.rope import apply_rope
from repro_torch.models import shardctx
from repro_torch.models.rwkv import (init_rwkv_layer, rwkv_channel_mix,
                                     rwkv_target_shapes, rwkv_time_mix)
from repro_torch.models.shardctx import constrain, get_hint


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
    if cfg.family == "ssm":
        return rwkv_target_shapes(cfg)
    shapes = dict(attn_target_shapes(cfg))
    if cfg.family == "hybrid":
        shapes.update(mamba_target_shapes(cfg))
    if not cfg.is_moe:   # experts frozen: attention-only LoRA
        shapes.update(mlp_target_shapes(cfg))
    return shapes


# ---------------------------------------------------------------------------
# Init (one layer; model.py stacks over L)
# ---------------------------------------------------------------------------

def init_layer_params(gen: torch.Generator, cfg: ModelConfig,
                      dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    if cfg.family == "ssm":
        return init_rwkv_layer(gen, cfg, dtype)
    d, dev = cfg.d_model, gen.device
    p: Dict[str, Any] = {
        "attn_norm": torch.ones((d,), dtype=torch.float32, device=dev),
        "mlp_norm": torch.ones((d,), dtype=torch.float32, device=dev),
        "q_proj": he_init(gen, (d, cfg.q_dim), d, dtype),
        "k_proj": he_init(gen, (d, cfg.kv_dim), d, dtype),
        "v_proj": he_init(gen, (d, cfg.kv_dim), d, dtype),
        "o_proj": he_init(gen, (cfg.q_dim, d), cfg.q_dim, dtype),
    }
    if cfg.is_moe:
        p["moe"] = MOE.init_moe_params(gen, d, cfg.moe, dtype)
    else:
        p["gate_proj"] = he_init(gen, (d, cfg.d_ff), d, dtype)
        p["up_proj"] = he_init(gen, (d, cfg.d_ff), d, dtype)
        p["down_proj"] = he_init(gen, (cfg.d_ff, d), cfg.d_ff, dtype)
    if cfg.family == "hybrid":
        p["mamba"] = init_mamba_params(gen, cfg, dtype)
        p["branch_norm_attn"] = torch.ones((d,), dtype=torch.float32,
                                           device=dev)
        p["branch_norm_ssm"] = torch.ones((d,), dtype=torch.float32,
                                          device=dev)
    return p


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


def _write_state(c: torch.Tensor, new: torch.Tensor,
                 mask: Optional[torch.Tensor]) -> None:
    """Write a recurrent state ([Z, b, ...]) into its cache view in place,
    only for the lanes in ``mask`` ([Z, b]; None = all)."""
    new = new.to(c.dtype)
    if mask is not None:
        new = torch.where(mask.reshape(*mask.shape, *(1,) * (c.dim() - 2)),
                          new, c)
    c.copy_(new)


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
    K/V are written into ``cache`` in place when ``write_index`` is set.
    Sharded over "model" (``shardctx.spmd()``), x holds this rank's
    sequence block and the heads are this rank's H/m and KV/m: the
    column-parallel q/k/v read the whole sequence, and the output is the
    row-parallel o_proj's partial sum. With a cache (this rank's shard:
    its slots' lanes, its KV heads) the rank writes its KV heads for the
    whole sequence of the gathered input, or, decoding, its lanes at their
    own indices under its lanes of ``write_mask``. Where the heads do not
    split (``SpmdPlan.attn_whole``), every model rank runs all of them: q/k/v
    over the whole sequence with the weights gathered over "model", the
    output cut to this rank's sequence block before o_proj
    (``SpmdPlan.whole_out``); its cache shard is then whole over "model"
    (``serve_cache_specs``) and every model rank writes the same rows."""
    Z, b = x.shape[:2]
    hd = cfg.resolved_head_dim
    sp = shardctx.spmd()
    whole = sp is not None and sp.attn_whole
    if whole:
        x = sp.columns(x)

    def lp(t):
        return lora_at(lora, t, layer)

    q = proj(x, p["q_proj"], lp("q_proj"), scale, name="q_proj",
             whole=whole)
    S = q.shape[2]
    q = q.reshape(Z, b, S, -1, hd)
    k = proj(x, p["k_proj"], lp("k_proj"), scale, name="k_proj",
             whole=whole).reshape(Z, b, S, -1, hd)
    v = proj(x, p["v_proj"], lp("v_proj"), scale, name="v_proj",
             whole=whole).reshape(Z, b, S, -1, hd)
    H = q.shape[3]
    if S > 1 and get_hint("opt_level", 0) >= 2:
        # q/k/v sequence-sharded through the token-local projections and
        # rope; attention re-constrains them to its head layout
        q = constrain(q, "dims:data,pod,model")
        k = constrain(k, "dims:data,pod,model")
        v = constrain(v, "dims:data,pod,model")
    q = constrain(apply_rope(q, angles), "attn_qkv")
    k = apply_rope(k, angles)

    if cache is not None and write_index is not None:
        ck, cv = cache["k"], cache["v"]
        per_lane = (isinstance(write_index, torch.Tensor)
                    and write_index.dim() == 2)
        if per_lane and S != 1:
            raise ValueError("per-lane cache writes are decode-only")

        def write(c, new, mask):
            if per_lane:   # each (Z, b) stream writes at its own index
                _write_lanes(c, new[:, :, 0], write_index, mask)
            else:
                _write_span(c, new, write_index, mask)

        write(ck, k, write_mask)
        write(cv, v, write_mask)
        k_all, v_all = ck, cv
        if write_mask is not None and cfg.is_moe:
            # the lanes outside the mask keep their cache, but their rows
            # still share the experts' capacity with the others: they
            # attend as if written, as in the JAX package (which writes
            # every lane into a working copy and keeps the masked ones)
            k_all, v_all = ck.clone(), cv.clone()
            write(k_all, k, None)
            write(v_all, v, None)
        kp = k_pos if k_pos is not None else torch.arange(
            ck.shape[2], dtype=torch.int32, device=x.device)
    else:
        k_all, v_all = k, v
        kp = k_pos if k_pos is not None else q_pos

    out = attention(q, k_all, v_all, q_pos, kp, window=window,
                    q_chunk=cfg_q_chunk(cfg, S), kv_valid_len=kv_valid_len)
    out = out.reshape(Z, b, S, H * hd)
    if not whole:
        return proj(out, p["o_proj"], lp("o_proj"), scale, name="o_proj")
    if sp.seq_sharded:
        out = sp.seq_block(out)
    return sp.whole_out(proj(out, p["o_proj"], lp("o_proj"), scale,
                             name="o_proj", whole=True))


def mlp_sublayer(x: torch.Tensor, p: Dict, lora: Dict, layer: int,
                 scale=2.0) -> torch.Tensor:
    def lp(t):
        return lora_at(lora, t, layer)

    h = swiglu(proj(x, p["gate_proj"], lp("gate_proj"), scale,
                    name="gate_proj"),
               proj(x, p["up_proj"], lp("up_proj"), scale, name="up_proj"))
    h = constrain(h, "ffn_hidden")
    return proj(h, p["down_proj"], lp("down_proj"), scale, name="down_proj")


def transformer_block(cfg: ModelConfig, x: torch.Tensor, p: Dict,
                      lora: Dict, layer: int, ctx: Dict[str, Any]
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One dense, MoE or hybrid layer; returns (x, the MoE load-balance
    term: None unless ``cfg.is_moe``). ``p`` holds the layer's base weights,
    ``lora`` the stacked tree (indexed at ``layer``), ``ctx`` the rope
    angles, positions, window and this layer's cache (``ctx["cache"]``).

    Hybrid (Hymba): attention and the Mamba branch both read the same
    normed ``h``; each output passes its own "residual" constraint (sharded
    over "model", a partial sum is reduce-scattered there: the norm needs
    the sum), is RMS-normed by its own branch norm, and the residual adds
    their mean. With a cache the Mamba branch continues from
    the cached ``conv`` / ``ssm`` state and writes the new one back in
    place under ``ctx["write_mask"]``; sharded, this rank's heads of it
    under its lanes of the mask."""
    scale = cfg.lora.scale_for_rank(0)
    cache = ctx.get("cache")
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    attn_out = attn_sublayer(
        h, p, lora, layer, cfg, ctx["angles"], ctx["q_pos"],
        cache=cache, k_pos=ctx.get("k_pos"),
        kv_valid_len=ctx.get("kv_valid_len"),
        write_index=ctx.get("write_index"),
        write_mask=ctx.get("write_mask"), window=ctx.get("window", 0),
        scale=scale)
    if cfg.family == "hybrid":
        ssm_out, new_mamba = mamba_block(h, p["mamba"], lora, layer, cfg,
                                         state=cache, scale=scale)
        attn_out = rms_norm(constrain(attn_out, "residual"),
                            p["branch_norm_attn"], cfg.norm_eps)
        ssm_out = rms_norm(constrain(ssm_out, "residual"),
                           p["branch_norm_ssm"], cfg.norm_eps)
        x = x + 0.5 * (attn_out + ssm_out)
        if cache is not None:
            for name, new in new_mamba.items():
                _write_state(cache[name], new, ctx.get("write_mask"))
    else:
        # the delta constrained before the add, as the reference's (its
        # row-parallel o_proj then lowers to a reduce-scatter)
        x = x + constrain(attn_out, "residual")
    x = constrain(x, "residual")
    h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    if cfg.is_moe:
        # the delta constrained before the add, as the MLP's below: sharded,
        # it is the experts' fp32 partial sum over "model" (reduce-scattered
        # here, then cast) while x holds this rank's sequence block
        moe_out, aux = MOE.moe_block(h, p["moe"], cfg.moe)
        x = x + constrain(moe_out, "residual").to(x.dtype)
        return constrain(x, "residual"), aux
    x = x + constrain(mlp_sublayer(h, p, lora, layer, scale), "residual")
    return constrain(x, "residual"), None


def rwkv_block(cfg: ModelConfig, x: torch.Tensor, p: Dict, lora: Dict,
               layer: int, ctx: Dict[str, Any]) -> Tuple[torch.Tensor, None]:
    """One RWKV-6 layer. With a cache (``ctx["cache"]``: this layer's
    ``wkv`` / ``tm_x`` / ``cm_x`` views) the recurrence continues from the
    cached state and the new state is written back in place under
    ``ctx["write_mask"]``. The token-shift states carry the normed stream,
    so decode continues exactly (RMS pre-norms, as the JAX package). Each
    mix's output is constrained before the add, as the transformer block's
    (sharded, it is a partial sum over "model" of the whole sequence while
    x holds this rank's block). Sharded, the cache views are this rank's:
    its heads of ``wkv``, and ``tm_x`` / ``cm_x`` whole (the gathered x's
    last rows, the same on every model rank)."""
    scale = cfg.lora.scale_for_rank(0)
    cache = ctx.get("cache")
    state = cache if cache is not None else {}
    xn = rms_norm(x, p["tm_norm"], cfg.norm_eps)
    tm_out, wkv, tm_last = rwkv_time_mix(
        xn, p, lora, layer, cfg, prev_x=state.get("tm_x"),
        state=state.get("wkv"), scale=scale)
    x = constrain(x + constrain(tm_out, "residual"), "residual")
    xn = rms_norm(x, p["cm_norm"], cfg.norm_eps)
    cm_out, cm_last = rwkv_channel_mix(xn, p, lora, layer, cfg,
                                       prev_x=state.get("cm_x"), scale=scale)
    x = constrain(x + constrain(cm_out, "residual"), "residual")
    if cache is not None:
        mask = ctx.get("write_mask")
        for name, new in (("wkv", wkv), ("tm_x", tm_last), ("cm_x", cm_last)):
            _write_state(cache[name], new, mask)
    return x, None


def layer_cache(cfg: ModelConfig, layers: Dict, layer: int) -> Dict:
    """Layer ``layer``'s views of the stacked cache leaves: the dense
    block's ``{"k", "v"}``, the RWKV block's ``{"wkv", "tm_x", "cm_x"}``,
    the hybrid block's ``{"k", "v", "conv", "ssm"}``."""
    if cfg.family == "ssm":
        return {k: v[layer] for k, v in layers.items()}
    views = {k: v[layer] for k, v in layers["attn"].items()}
    if cfg.family == "hybrid":
        views.update({k: v[layer] for k, v in layers["mamba"].items()})
    return views


def apply_block(cfg: ModelConfig, x: torch.Tensor, p: Dict, lora: Dict,
                layer: int, ctx: Dict[str, Any]
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(x after the layer, its MoE load-balance term: an fp32 scalar, None
    for the families without experts)."""
    if cfg.family == "ssm":
        return rwkv_block(cfg, x, p, lora, layer, ctx)
    return transformer_block(cfg, x, p, lora, layer, ctx)
