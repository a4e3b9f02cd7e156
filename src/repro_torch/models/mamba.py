"""Mamba-2 (SSD) style selective SSM branch of the Hymba hybrid block: the
port of ``src/repro/models/mamba.py``.

Per-head scalar data-dependent decay a_t = exp(-dt_t * exp(A_log)); B/C
projections shared across heads (state_size N per head); dt-scaled input;
causal depthwise conv front; silu(z) output gate; D skip. The recurrence
runs through the chunked linear-scan core (``models/linear_scan.py``,
``decay_on_query=True``): the CUDA kernel for a sequence under the
"kernel" backend, the recurrent step for one decoded token.

Decode carries (conv buffer [Z,b,W-1,inner] fp32, ssm state [Z,b,H,N,hs]
fp32). Only ``in_proj`` carries LoRA; every other weight is frozen:
``bc_proj`` and ``out_proj`` are plain projections (``proj`` without an
adapter) and ``dt_proj``, ``conv``, ``dt_bias``, ``A_log`` and ``D`` are
used as they are. Weights have the JAX package's keys, so ``bridge.py``
maps them 1:1.

Sharded over "model" (``shardctx.spmd()``: the launcher's train, eval,
prefill and serve steps), this rank runs H/m of the heads over the whole
sequence (decode: the one token): ``in_proj`` is
column-parallel in blocks (its local shard holds this rank's inner block
of x and of z, ``partitioning.BLOCKED``), ``conv`` holds the same inner
block, ``bc_proj`` and ``dt_proj`` contract over all of inner (this
rank's rows of each, the fp32 partial products summed over "model",
``SpmdPlan.row_products``), ``dt_bias``, ``A_log`` and ``D`` are sliced
to this rank's heads, and ``out_proj`` is row-parallel (the output a
partial sum over "model"). A cache's ``conv`` buffer holds this rank's
inner block and its ``ssm`` state this rank's heads
(``partitioning.serve_cache_specs``). Where the heads do not split over
"model" (``SpmdPlan.scan_whole``), every model rank runs the branch whole,
as attention whose heads do not split: x gathered along S, ``in_proj``,
``conv``, ``bc_proj``, ``dt_proj`` and ``out_proj`` gathered over "model"
(forward only), the projections (the whole LoRA A and B), the conv and the
scan over all heads and the whole sequence, ``bc`` / ``dt`` plain
products, and the output cut to this rank's sequence block before
``out_proj`` (``SpmdPlan.whole_out``); the cache's ``conv`` and ``ssm``
are whole on every model rank, and every rank writes the same.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lora import proj
from repro_torch.models import shardctx
from repro_torch.models.common import he_init, lora_at, normal_init, silu
from repro_torch.models.linear_scan import (chunked_linear_attention,
                                            linear_attention_decode_step)


def mamba_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    inner = cfg.ssm.expand * cfg.d_model
    hs = cfg.ssm.head_size
    return inner, inner // hs, hs


def mamba_target_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, int]]:
    inner, _, _ = mamba_dims(cfg)
    return {"in_proj": (cfg.d_model, 2 * inner)}


def init_mamba_params(gen: torch.Generator, cfg: ModelConfig,
                      dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    d, dev, f32 = cfg.d_model, gen.device, torch.float32
    inner, H, _ = mamba_dims(cfg)
    N, W = cfg.ssm.state_size, cfg.ssm.conv_width
    return {
        "in_proj": he_init(gen, (d, 2 * inner), d, dtype),
        "conv": normal_init(gen, (W, inner), 0.2, f32),
        "bc_proj": he_init(gen, (inner, 2 * N), inner, dtype),
        "dt_proj": he_init(gen, (inner, H), inner, f32),
        "dt_bias": torch.zeros((H,), dtype=f32, device=dev),
        "A_log": normal_init(gen, (H,), 0.5, f32),
        "D": torch.ones((H,), dtype=f32, device=dev),
        "out_proj": he_init(gen, (inner, d), inner, dtype),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(e^-|x|)
    (``torch.nn.functional.softplus`` switches to x above 20)."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 buffer: Optional[torch.Tensor]) -> torch.Tensor:
    """Depthwise causal conv. x: [Z,b,S,inner]; w: [W, inner]; buffer:
    the last W-1 rows of the stream before x, or None (zeros). The taps
    are summed in x's dtype in the JAX package's order (Python's ``sum``:
    0 + t0 + t1 + ...)."""
    W, S = w.shape[0], x.shape[2]
    pad = (torch.zeros((*x.shape[:2], W - 1, x.shape[-1]), dtype=x.dtype,
                       device=x.device)
           if buffer is None else buffer.to(x.dtype))
    xp = torch.cat([pad, x], dim=2)
    out = sum(xp[:, :, i:i + S] * w[i].to(x.dtype) for i in range(W))
    return silu(out)


def mamba_block(x: torch.Tensor, p: Dict, lora: Dict, layer: int,
                cfg: ModelConfig, *, state: Optional[Dict] = None,
                scale=2.0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [Z,b,S,d] -> (out [Z,b,S,d], new state {conv, ssm}). ``state``
    (a dict holding conv [Z,b,W-1,inner] and ssm [Z,b,H,N,hs], fp32: a
    layer's cache views) continues a cached stream; None starts from
    zeros. Sharded over "model" (the module docstring), x is this rank's
    sequence block, H its heads and out its partial sum over the whole
    sequence; with the heads whole, H is all of them and out this rank's
    block (``SpmdPlan.whole_out``)."""
    hs = cfg.ssm.head_size
    N, Wd = cfg.ssm.state_size, cfg.ssm.conv_width
    sp = shardctx.spmd()
    whole = sp is not None and sp.scan_whole
    if whole:
        x = sp.columns(x)

    xz = proj(x, p["in_proj"], lora_at(lora, "in_proj", layer), scale,
              name="in_proj", whole=whole)
    Z, b, S = xz.shape[:3]
    xt, z = xz.chunk(2, dim=-1)
    inner = xt.shape[-1]                 # this rank's block
    H = inner // hs

    conv_buf = state["conv"] if state is not None else None
    xc = _causal_conv(xt, sp.gather_model(p["conv"], "conv") if whole
                      else p["conv"], conv_buf)
    if conv_buf is None:
        stream = torch.nn.functional.pad(xt, (0, 0, Wd - 1, 0))
    else:
        stream = torch.cat([conv_buf.to(xt.dtype), xt], dim=2)
    new_conv = stream[:, :, -(Wd - 1):].float()

    dt_bias, A_log, D = p["dt_bias"], p["A_log"], p["D"]
    if sp is None or whole:
        dt_w = p["dt_proj"] if sp is None else sp.gather_model(
            sp.weight(p["dt_proj"], "dt_proj"), "dt_proj")
        bc = proj(xc, p["bc_proj"], name="bc_proj",    # [Z,b,S,2N] frozen
                  whole=whole)
        dt = xc.float() @ dt_w
    else:
        # both contract over all of inner: this rank's rows, summed over
        # "model" in fp32; bc then rounded to x's dtype, as proj's is. Each
        # is gathered over "data" as the one-rank path reads it: bc_proj
        # through its weight hint, dt_proj (no hint) directly
        bc, dt = sp.row_products(xc, {
            "bc_proj": shardctx.constrain(p["bc_proj"], "weight:bc_proj"),
            "dt_proj": sp.weight(p["dt_proj"], "dt_proj")})
        bc, dt = bc.to(xc.dtype), sp.local(dt, -1)
        dt_bias, A_log, D = (sp.local(t, -1) for t in (dt_bias, A_log, D))
    Bm, Cm = bc.float().chunk(2, dim=-1)
    dt = softplus(dt + dt_bias)                                 # [Z,b,S,H]
    logw = -dt * torch.exp(A_log)                               # < 0

    v = xc.reshape(Z, b, S, H, hs) * dt[..., None].to(xc.dtype)
    q = Cm[..., None, :].expand(Z, b, S, H, N).to(xc.dtype)
    k = Bm[..., None, :].expand(Z, b, S, H, N).to(xc.dtype)
    lw = logw[..., None].expand(Z, b, S, H, N)

    ssm_state = state["ssm"] if state is not None else None
    if S == 1 and ssm_state is not None:
        y, new_ssm = linear_attention_decode_step(
            q[:, :, 0], k[:, :, 0], v[:, :, 0], lw[:, :, 0], ssm_state,
            decay_on_query=True)
        y = y[:, :, None]
    else:
        y, new_ssm = chunked_linear_attention(
            q, k, v, lw, decay_on_query=True, initial_state=ssm_state,
            chunk=cfg.ssm.chunk_size)

    y = y + xc.reshape(Z, b, S, H, hs) * D[:, None].to(xc.dtype)
    y = y.reshape(Z, b, S, inner) * silu(z)
    if not whole:
        out = proj(y, p["out_proj"], name="out_proj")    # frozen out proj
    else:
        if sp.seq_sharded:
            y = sp.seq_block(y)
        out = sp.whole_out(proj(y, p["out_proj"], name="out_proj",
                                whole=True))
    return out, {"conv": new_conv, "ssm": new_ssm}


def init_mamba_state(cfg: ModelConfig, *lead: int,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    """Zero conv buffer [*lead, W-1, inner] and ssm state [*lead, H, N,
    hs], fp32 (lead: (Z, b) for one layer, (L, Z, b) for a cache)."""
    inner, H, hs = mamba_dims(cfg)
    return {
        "conv": torch.zeros((*lead, cfg.ssm.conv_width - 1, inner),
                            dtype=torch.float32, device=device),
        "ssm": torch.zeros((*lead, H, cfg.ssm.state_size, hs),
                           dtype=torch.float32, device=device),
    }
