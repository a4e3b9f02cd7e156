"""RWKV-6 "Finch" block pieces: the port of ``src/repro/models/rwkv.py``.

[arXiv:2404.05892] Per-layer structure:
  time-mix : token-shift lerp feeds r/k/v/g projections and a data-dependent
             per-channel decay w_t = exp(-exp(w0 + tanh(x w1) w2)); the WKV
             recurrence runs through the chunked linear-scan core
             (``models/linear_scan.py``: the CUDA kernel for a sequence, the
             recurrent step for one decoded token) with current-token bonus
             ``u``; output gated by silu(g) and per-head group norm, then
             o_proj.
  channel-mix: token-shift lerp, squared-ReLU MLP (ffn_k -> relu^2 -> ffn_v).

LoRA targets: r/k/v/g/o projections + ffn_k/ffn_v. Weights have the JAX
package's keys, so ``bridge.py`` maps them 1:1.

Sharded over "model" (``shardctx.spmd()``: the launcher's train, eval,
prefill and serve steps), x is this rank's sequence block: each mix
gathers it along S once, before the token shift (so the first token of a
block reads its true predecessor, and the five time-mix inputs share the
gather); r/k/v/g and ffn_k are column-parallel, so this rank holds H/m
heads, and it takes its heads' columns of the decay, its rows of ``u`` and
its block of ``ln_x``; o and ffn_v are row-parallel (their outputs partial
sums over "model"). With a cache, the scan (a prefill) or the recurrent
step (decode, S 1: x is whole on every rank) continues this rank's heads
of the ``wkv`` state, and the token-shift rows come back whole. Where the
heads do not split over "model" (``SpmdPlan.scan_whole``), every model rank
runs the time mix whole, as attention whose heads do not split: r/k/v/g
and o gathered over "model" (forward only), the projections (the whole
LoRA A and B) and the scan over all heads and the whole sequence, and the
gated output cut to this rank's sequence block before o_proj
(``SpmdPlan.whole_out``); the cache's ``wkv`` is whole on every model
rank. The channel mix keeps its split.
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

DECAY_LORA_DIM = 64


def rwkv_target_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, int]]:
    d = cfg.d_model
    return {
        "r_proj": (d, d), "k_proj": (d, d), "v_proj": (d, d),
        "g_proj": (d, d), "o_proj": (d, d),
        "ffn_k": (d, cfg.d_ff), "ffn_v": (cfg.d_ff, d),
    }


def init_rwkv_layer(gen: torch.Generator, cfg: ModelConfig,
                    dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    d, ff, dev = cfg.d_model, cfg.d_ff, gen.device
    H, hs = cfg.num_heads, cfg.ssm.head_size
    f32 = torch.float32

    def full(shape, value):
        return torch.full(shape, value, dtype=f32, device=dev)

    return {
        "tm_norm": full((d,), 1.0),
        "cm_norm": full((d,), 1.0),
        # token-shift mix coefficients (per channel, for r/k/v/g/w and ffn)
        "mu": full((5, d), 0.5),
        "mu_ffn": full((d,), 0.5),
        "r_proj": he_init(gen, (d, d), d, dtype),
        "k_proj": he_init(gen, (d, d), d, dtype),
        "v_proj": he_init(gen, (d, d), d, dtype),
        "g_proj": he_init(gen, (d, d), d, dtype),
        "o_proj": he_init(gen, (d, d), d, dtype),
        # data-dependent decay: w0 + tanh(x w1) w2  (low-rank, fp32)
        "w0": -1.0 + normal_init(gen, (d,), 0.3, f32),
        "w1": normal_init(gen, (d, DECAY_LORA_DIM), 0.02, f32),
        "w2": normal_init(gen, (DECAY_LORA_DIM, d), 0.02, f32),
        "u": normal_init(gen, (H, hs), 0.3, f32),       # bonus
        "ln_x": full((d,), 1.0),                        # per-head norm
        "ffn_k": he_init(gen, (d, ff), d, dtype),
        "ffn_v": he_init(gen, (ff, d), ff, dtype),
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """Shifted-by-one sequence: [Z,b,S,d] -> the previous token at each
    position; position 0 takes ``prev`` ([Z,b,d], a decode continuation)
    or zeros."""
    first = (torch.zeros_like(x[:, :, :1]) if prev is None
             else prev[:, :, None].to(x.dtype))
    return torch.cat([first, x[:, :, :-1]], dim=2)


def _shift_input(x: torch.Tensor):
    """(x, mark): sharded over "model", x gathered along S (the whole
    sequence: the shift then reads each token's true predecessor) and
    ``mark`` tagging the mixes made from it as already whole for the
    column-parallel projections; else x and the identity."""
    sp = shardctx.spmd()
    if sp is None:
        return x, lambda t: t
    return sp.columns(x), sp.gathered


def rwkv_time_mix(x: torch.Tensor, p: Dict, lora: Dict, layer: int,
                  cfg: ModelConfig, *,
                  prev_x: Optional[torch.Tensor] = None,
                  state: Optional[torch.Tensor] = None,
                  scale=2.0) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Time-mix over a sequence. x: [Z,b,S,d] (normed).

    Returns (out, final wkv state [Z,b,H,hs,hs] fp32, last x [Z,b,d]);
    sharded over "model" (the module docstring), H is this rank's heads
    and out its partial sum over the whole sequence; with the heads whole,
    H is all of them and out this rank's block (``SpmdPlan.whole_out``)."""
    sp = shardctx.spmd()
    whole = sp is not None and sp.scan_whole
    x, mark = _shift_input(x)
    Z, b, S, _ = x.shape
    hs = cfg.ssm.head_size
    xx = _token_shift(x, prev_x)
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xg, xw = (mark(x + (xx - x) * mu[i]) for i in range(5))

    def lp(t):
        return lora_at(lora, t, layer)

    r = proj(xr, p["r_proj"], lp("r_proj"), scale, name="r_proj",
             whole=whole)
    H = r.shape[-1] // hs                # this rank's heads

    def heads(t):
        return t.reshape(Z, b, S, H, hs)

    r = heads(r)
    k = heads(proj(xk, p["k_proj"], lp("k_proj"), scale, name="k_proj",
                   whole=whole))
    v = heads(proj(xv, p["v_proj"], lp("v_proj"), scale, name="v_proj",
                   whole=whole))
    g = proj(xg, p["g_proj"], lp("g_proj"), scale, name="g_proj",
             whole=whole)

    w0, w2, u, ln_x = p["w0"], p["w2"], p["u"], p["ln_x"]
    if sp is not None and not whole:     # this rank's heads' channels
        w0, w2, ln_x, u = (sp.local(w0, -1), sp.local(w2, -1),
                           sp.local(ln_x, -1), sp.local(u, 0))
    # data-dependent decay (fp32): logw = -exp(w0 + tanh(xw w1) w2) < 0
    dd = torch.tanh(xw.float() @ p["w1"]) @ w2
    logw = heads(-torch.exp(torch.clamp(w0 + dd, -8.0, 4.0)))

    if S == 1 and state is not None:
        y, new_state = linear_attention_decode_step(
            r[:, :, 0], k[:, :, 0], v[:, :, 0], logw[:, :, 0], state,
            bonus=u, decay_on_query=False)
        y = y[:, :, None]
    else:
        y, new_state = chunked_linear_attention(
            r, k, v, logw, bonus=u, decay_on_query=False,
            initial_state=state, chunk=cfg.ssm.chunk_size)

    # per-head group norm, gate, output projection
    yf = y.float()
    mean = yf.mean(dim=-1, keepdim=True)
    var = yf.var(dim=-1, keepdim=True, unbiased=False)
    yn = (yf - mean) * torch.rsqrt(var + 1e-5)
    yn = (yn.reshape(Z, b, S, H * hs) * ln_x).to(x.dtype) * silu(g)
    if not whole:
        out = proj(yn, p["o_proj"], lp("o_proj"), scale, name="o_proj")
    else:
        if sp.seq_sharded:
            yn = sp.seq_block(yn)
        out = sp.whole_out(proj(yn, p["o_proj"], lp("o_proj"), scale,
                                name="o_proj", whole=True))
    return out, new_state, x[:, :, -1]


def rwkv_channel_mix(x: torch.Tensor, p: Dict, lora: Dict, layer: int,
                     cfg: ModelConfig, *,
                     prev_x: Optional[torch.Tensor] = None,
                     scale=2.0) -> Tuple[torch.Tensor, torch.Tensor]:
    x, mark = _shift_input(x)
    xx = _token_shift(x, prev_x)
    xk = mark(x + (xx - x) * p["mu_ffn"].to(x.dtype))
    k = proj(xk, p["ffn_k"], lora_at(lora, "ffn_k", layer), scale,
             name="ffn_k")
    k = torch.square(torch.relu(k))
    return (proj(k, p["ffn_v"], lora_at(lora, "ffn_v", layer), scale,
                 name="ffn_v"), x[:, :, -1])
